"""Plain PyTorch sampling math: the plain version of the fused head-sample
kernel (csrc/head_sample_fused.cu) and the sampler of the ``head_sample_xla``
route.

* **Counter-based RNG.** A murmur3-finalizer hash of ``(seed, step, global
  vocab index, salt)`` on uint32. Noise depends on those four values only —
  never on the batch slot, chunk size or tile order — so streams reproduce
  across chunk sizes. Salts keep the token, acceptance and resample draws
  independent. torch's CPU uint32 arithmetic is incomplete, so the hash
  runs on int64 tensors holding uint32 values: every product is split into
  16-bit halves (nothing overflows) and masked to 32 bits, which gives the
  reference's uint32 results bit for bit.
* **Penalties** (TensorRT-LLM's contract): repetition divides positive /
  multiplies negative logits of seen tokens, presence subtracts a flat
  penalty from them, frequency subtracts ``count * penalty``. "Seen" means
  ``counts > 0`` in the output-token history. Defaults (1, 0, 0) are exact
  identities.
* **Gumbel-max.** ``argmax(logits / T + gumbel)`` draws from
  ``softmax(logits / T)``; at temperature 0 the score is the penalised
  logit itself, so the argmax is greedy.

Uniforms are ``((h >> 9) + 0.5) * 2^-23``: every step is exact in f32, and
the result lies strictly inside (0, 1). Hash and uniforms equal the
reference's bit for bit; ``log`` (hence the Gumbel noise) may differ from
XLA's by an ulp.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = [
    "SALT_TOKEN", "SALT_ACCEPT", "SALT_RESAMPLE", "NEG_INF",
    "hash_u32", "uniform_noise", "gumbel_noise",
    "apply_penalties", "inv_temperature", "mask_top_k", "mask_top_p",
    "sample_scores", "sample_argmax", "sample_logits", "probs_from_logits",
]

NEG_INF = -1e30

SALT_TOKEN = 0     # per-step token sampling (gumbel)
SALT_ACCEPT = 1    # speculative acceptance uniforms
SALT_RESAMPLE = 2  # residual-distribution resample (gumbel)

_M32 = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35


def _u32(a) -> torch.Tensor:
    """An integer tensor (or int) as int64 holding its uint32 bit pattern
    (an i32 -1 becomes 0xFFFFFFFF, as ``astype(uint32)`` makes it)."""
    return torch.as_tensor(a).to(torch.int64) & _M32


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2^32`` for h < 2^32, without overflowing int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def _mix(h: torch.Tensor) -> torch.Tensor:
    """Murmur3 finalizer on uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C2)
    return h ^ (h >> 16)


def hash_u32(seed, step, idx, salt: int) -> torch.Tensor:
    """Counter hash of (seed, step, idx, salt), broadcast: int64 tensor of
    uint32 values."""
    h = _mix((_u32(seed) + ((0x9E3779B9 * (salt + 1)) & _M32)) & _M32)
    h = _mix(h ^ _u32(step))
    return _mix(h ^ _u32(idx))


def uniform_noise(seed, step, idx, salt: int) -> torch.Tensor:
    """Uniform f32 strictly inside (0, 1); every op exact in f32."""
    h = hash_u32(seed, step, idx, salt)
    return ((h >> 9).to(torch.float32) + 0.5) * (2.0 ** -23)


def gumbel_noise(seed, step, idx, salt: int) -> torch.Tensor:
    u = uniform_noise(seed, step, idx, salt)
    return -torch.log(-torch.log(u))


def apply_penalties(logits: torch.Tensor, counts: torch.Tensor,
                    rep: torch.Tensor, pres: torch.Tensor,
                    freq: torch.Tensor) -> torch.Tensor:
    """Penalised logits; ``logits`` f32 and ``counts`` share ``[..., n]``,
    ``rep``/``pres``/``freq`` broadcast against them per row."""
    seen = counts > 0
    cf = counts.to(logits.dtype)
    scaled = torch.where(logits > 0, logits / rep, logits * rep)
    out = torch.where(seen, scaled, logits)
    out = out - cf * freq
    return out - torch.where(seen, pres, torch.zeros_like(pres))


def inv_temperature(temp: torch.Tensor) -> torch.Tensor:
    """1/T for T > 0, else 1 (no inf/NaN in either branch)."""
    one = torch.ones_like(temp)
    safe = torch.where(temp > 0, temp, one)
    return torch.where(temp > 0, 1.0 / safe, one)


def mask_top_k(logits: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Keep each row's top-k logits (ties with the k-th kept), the rest
    NEG_INF; ``top_k [B]`` <= 0 disables the row's filter."""
    v = logits.shape[-1]
    k = torch.where(top_k > 0, top_k, torch.full_like(top_k, v)).long()
    desc = torch.sort(logits, dim=-1, descending=True).values
    kth = torch.gather(desc, -1, (k - 1).clamp(0, v - 1)[:, None])
    masked = torch.where(logits >= kth, logits,
                         torch.full_like(logits, NEG_INF))
    return torch.where((top_k > 0)[:, None], masked, logits)


def mask_top_p(logits: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Nucleus filter: keep the smallest prefix of the descending row whose
    mass reaches top_p; ``top_p [B]`` >= 1 disables the row's filter."""
    desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p[:, None]
    kth = torch.where(keep, desc, torch.full_like(desc, float("inf"))).amin(
        dim=-1, keepdim=True)
    masked = torch.where(logits >= kth, logits,
                         torch.full_like(logits, NEG_INF))
    return torch.where((top_p < 1.0)[:, None], masked, logits)


def sample_scores(logits, counts, temp, rep, pres, freq, seed, step, idx, *,
                  salt: int = SALT_TOKEN) -> torch.Tensor:
    """Penalty → temperature → Gumbel score per logit; per-row params
    ``[B, 1]``, ``idx`` the global vocab index of each column. The argmax
    of a row's scores is its sampled token."""
    pen = apply_penalties(logits, counts, rep, pres, freq)
    g = gumbel_noise(seed, step, idx, salt)
    return torch.where(temp > 0, pen * inv_temperature(temp) + g, pen)


def sample_argmax(logits: torch.Tensor, counts: torch.Tensor, temp, rep,
                  pres, freq, seed, step, *, base: int = 0,
                  top_k: Optional[torch.Tensor] = None,
                  top_p: Optional[torch.Tensor] = None,
                  use_tt: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-row scores → (best score [B] f32, argmax [B] i32, LOCAL index).
    ``base`` offsets the noise counter to global vocab ids. ``use_tt``
    runs the top-k / top-p masks (the logits must be the whole row); ties
    go to the lowest index."""
    b, v = logits.shape
    col = base + torch.arange(v, dtype=torch.int64,
                              device=logits.device)[None, :]
    t = temp.reshape(b, 1)
    pen = apply_penalties(logits, counts, rep.reshape(b, 1),
                          pres.reshape(b, 1), freq.reshape(b, 1))
    if use_tt:
        pen = mask_top_p(mask_top_k(pen, top_k), top_p)
    g = gumbel_noise(seed.reshape(b, 1), step.reshape(b, 1), col, SALT_TOKEN)
    score = torch.where(t > 0, pen * inv_temperature(t) + g, pen)
    idx = torch.argmax(score, dim=-1)            # the first maximum
    return score.gather(1, idx[:, None])[:, 0], idx.to(torch.int32)


def sample_logits(logits, counts, temp, top_k, top_p, rep, pres, freq, seed,
                  step, *, use_tt: bool = False) -> torch.Tensor:
    """The reference sampler: [B, V] logits → [B] int32 token ids."""
    _, tok = sample_argmax(logits, counts, temp, rep, pres, freq, seed, step,
                           top_k=top_k, top_p=top_p, use_tt=use_tt)
    return tok


def probs_from_logits(logits, counts, temp, rep, pres, freq) -> torch.Tensor:
    """Post-penalty sampling distribution ``[..., V]`` for the speculative
    accept rule; rows at temperature 0 get a one-hot at the greedy argmax
    (first maximum). Per-row params broadcast against the leading dims."""
    v = logits.shape[-1]
    pen = apply_penalties(logits, counts, rep, pres, freq)
    soft = torch.softmax(pen * inv_temperature(temp), dim=-1)
    hard = torch.nn.functional.one_hot(torch.argmax(pen, dim=-1),
                                       v).to(soft.dtype)
    return torch.where(temp > 0, soft, hard)
