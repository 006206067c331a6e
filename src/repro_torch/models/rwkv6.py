"""RWKV6 "Finch" (arXiv:2404.05892), the rwkv6 family's layer: an
attention-free LM with a data-dependent decay per channel.

As the reference: token shift with a data-dependent lerp (one shared
LoRA for r, k, v, w, g), the r / k / v / g projections, the decay
``w_t = exp(-exp(ww_t))`` from a LoRA head, the bonus ``u`` on the
current token, one ``[D, D]`` WKV state per head, a LayerNorm over the
WKV output, and the squared-ReLU channel mix.

WKV numerics: the chunked form keeps every exponent <= 0 (the pairwise
decays ``exp(cs_prev_t - cs_s)`` with s < t, the cumulative sum ``cs``
decreasing), at the cost of a pairwise ``[B, C, C, H, D]`` tensor a chunk;
it never factors the decays into ``r' k'^T``, which overflows on learned
decays. The per-token recurrence is the oracle, the decode step and the
path of lengths the chunk does not divide. Both run in f32.

The projections are plain matmuls after the layer's transient expand, and
the WKV, shifts and mixes are plain PyTorch: the reference keeps the whole
layer in plain XLA, outside any Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.common import (linear_init, norm_apply, norm_init,
                                       normal_init)

__all__ = ["rwkv6_layer_init", "rwkv6_layer_apply", "rwkv6_decode_step",
           "wkv_recurrent", "wkv_chunked", "init_rwkv_state"]

_LORA_R = 64
# the largest chunk of the chunked WKV: its pairwise tensor is [B, C, C, H,
# D] (67 MB a chunk at B 8, C 32, H 32, D 64 in f32)
_CHUNK_MAX = 32


def _heads(cfg: ModelConfig) -> Tuple[int, int]:
    """(heads H, head dim D) of the WKV state."""
    hd = cfg.ssm.head_dim
    return cfg.d_model // hd, hd


def rwkv6_layer_init(gen: torch.Generator, lead, cfg: ModelConfig,
                     dtype: torch.dtype, device) -> Dict:
    """One layer's parameters, stacked ``[*lead, ...]``: the time mix
    (lerp bases ``mu`` for r, k, v, w, g, the shared LoRA, the five
    projections, the decay's base ``w0`` and LoRA, the bonus ``u`` — ``w0``
    and ``u`` always f32 — and the output LayerNorm), the channel mix
    (``mu`` for k, r and its three matrices) and the two LayerNorms."""
    d, f = cfg.d_model, cfg.d_ff
    s = 1.0 / math.sqrt(d)
    on = dict(dtype=dtype, device=device)
    f32 = torch.float32
    return {
        "time_mix": {
            "mu": torch.full((*lead, 5, d), 0.5, **on),
            "lora_a": normal_init(gen, (*lead, d, _LORA_R), s, dtype, device),
            "lora_b": normal_init(gen, (*lead, _LORA_R, 5 * d), 0.01, dtype,
                                  device),
            "r_proj": linear_init(gen, lead, d, d, dtype, device),
            "k_proj": linear_init(gen, lead, d, d, dtype, device),
            "v_proj": linear_init(gen, lead, d, d, dtype, device),
            "g_proj": linear_init(gen, lead, d, d, dtype, device),
            "o_proj": linear_init(gen, lead, d, d, dtype, device,
                                  scale=s / math.sqrt(2 * cfg.num_layers)),
            "w0": normal_init(gen, (*lead, d), 1.0, f32, device) - 4.0,
            "w_lora_a": normal_init(gen, (*lead, d, _LORA_R), s, dtype,
                                    device),
            "w_lora_b": normal_init(gen, (*lead, _LORA_R, d), 0.01, dtype,
                                    device),
            "u": normal_init(gen, (*lead, d), 0.5, f32, device),
            "ln_out": norm_init("layernorm", lead, d, dtype, device),
        },
        "channel_mix": {
            "mu": torch.full((*lead, 2, d), 0.5, **on),
            "wk": linear_init(gen, lead, d, f, dtype, device),
            "wv": linear_init(gen, lead, f, d, dtype, device,
                              scale=1.0 / math.sqrt(f * 2 * cfg.num_layers)),
            "wr": linear_init(gen, lead, d, d, dtype, device),
        },
        "ln1": norm_init("layernorm", lead, d, dtype, device),
        "ln2": norm_init("layernorm", lead, d, dtype, device),
    }


def _token_shift(x: torch.Tensor,
                 last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``shift(x)[t] = x[t-1]``; position 0 takes ``last`` [B, d] (or
    zeros)."""
    first = (torch.zeros_like(x[:, :1]) if last is None
             else last[:, None, :].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


# ---------------------------------------------------------------------------
# WKV core
# ---------------------------------------------------------------------------

def wkv_recurrent(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact recurrence, one token at a time, in f32.

    r, k, v, logw [B, T, H, D] (logw the log decay, <= 0), u [H, D], state
    [B, H, D, D] (key x value). Returns (out [B, T, H, D], the final
    state)."""
    r, k, v, logw = (a.float() for a in (r, k, v, logw))
    s = state.float()
    outs: List[torch.Tensor] = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # [B, H, Dk, Dv]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 s + u[None, :, :, None] * kv))
        s = torch.exp(logw[:, t])[..., None] * s + kv
    return torch.stack(outs, dim=1), s


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked WKV, every exponent <= 0 (see the module docstring):
    the inter-chunk term through the carried state, the intra-chunk
    strictly causal pairs through the pairwise decays, the bonus on the
    diagonal, then the state carried past the chunk. T must be a multiple
    of ``chunk``."""
    b, t, h, d = r.shape
    if t % chunk:
        raise ValueError(f"T={t} is not a multiple of chunk={chunk}")
    n = t // chunk
    rc, kc, vc, lwc = (a.float().reshape(b, n, chunk, h, d)
                       for a in (r, k, v, logw))
    s = state.float()
    ar = torch.arange(chunk, device=r.device)
    tri = (ar[:, None] > ar[None, :])[None, :, :, None, None]  # (t, s)
    eye = torch.eye(chunk, device=r.device)[None, :, None, :]
    ys = []
    for j in range(n):
        rj, kj, vj, lwj = rc[:, j], kc[:, j], vc[:, j], lwc[:, j]
        cs = torch.cumsum(lwj, dim=1)              # inclusive
        cs_prev = cs - lwj                         # exclusive: sum over u < t
        # inter-chunk: y_t += (r_t * exp(cs_prev_t)) @ S
        y = torch.einsum("bchk,bhkv->bchv", rj * torch.exp(cs_prev), s)
        # intra-chunk, s < t: (r_t * exp(cs_prev_t - cs_s) * k_s) . v_s
        expo = cs_prev[:, :, None] - cs[:, None, :]      # [B, C, C, H, D]
        expo = torch.where(tri, expo, torch.full_like(expo, -math.inf))
        att = (rj[:, :, None] * torch.exp(expo)
               * kj[:, None]).sum(-1).transpose(2, 3)    # [B, C(t), H, C(s)]
        # the bonus on the diagonal (s == t): r_t * u * k_t
        diag = (rj * u[None, None] * kj).sum(-1)          # [B, C, H]
        att = att + diag[..., None] * eye
        y = y + torch.einsum("bths,bshd->bthd", att, vj)
        # S <- diag(exp(cs_C)) S + sum_s (exp(cs_C - cs_s) k_s)^T v_s
        k_out = kj * torch.exp(cs[:, -1:] - cs)
        s = (torch.exp(cs[:, -1])[..., None] * s
             + torch.einsum("bchk,bchv->bhkv", k_out, vj))
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(b, t, h, d), s


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _ddlerp(tm: Dict, x: torch.Tensor,
            sx: torch.Tensor) -> List[torch.Tensor]:
    """The data-dependent lerp between x and its shift for r, k, v, w, g:
    the mix ``mu + LoRA`` clipped to [0, 1] in f32."""
    base = sx + (x - sx) * 0.5
    adj = (torch.tanh(base @ tm["lora_a"].to(x.dtype))
           @ tm["lora_b"].to(x.dtype))
    adj = adj.reshape(*x.shape[:-1], 5, x.shape[-1])
    mix = torch.clamp(tm["mu"].float() + adj.float(), 0.0, 1.0)
    xm = sx[..., None, :].float() + (x - sx)[..., None, :].float() * mix
    return [xm[..., i, :].to(x.dtype) for i in range(5)]


def _decay(tm: Dict, xw: torch.Tensor) -> torch.Tensor:
    """The log decay, <= 0: ``-exp(clip(w0 + LoRA(xw), -8, 4))`` in f32."""
    ww = tm["w0"].float() + (
        torch.tanh(xw @ tm["w_lora_a"].to(xw.dtype))
        @ tm["w_lora_b"].to(xw.dtype)).float()
    return -torch.exp(torch.clamp(ww, -8.0, 4.0))


def _time_mix(tm: Dict, cfg: ModelConfig, x: torch.Tensor,
              sx: torch.Tensor, state: torch.Tensor, *, chunk: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The time mix on the normed ``x`` and its shift: the WKV by the
    recurrence (one token, or ``chunk`` 1) or chunked, the LayerNorm
    ``ln_out``, the SiLU gate, the output projection. Returns (output,
    the WKV state after the last token)."""
    b, t, d = x.shape
    h, hd = _heads(cfg)
    xr, xk, xv, xw, xg = _ddlerp(tm, x, sx)
    r = (xr @ tm["r_proj"]["w"].to(x.dtype)).reshape(b, t, h, hd)
    k = (xk @ tm["k_proj"]["w"].to(x.dtype)).reshape(b, t, h, hd)
    v = (xv @ tm["v_proj"]["w"].to(x.dtype)).reshape(b, t, h, hd)
    g = F.silu(xg @ tm["g_proj"]["w"].to(x.dtype))
    logw = _decay(tm, xw).reshape(b, t, h, hd)
    u = tm["u"].float().reshape(h, hd)
    if t == 1 or chunk == 1:
        out, state = wkv_recurrent(r, k, v, logw, u, state)
    else:
        out, state = wkv_chunked(r, k, v, logw, u, state, chunk=chunk)
    out = norm_apply("layernorm", tm["ln_out"],
                     out.reshape(b, t, d).to(x.dtype))
    return (out * g) @ tm["o_proj"]["w"].to(x.dtype), state


def _channel_mix(cm: Dict, x: torch.Tensor,
                 sx: torch.Tensor) -> torch.Tensor:
    """The channel mix: ``sigmoid(x_r W_r) * (relu(x_k W_k)^2 W_v)``."""
    mu = cm["mu"].float()
    xk = (sx + (x - sx) * mu[0]).to(x.dtype)
    xr = (sx + (x - sx) * mu[1]).to(x.dtype)
    kk = torch.square(F.relu(xk @ cm["wk"]["w"].to(x.dtype)))
    rr = torch.sigmoid(xr @ cm["wr"]["w"].to(x.dtype))
    return rr * (kk @ cm["wv"]["w"].to(x.dtype))


def init_rwkv_state(cfg: ModelConfig, batch: int,
                    dtype: torch.dtype = torch.float32,
                    device="cpu") -> Dict:
    """The stacked per-layer state: ``wkv [L, B, H, D, D]`` (f32) and the
    two shifts' last inputs ``shift_tm`` / ``shift_cm [L, B, d]``."""
    h, hd = _heads(cfg)
    n_l = cfg.num_layers
    return {
        "wkv": torch.zeros((n_l, batch, h, hd, hd), dtype=torch.float32,
                           device=device),
        "shift_tm": torch.zeros((n_l, batch, cfg.d_model), dtype=dtype,
                                device=device),
        "shift_cm": torch.zeros((n_l, batch, cfg.d_model), dtype=dtype,
                                device=device),
    }


def rwkv6_layer_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                      state: Optional[Dict] = None,
                      chunk: Optional[int] = None
                      ) -> Tuple[torch.Tensor, Dict]:
    """One layer over ``x [B, T, d]`` from ``state`` (None: zeros).
    Returns (y, the state after the last token: ``wkv``, ``shift_tm``,
    ``shift_cm``). The chunk is ``cfg.ssm.chunk`` capped at 32; a T it
    does not divide takes the recurrence."""
    b, t, _ = x.shape
    h, hd = _heads(cfg)
    if state is None:
        wkv = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                          device=x.device)
        last_tm = last_cm = None
    else:
        wkv = state["wkv"]
        last_tm, last_cm = state["shift_tm"], state["shift_cm"]
    ck = min(chunk or cfg.ssm.chunk, _CHUNK_MAX)
    if t % ck:
        ck = 1
    xn = norm_apply("layernorm", p["ln1"], x)
    att, wkv = _time_mix(p["time_mix"], cfg, xn, _token_shift(xn, last_tm),
                         wkv, chunk=ck)
    shift_tm = xn[:, -1]
    x = x + att
    xn = norm_apply("layernorm", p["ln2"], x)
    x = x + _channel_mix(p["channel_mix"], xn, _token_shift(xn, last_cm))
    return x, {"wkv": wkv, "shift_tm": shift_tm, "shift_cm": xn[:, -1]}


def rwkv6_decode_step(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                      state: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token: ``x [B, 1, d]`` from the layer's ``state`` (``wkv [B, H,
    D, D]``, ``shift_tm`` / ``shift_cm [B, d]``)."""
    return rwkv6_layer_apply(p, cfg, x, state=state)
