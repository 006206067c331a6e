"""Mamba2 (SSD) block (arXiv:2405.21060), the zamba2 hybrid's layer.

Each head's decay is one scalar a token, so the chunked "state-space
dual" form is safe without factorisation tricks: every pairwise decay is
``exp(cs_t - cs_s) <= 1`` for ``s <= t``. The chunked scan carries the
inter-chunk state ``S [B, H, P, N]``; the per-token recurrence serves
decode and lengths the chunk does not divide. Both run in f32.

As the reference: one B/C group (``ngroups=1``), no learned initial
state. The projections are plain matmuls after the layer's transient
expand, and the scan, the causal conv and the gating are plain PyTorch
(the reference keeps them outside any Pallas kernel too).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.common import (linear_init, norm_apply, norm_init,
                                       normal_init)

__all__ = ["mamba2_init", "mamba2_apply", "mamba2_decode_step",
           "ssd_recurrent", "ssd_chunked", "init_mamba_state"]


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_in, heads H, head dim P, state size N)."""
    d_in = cfg.ssm.expand * cfg.d_model
    p = cfg.ssm.head_dim
    return d_in, d_in // p, p, cfg.ssm.state_size


def mamba2_init(gen: torch.Generator, lead, cfg: ModelConfig,
                dtype: torch.dtype, device) -> Dict:
    """One Mamba2 layer's parameters, stacked ``[*lead, ...]``: in_proj to
    [z, x, B, C, dt], out_proj, the conv's taps and bias, and the
    per-head ``a_log``, ``dt_bias`` and ``d_skip`` (always f32), and the
    gate's RMSNorm over d_in."""
    d = cfg.d_model
    d_in, h, _, n = _dims(cfg)
    cw = cfg.ssm.conv_width
    f32 = dict(dtype=torch.float32, device=device)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(torch.rand((*lead, h), generator=gen, **f32) * (hi - lo)
                   + lo)
    return {
        "in_proj": linear_init(gen, lead, d, 2 * d_in + 2 * n + h, dtype,
                               device),
        "out_proj": linear_init(gen, lead, d_in, d, dtype, device,
                                scale=1.0 / math.sqrt(d_in * 2
                                                      * cfg.num_layers)),
        "conv_w": normal_init(gen, (*lead, cw, d_in + 2 * n), 0.5, dtype,
                              device),
        "conv_b": torch.zeros((*lead, d_in + 2 * n), dtype=dtype,
                              device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)).expand(
            *lead, h).clone(),
        "dt_bias": torch.log(torch.expm1(dt)),
        "d_skip": torch.ones((*lead, h), **f32),
        "norm": norm_init("rmsnorm", lead, d_in, dtype, device),
    }


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_recurrent(x: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor,
                  la: torch.Tensor, state: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact recurrence, one token at a time, in f32.

    x [B, T, H, P] (already dt-scaled), b_mat / c_mat [B, T, N], la [B, T,
    H] the log decay (<= 0), state [B, H, P, N]. Returns (y [B, T, H, P],
    the final state)."""
    x, b_mat, c_mat, la = (a.float() for a in (x, b_mat, c_mat, la))
    s = state.float()
    ys = []
    for t in range(x.shape[1]):
        s = (torch.exp(la[:, t])[..., None, None] * s
             + x[:, t, :, :, None] * b_mat[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", s, c_mat[:, t]))
    return torch.stack(ys, dim=1), s


def _chunk_step(s, xj, bj, cj, laj, tri):
    """One chunk of `ssd_chunked`: (state after it, its y [B, C, H, P])."""
    cs = torch.cumsum(laj, dim=1)                              # [B,C,H]
    # inter-chunk: y_t += exp(cs_t) * C_t . S
    y = torch.exp(cs)[..., None] * torch.einsum("bhpn,btn->bthp", s, cj)
    # intra-chunk (s <= t): att[t,s,h] = exp(cs_t - cs_s) (C_t . B_s), the
    # upper triangle masked to -inf before exp, so no exponent exceeds 0
    expo = cs[:, :, None, :] - cs[:, None, :, :]               # [B,C,C,H]
    expo = torch.where(tri[None, :, :, None], expo, -math.inf)
    cb = torch.einsum("btn,bsn->bts", cj, bj)                  # [B,C,C]
    att = torch.exp(expo) * cb[..., None]
    y = y + torch.einsum("btsh,bshp->bthp", att, xj)
    # S <- exp(cs_L) S + sum_s exp(cs_L - cs_s) x_s (x) B_s
    k_out = torch.exp(cs[:, -1:, :] - cs)                      # [B,C,H]
    s = (torch.exp(cs[:, -1])[..., None, None] * s
         + torch.einsum("bsh,bshp,bsn->bhpn", k_out, xj, bj))
    return s, y


def ssd_chunked(x: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor,
                la: torch.Tensor, state: torch.Tensor, chunk: int = 128
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan (T a multiple of ``chunk``), in f32; the same
    arguments and results as `ssd_recurrent`. Under autograd each chunk
    is recomputed in the backward pass (the reference's per-chunk remat):
    its [B, C, C, H] pairwise tensors are not kept for every chunk."""
    bb, t, h, p = x.shape
    if t % chunk:
        raise ValueError(f"T={t} not a multiple of chunk={chunk}")
    nc = t // chunk

    def to_chunks(a):
        return a.float().reshape(bb, nc, chunk, *a.shape[2:])

    xc, bc, cc, lac = (to_chunks(a) for a in (x, b_mat, c_mat, la))
    ar = torch.arange(chunk, device=x.device)
    tri = ar[:, None] >= ar[None, :]
    step = _chunk_step
    if torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint

        def step(*a):
            return checkpoint(_chunk_step, *a, use_reentrant=False)
    s = state.float()
    ys = []
    for j in range(nc):
        s, y = step(s, xc[:, j], bc[:, j], cc[:, j], lac[:, j], tri)
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(bb, t, h, p), s


# ---------------------------------------------------------------------------
# block
# ---------------------------------------------------------------------------

def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    """in_proj's output split into (z, x, B, C, dt)."""
    d_in, h, _, n = _dims(cfg)
    return torch.split(proj, [d_in, d_in, n, n, h], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 ctx: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time: x [B, T, C], w [W, C], b [C];
    ``ctx`` [B, W-1, C] the previous segment's last inputs (None: zeros).
    The W taps are summed in tap order in x's dtype. Returns (out [B, T,
    C], the last W-1 inputs as the next context)."""
    width, t = w.shape[0], x.shape[1]
    pad = (torch.zeros((x.shape[0], width - 1, x.shape[-1]), dtype=x.dtype,
                       device=x.device)
           if ctx is None else ctx.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + t] * w[i][None, None, :] for i in range(width))
    return out + b[None, None, :], xp[:, -(width - 1):]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``logaddexp(x, 0)``, the reference's softplus (torch's
    ``F.softplus`` switches to x above a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba2_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 state: Optional[torch.Tensor] = None,
                 conv_ctx: Optional[torch.Tensor] = None,
                 chunk: Optional[int] = None
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One Mamba2 layer on x [B, T, d] (dense weights), carrying the SSD
    ``state`` [B, H, P, N] (f32) and the conv's ``conv_ctx`` [B, W-1, C]
    (None: zeros). T = 1 takes the recurrence, T a multiple of the chunk
    the chunked scan, any other T the recurrence. Returns (y [B, T, d],
    (new state, new conv context))."""
    bsz, t, _ = x.shape
    d_in, h, pp, n = _dims(cfg)
    proj = x @ p["in_proj"]["w"].to(x.dtype)
    z, xs, b_mat, c_mat, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xs, b_mat, c_mat], dim=-1)
    conv_out, new_ctx = _causal_conv(conv_in, p["conv_w"].to(x.dtype),
                                     p["conv_b"].to(x.dtype), conv_ctx)
    conv_out = F.silu(conv_out)
    xs, b_mat, c_mat = torch.split(conv_out, [d_in, n, n], dim=-1)
    dt = _softplus(dt.float() + p["dt_bias"][None, None, :])   # [B,T,H]
    a = -torch.exp(p["a_log"])[None, None, :]                  # < 0
    la = dt * a                                                # <= 0
    xh = xs.reshape(bsz, t, h, pp).float() * dt[..., None]
    if state is None:
        state = torch.zeros((bsz, h, pp, n), dtype=torch.float32,
                            device=x.device)
    ck = chunk or cfg.ssm.chunk
    if t != 1 and t % ck == 0:
        y, state = ssd_chunked(xh, b_mat, c_mat, la, state, chunk=ck)
    else:
        y, state = ssd_recurrent(xh, b_mat, c_mat, la, state)
    y = y + p["d_skip"][None, None, :, None] * \
        xs.reshape(bsz, t, h, pp).float()
    y = y.reshape(bsz, t, d_in).to(x.dtype)
    y = norm_apply("rmsnorm", p["norm"], y * F.silu(z))
    return y @ p["out_proj"]["w"].to(x.dtype), (state, new_ctx)


def init_mamba_state(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.float32, device="cpu"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(zero SSD state [B, H, P, N] in f32, zero conv context [B, W-1, C]
    in ``dtype``)."""
    d_in, h, pp, n = _dims(cfg)
    cw = cfg.ssm.conv_width
    return (torch.zeros((batch, h, pp, n), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, cw - 1, d_in + 2 * n), dtype=dtype,
                        device=device))


def mamba2_decode_step(p: Dict, cfg: ModelConfig, x: torch.Tensor, state):
    """One token: x [B, 1, d]; ``state`` = (SSD state, conv context).
    Returns (y [B, 1, d], the new state pair)."""
    ssd_state, conv_ctx = state
    return mamba2_apply(p, cfg, x, state=ssd_state, conv_ctx=conv_ctx)
