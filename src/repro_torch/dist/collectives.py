"""The LM-head cross-entropy on one device.

Logits are taken in f32, as in the JAX package. `cross_entropy` picks the
token-chunked form when the full ``[tokens, V]`` logits would be large.
The reference's vocab-parallel branch (the head column-sharded over a
"model" mesh axis) needs a mesh and is not taken without one; it comes
with tensor parallelism.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["dense_ce", "dense_ce_chunked", "cross_entropy"]

# live logits above this many elements (~1 GB f32) take the chunked form
CHUNK_LOGITS_ABOVE = 1 << 28


def _masked_mean(nll: torch.Tensor, mask: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    if mask is None:
        return nll.mean()
    m = mask.float()
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def _nll(h: torch.Tensor, w: torch.Tensor,
         labels: torch.Tensor) -> torch.Tensor:
    logits = h.float() @ w.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - ll


def dense_ce(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean CE with full ``[.., V]`` logits: h ``[B, S, d]`` · w
    ``[d, V]``."""
    return _masked_mean(_nll(h, w, labels), mask)


def _chunk_sums(hc: torch.Tensor, w: torch.Tensor, lc: torch.Tensor,
                mc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return (_nll(hc, w, lc) * mc).sum(), mc.sum()


def dense_ce_chunked(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     rows: int = 8192) -> torch.Tensor:
    """CE with token-chunked logits: at most ``[rows, V]`` live. Each chunk
    runs under `torch.utils.checkpoint`, so its logits are recomputed in
    the backward pass instead of kept; the gradients equal `dense_ce`'s up
    to summation order."""
    b, s, d = h.shape
    t = b * s
    hf = h.reshape(t, d)
    lf = labels.reshape(t)
    mf = (torch.ones((t,), dtype=torch.float32, device=h.device)
          if mask is None else mask.reshape(t).float())
    # pad the token axis up to a rows multiple (mask 0: no contribution)
    # rather than searching for a divisor — a prime t would otherwise
    # collapse to one chunk and materialize the full [t, V] logits, the
    # blow-up this path exists to cap
    rows_eff = min(rows, t)
    t_pad = -(-t // rows_eff) * rows_eff
    if t_pad != t:
        hf = F.pad(hf, (0, 0, 0, t_pad - t))
        lf = F.pad(lf, (0, t_pad - t))
        mf = F.pad(mf, (0, t_pad - t))
    nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    m_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(t_pad // rows_eff):
        sl = slice(i * rows_eff, (i + 1) * rows_eff)
        n, m = checkpoint(_chunk_sums, hf[sl], w, lf[sl], mf[sl],
                          use_reentrant=False)
        nll_sum, m_sum = nll_sum + n, m_sum + m
    return nll_sum / torch.clamp(m_sum, min=1.0)


def cross_entropy(hidden: torch.Tensor, w_head: torch.Tensor,
                  labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LM-head CE dispatcher: token-chunked when the full logits tensor
    would pass ``CHUNK_LOGITS_ABOVE`` elements, plain dense otherwise."""
    if labels.numel() * w_head.shape[-1] > CHUNK_LOGITS_ABOVE:
        return dense_ce_chunked(hidden, w_head, labels, mask)
    return dense_ce(hidden, w_head, labels, mask)
