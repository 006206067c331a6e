"""Roofline terms of one card: compute = flops / peak_flops, memory =
bytes / hbm_bw.

`Hardware` and `model_flops_per_step` are the reference's
(`repro.roofline.analysis`); `HW_H100` carries NVIDIA's data-sheet figures
for one H100 SXM at its 700 W limit: 989 TFLOP/s dense bf16 on the tensor
cores, 3.35 TB/s of HBM3, and NVLink 4's 18 links of 25 GB/s each way.
These are the data sheet's figures, not measured. As in the reference,
one peak serves every dtype: the dispatcher's route costs
(`kernels.dispatch`) read ``peak_flops`` and ``hbm_bw``, and its TP
collective term reads `collective_bw`.
"""
from __future__ import annotations

import dataclasses

__all__ = ["Hardware", "HW_H100", "model_flops_per_step", "collective_bw"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float            # per chip, bf16
    hbm_bw: float                # bytes/s per chip
    ici_link_bw: float           # bytes/s per link per direction
    ici_links: int               # usable links per chip


# NVLink 4 as the link fields (data sheet, not measured)
HW_H100 = Hardware(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12,
                   ici_link_bw=25e9, ici_links=18)


def _collective_bw(kind: str, hw: Hardware) -> float:
    """Bytes/s a collective of ``kind`` moves its payload at, over all of
    a card's links (the reference's model, term for term): an all-reduce
    moves its payload twice (reduce-scatter, then all-gather), so half
    the links' rate."""
    if kind == "all-reduce":
        return hw.ici_link_bw * hw.ici_links / 2
    if kind in ("all-gather", "reduce-scatter"):
        return hw.ici_link_bw * hw.ici_links
    if kind in ("all-to-all", "ragged-all-to-all"):
        return hw.ici_link_bw * hw.ici_links / 2
    return hw.ici_link_bw          # collective-permute & friends


# public alias: the dispatcher's TP collective-bytes term
collective_bw = _collective_bw


def model_flops_per_step(n_active_params: int, tokens_per_step: int,
                         train: bool) -> float:
    """6·N·D for training (fwd+bwd), 2·N·D for inference forward."""
    per_tok = (6 if train else 2) * n_active_params
    return float(per_tok) * tokens_per_step
