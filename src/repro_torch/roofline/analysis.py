"""Roofline terms of one card: compute = flops / peak_flops, memory =
bytes / hbm_bw, collective = Σ_kind bytes_kind / collective_bw(kind).

`Hardware` and `model_flops_per_step` are the reference's
(`repro.roofline.analysis`); `HW_H100` carries NVIDIA's data-sheet figures
for one H100 SXM at its 700 W limit: 989 TFLOP/s dense bf16 on the tensor
cores, 3.35 TB/s of HBM3, and NVLink 4's 18 links of 25 GB/s each way.
These are the data sheet's figures, not measured. As in the reference,
one peak serves every dtype: the dispatcher's route costs
(`kernels.dispatch`) read ``peak_flops`` and ``hbm_bw``, and its TP
collective term reads `collective_bw`.

`roofline_terms` is the reference's three-term model, term for term, over
one rank's step counts (`roofline.counts.StepStats`, the counterpart of
the reference's per-device HLO statistics). One deliberate difference:
`RooflineTerms.roofline_fraction` divides the useful flops by the peak of
the ``hw`` the terms were computed for, where the reference's always
divides by its TPU's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["Hardware", "HW_H100", "RooflineTerms", "roofline_terms",
           "model_flops_per_step", "collective_bw"]


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


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float              # headline: the fused (io) estimate
    collective_s: float
    collective_breakdown: Dict[str, float]
    flops: float
    hbm_bytes: float             # per-op bytes (upper bracket)
    io_bytes: float              # argument + output bytes (lower bound)
    collective_bytes: float
    model_flops: float = 0.0     # analytic 6·N·D (per device share)
    int8_compute_s: float = 0.0  # if the datapath ran INT8 (paper mode)
    memory_unfused_s: float = 0.0
    peak_flops: float = HW_H100.peak_flops   # of the hw the terms are for

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_lb(self) -> float:
        """Lower bound: perfect overlap of the three engines."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time on this hardware's peak / step-time lower
        bound: the share of the compute roofline the step reaches with
        perfect overlap."""
        if self.step_time_lb == 0:
            return 0.0
        return self.model_flops / self.peak_flops / self.step_time_lb

    def as_dict(self) -> Dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "memory_unfused_s": self.memory_unfused_s,
            "collective_s": self.collective_s,
            "collective_breakdown": self.collective_breakdown,
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "io_bytes": self.io_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "step_time_lb": self.step_time_lb,
        }


def roofline_terms(stats, hw: Hardware = HW_H100,
                   model_flops_per_device: float = 0.0,
                   io_bytes_per_device: float = 0.0) -> RooflineTerms:
    """Three terms of one rank's step: ``stats`` carries ``flops``,
    ``hbm_bytes`` and ``collective_bytes`` (kind → bytes), as a
    `roofline.counts.StepStats` does. The memory term is the fused
    estimate ``io_bytes_per_device / hbm_bw`` when given (every step
    streams its arguments in and its outputs out at least once), else the
    per-op bytes, which stay beside it as the upper bracket."""
    coll_s = {k: v / _collective_bw(k, hw)
              for k, v in stats.collective_bytes.items()}
    mem_fused = io_bytes_per_device / hw.hbm_bw
    mem_unfused = stats.hbm_bytes / hw.hbm_bw
    return RooflineTerms(
        compute_s=stats.flops / hw.peak_flops,
        memory_s=mem_fused if io_bytes_per_device else mem_unfused,
        memory_unfused_s=mem_unfused,
        collective_s=sum(coll_s.values()),
        collective_breakdown=coll_s,
        flops=stats.flops,
        hbm_bytes=stats.hbm_bytes,
        io_bytes=io_bytes_per_device,
        collective_bytes=sum(stats.collective_bytes.values()),
        model_flops=model_flops_per_device,
        int8_compute_s=stats.flops / (hw.peak_flops * 2),
        peak_flops=hw.peak_flops,
    )


def model_flops_per_step(n_active_params: int, tokens_per_step: int,
                         train: bool) -> float:
    """6·N·D for training (fwd+bwd), 2·N·D for inference forward."""
    per_tok = (6 if train else 2) * n_active_params
    return float(per_tok) * tokens_per_step
