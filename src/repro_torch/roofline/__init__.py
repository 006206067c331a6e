"""Roofline terms of the port's card and per-step counts of one rank."""
from repro_torch.roofline.analysis import (HW_H100, Hardware, RooflineTerms,
                                           model_flops_per_step,
                                           roofline_terms)
from repro_torch.roofline.counts import StepStats, count_step

__all__ = ["Hardware", "HW_H100", "RooflineTerms", "roofline_terms",
           "model_flops_per_step", "StepStats", "count_step"]
