"""Roofline hardware description of the port's card."""
from repro_torch.roofline.analysis import (HW_H100, Hardware,
                                           model_flops_per_step)

__all__ = ["Hardware", "HW_H100", "model_flops_per_step"]
