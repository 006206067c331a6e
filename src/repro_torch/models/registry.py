"""Model registry: uniform entry points keyed by config family (the port
serves the dense_lm family and runs the cnn family)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import cnn as cnn_mod
from repro_torch.models import transformer as tf

__all__ = ["init_params", "forward", "prefill", "prefill_packed",
           "prefill_continue", "decode_step", "verify_step", "init_cache",
           "lm_head_weight"]


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Dict:
    if cfg.family == "cnn":
        return cnn_mod.cnn_init(cfg, seed=seed, device=device)
    return tf.init_params(cfg, seed=seed, device=device)


def forward(params: Dict, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits, aux loss) of the cnn family for ``batch["images"]`` (NHWC),
    through the plain lowering (``matmul="xla"``), as the reference's
    `forward`; the aux loss is a zero scalar."""
    if cfg.family != "cnn":
        raise NotImplementedError(
            f"forward of family {cfg.family!r} is not ported (the dense_lm "
            "family serves through prefill / decode_step)")
    logits = cnn_mod.cnn_apply(params, cfg, batch["images"])
    return logits, torch.zeros((), device=logits.device)


prefill = tf.prefill
prefill_packed = tf.prefill_packed
prefill_continue = tf.prefill_continue
decode_step = tf.decode_step
verify_step = tf.verify_step
init_cache = tf.init_cache
lm_head_weight = tf.lm_head_weight
