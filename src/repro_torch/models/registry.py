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
    """(output, aux loss), as the reference's `forward`: the cnn family's
    logits for ``batch["images"]`` (NHWC) through the plain lowering
    (``matmul="xla"``); the dense_lm family's hidden states ``[B, S, d]``
    for ``batch["tokens"]`` (`transformer.forward`; ``embeds`` and
    ``prefix_embeds`` are not ported and raise). The aux loss is a zero
    scalar."""
    if cfg.family == "cnn":
        logits = cnn_mod.cnn_apply(params, cfg, batch["images"])
        return logits, torch.zeros((), device=logits.device)
    return tf.forward(params, cfg, tokens=batch.get("tokens"),
                      embeds=batch.get("embeds"),
                      prefix_embeds=batch.get("prefix_embeds"))


prefill = tf.prefill
prefill_packed = tf.prefill_packed
prefill_continue = tf.prefill_continue
decode_step = tf.decode_step
verify_step = tf.verify_step
init_cache = tf.init_cache
lm_head_weight = tf.lm_head_weight
