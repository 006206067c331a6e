"""Model registry: uniform entry points keyed by config family (the port
serves the dense_lm family)."""
from __future__ import annotations

from repro_torch.models import transformer as tf

__all__ = ["init_params", "prefill", "prefill_packed", "prefill_continue",
           "decode_step", "init_cache", "lm_head_weight"]

init_params = tf.init_params
prefill = tf.prefill
prefill_packed = tf.prefill_packed
prefill_continue = tf.prefill_continue
decode_step = tf.decode_step
init_cache = tf.init_cache
lm_head_weight = tf.lm_head_weight
