"""Model registry: uniform entry points keyed by config family (the port
serves the dense_lm and moe_lm families and runs the cnn family)."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import cnn as cnn_mod
from repro_torch.models import transformer as tf

__all__ = ["init_params", "init_params_by_layer", "forward", "prefill",
           "prefill_packed", "prefill_continue", "decode_step",
           "verify_step", "init_cache", "lm_head_weight"]

# (subtree, the generator that drew it) -> subtree
LayerHook = Callable[[Dict, torch.Generator], Dict]


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Dict:
    if cfg.family == "cnn":
        return cnn_mod.cnn_init(cfg, seed=seed, device=device)
    return tf.init_params(cfg, seed=seed, device=device)


def init_params_by_layer(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                         pack: bool = False,
                         layer_hook: Optional[LayerHook] = None,
                         outer: Optional[Dict] = None) -> Dict:
    """A dense_lm or moe_lm tree built one layer at a time, so a
    full-width model never holds more than about two dense layers (a MoE
    layer's dense experts among them) beside its stacked planes: layer
    ``l`` is drawn by the port's initializers from its own
    generator (seed ``seed * 1000 + l``), passed through ``layer_hook``,
    DBB-projected and packed by `pack_tree` when ``pack`` (f32 values, or
    the w4 plane where ``cfg.dbb.weight_bits == 4``), and copied into
    ``[L, ...]`` planes allocated at the first layer. So ``pack=True`` is
    ``pack_tree(apply_dbb_to_tree(...))`` of the ``pack=False`` tree of the
    same seed, layer for layer.

    ``outer`` (the embedding, the final norm and an untied head) is taken
    as given, or drawn from seed ``seed * 1000 + 999`` (the final norm
    passed through ``layer_hook`` before the head is drawn). The weights
    differ from `init_params`'s, which draws the whole stack from one
    generator."""
    from repro_torch.core.dbb import DbbWeight
    from repro_torch.core.dbb_linear import pack_tree
    from repro_torch.core.sparsity import apply_dbb_to_tree
    from repro_torch.device import resolve_device
    from repro_torch.models.common import (embed_init, linear_init,
                                           norm_init, param_dtype_of)
    tf._check_family(cfg)
    dev = resolve_device(device)
    dt, d, n_l = param_dtype_of(cfg), cfg.d_model, cfg.num_layers

    def into(dst: Any, src: Any, l: int) -> Any:
        if isinstance(src, dict):
            return {k: into(None if dst is None else dst[k], v, l)
                    for k, v in src.items()}
        if isinstance(src, DbbWeight):
            if dst is None:
                dst = src.map(lambda a: a.new_empty((n_l, *a.shape[1:])))
            for a, b in ((dst.values, src.values), (dst.bitmask, src.bitmask),
                         (dst.scale, src.scale)):
                if b is not None:
                    a[l].copy_(b[0])
            return dst
        if dst is None:
            dst = src.new_empty((n_l, *src.shape[1:]))
        dst[l].copy_(src[0])
        return dst

    stack = None
    for l in range(n_l):
        gen = torch.Generator(device=dev).manual_seed(seed * 1000 + l)
        one = tf.layer_init(gen, (1,), cfg, dt, dev)
        if layer_hook is not None:
            one = layer_hook(one, gen)
        if pack:
            one = pack_tree(apply_dbb_to_tree({"layers": one}, cfg.dbb,
                                              straight_through=False),
                            cfg.dbb)["layers"]
        stack = into(stack, one, l)
        del one
    if outer is None:
        gen = torch.Generator(device=dev).manual_seed(seed * 1000 + 999)
        outer = {"embed": embed_init(gen, cfg.vocab_size, d, dt, dev),
                 "final_norm": norm_init(cfg.norm, (), d, dt, dev)}
        if layer_hook is not None:
            outer["final_norm"] = layer_hook(outer["final_norm"], gen)
        if not cfg.tie_embeddings:
            outer["lm_head"] = linear_init(gen, (), d, cfg.vocab_size, dt,
                                           dev)
    return dict(outer, layers=stack)


def forward(params: Dict, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(output, aux loss), as the reference's `forward`: the cnn family's
    logits for ``batch["images"]`` (NHWC) through the plain lowering
    (``matmul="xla"``); the LM families' hidden states ``[B, S, d]`` for
    ``batch["tokens"]`` (`transformer.forward`; ``embeds`` and
    ``prefix_embeds`` are not ported and raise). The aux loss is the MoE
    layers' summed load-balance loss, a zero scalar for the other
    families."""
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
