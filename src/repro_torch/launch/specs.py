"""Meta-device stand-ins and partition specs for every dry-run cell.

The reference's `repro.launch.specs`, function for function: where it
returns ``jax.ShapeDtypeStruct`` trees from ``jax.eval_shape``, these
return trees of ``meta`` tensors (shape and dtype, no storage) built by
the port's own initialisers with ``device="meta"``, and the port's
`dist.sharding.Spec` trees. No memory is allocated for a value and no
work moves to the CPU: `init_params` draws nothing on meta
(`models.common.init_generator`), and the DBB projection and
`pack_tree`, whose top-k and masks are shape-only there, give the planes'
shapes and dtypes.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import (ModelConfig, RunConfig, ShapeSpec,
                                TrainConfig)
from repro_torch.core.dbb import DbbWeight
from repro_torch.dist import sharding as shd
from repro_torch.models import registry
from repro_torch.models.common import dtype_of
from repro_torch.train.loop import TrainState, init_train_state
from repro_torch.train.tree import tree_map

__all__ = ["pad_attention_heads", "microbatches_for", "run_config_for",
           "train_input_specs", "serve_input_specs", "train_state_specs",
           "serve_param_specs", "input_specs", "sds_tree", "META"]

META = torch.device("meta")

# the two assigned giants need factored optimizer state + bf16 params to fit
_BIG_MOE = ("arctic-480b", "kimi-k2-1t-a32b")

# activation-memory budget: tokens per data-shard per microbatch (the
# reference's: a 60L×d7168 layer-boundary save set under ~2 GB a device)
MB_TOKENS_TARGET = 16_384


def pad_attention_heads(cfg: ModelConfig, tp: int) -> ModelConfig:
    """Deployment transform: pad Q heads up to a multiple of the
    model-axis size, Megatron-padded-vocab style, so they shard cleanly
    (the KV projections replicate via the ``hkv % tp != 0`` rule in
    `dist.sharding`). The extra heads are a strict superset of the
    published arch. The reference's rule, term for term."""
    if cfg.family in ("cnn", "rwkv6") or cfg.num_heads % tp == 0:
        return cfg
    mha = cfg.num_kv_heads == cfg.num_heads
    hq = -(-cfg.num_heads // tp) * tp
    while not mha and hq % cfg.num_kv_heads:
        hq += tp                    # GQA: padded heads must group evenly
    return cfg.replace(num_heads=hq,
                       num_kv_heads=hq if mha else cfg.num_kv_heads,
                       head_dim=cfg.resolved_head_dim)


def microbatches_for(shape: Optional[ShapeSpec],
                     data_shards: int = 16,
                     cfg: Optional[ModelConfig] = None,
                     tp: int = 16) -> int:
    """The reference's microbatch count: about ``MB_TOKENS_TARGET`` tokens
    a data shard (×8 for the MoE giants, whose FSDP'd experts are
    re-gathered every microbatch), raised until the named MLP saves fit
    ~3 GB a device, then rounded up to a divisor of the local batch."""
    if shape is None or shape.kind != "train":
        return 1
    if shape.global_batch % data_shards:
        return 1
    b_loc = shape.global_batch // data_shards
    target = MB_TOKENS_TARGET
    if cfg is not None and cfg.family == "moe_lm":
        target = MB_TOKENS_TARGET * 8
    m = min(b_loc, max(1, (b_loc * shape.seq_len) // target))
    if cfg is not None and cfg.parallel != "dp":
        gates = 2 if cfg.mlp_gated else 1
        f_loc = max(cfg.d_ff // max(tp, 1), 1)
        saved = (b_loc * shape.seq_len * cfg.num_layers * gates
                 * f_loc * 2)
        m = max(m, min(b_loc, -(-saved // (3 << 30))))
    while b_loc % m:            # round UP to a divisor (memory cap is hard)
        m += 1
    return min(m, b_loc)


def run_config_for(cfg: ModelConfig, shape: Optional[ShapeSpec] = None,
                   data_shards: int = 16, model_shards: int = 16,
                   **train_kw) -> RunConfig:
    """The reference's run config of a cell: Adafactor and bf16 params for
    the two MoE giants, AdamW otherwise; a training cell of a model with
    d ≤ 2048 and vocab ≤ 100k (not MoE) whose batch divides data × model
    flips the model axis to batch parallelism (``parallel="dp"``)."""
    opt = "adafactor" if cfg.name in _BIG_MOE else "adamw"
    if cfg.name in _BIG_MOE:
        cfg = cfg.replace(param_dtype="bfloat16")
    eff_shards = data_shards
    if (shape is not None and shape.kind == "train"
            and cfg.d_model <= 2048 and cfg.vocab_size <= 100_000
            and cfg.family != "moe_lm"
            and shape.global_batch % (data_shards * model_shards) == 0):
        cfg = cfg.replace(parallel="dp")
        eff_shards = data_shards * model_shards
    train_kw.setdefault("microbatches",
                        microbatches_for(shape, eff_shards, cfg=cfg,
                                         tp=model_shards))
    train = TrainConfig(optimizer=opt, **train_kw)
    return RunConfig(model=cfg, train=train)


def sds_tree(tree: Any) -> Any:
    """Every tensor of ``tree`` (packed planes too) as a meta tensor of
    its shape and dtype."""
    def meta(x):
        if isinstance(x, DbbWeight):
            return x.map(meta)
        return _meta(x.shape, x.dtype) if isinstance(x, torch.Tensor) else x
    return tree_map(meta, tree)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# batch inputs
# ---------------------------------------------------------------------------

def train_input_specs(cfg: ModelConfig, shape: ShapeSpec
                      ) -> Dict[str, torch.Tensor]:
    """{tokens|embeds, labels, loss_mask, [prefix_embeds]} for one step."""
    b, s = shape.global_batch, shape.seq_len
    dt = dtype_of(cfg)
    if cfg.family == "cnn":
        return {"images": _meta((b, cfg.cnn_img, cfg.cnn_img, cfg.cnn_in_ch),
                                torch.float32),
                "labels": _meta((b,), torch.int32)}
    out: Dict[str, torch.Tensor] = {
        "labels": _meta((b, s), torch.int32),
        "loss_mask": _meta((b, s), torch.float32),
    }
    if cfg.embeds_input:
        out["embeds"] = _meta((b, s, cfg.d_model), dt)
    elif cfg.prefix_embed_len:
        out["tokens"] = _meta((b, s - cfg.prefix_embed_len), torch.int32)
        out["prefix_embeds"] = _meta((b, cfg.prefix_embed_len, cfg.d_model),
                                     dt)
    else:
        out["tokens"] = _meta((b, s), torch.int32)
    return out


def serve_input_specs(cfg: ModelConfig, shape: ShapeSpec
                      ) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """(tokens_or_batch, cache) for decode / prefill cells: the tokens
    ``[B]`` of a decode step or a prefill's batch (no labels), and the
    global cache of `registry.init_cache`."""
    b, s = shape.global_batch, shape.seq_len
    cache = registry.init_cache(cfg, b, s, device=META)
    if shape.kind == "decode":
        return _meta((b,), torch.int32), cache
    batch = dict(train_input_specs(cfg, shape))
    batch.pop("labels", None)
    batch.pop("loss_mask", None)
    return batch, cache


# ---------------------------------------------------------------------------
# state + sharding assembly
# ---------------------------------------------------------------------------

def train_state_specs(run_cfg: RunConfig, mesh,
                      fsdp: Optional[int] = shd.FSDP_MIN_SHARD_ELEMS
                      ) -> Tuple[TrainState, TrainState]:
    """(the whole `TrainState` on meta, a `TrainState` of its specs under
    ``mesh``)."""
    state = init_train_state(run_cfg, device=META)
    pspecs = shd.param_specs(state.params, mesh, run_cfg.model,
                             fsdp_min_shard_elems=fsdp)
    ospecs = shd.opt_state_specs_like(state.opt_state, state.params,
                                      pspecs, mesh)
    efspecs = (None if state.ef is None else
               shd.opt_state_specs_like({"m": state.ef}, state.params,
                                        pspecs, mesh)["m"])
    return state, TrainState(params=pspecs, opt_state=ospecs, ef=efspecs,
                             step=shd.Spec())


def serve_params(cfg: ModelConfig, packed: bool = False,
                 int8: bool = False) -> Any:
    """Serving weights on meta: optionally DBB-packed, optionally INT8
    values with per-channel scales (the paper's deployment format), every
    other float leaf in ``cfg.dtype`` at rest. Unlike the reference, which
    packs the ``cfg.dtype`` weights, packing runs on the param-dtype tree:
    the DBB kernels take f32 (or INT8, or w4) values planes, as the serve
    CLI builds them."""
    from repro_torch.core.dbb_linear import pack_tree
    p = registry.init_params(cfg, device=META)
    if packed:
        p = pack_tree(p, cfg.dbb, quantize=int8)
    dt = dtype_of(cfg)
    return tree_map(lambda t: t.to(dt) if isinstance(t, torch.Tensor)
                    and t.is_floating_point() else t, p)


def serve_param_specs(cfg: ModelConfig, mesh, packed: bool = False,
                      int8: bool = False,
                      fsdp: Optional[int] = shd.FSDP_MIN_SHARD_ELEMS
                      ) -> Tuple[Any, Any]:
    """(params on meta, their spec tree) for serving weights (`serve_params`)."""
    params = serve_params(cfg, packed=packed, int8=int8)
    return params, shd.param_specs(params, mesh, cfg,
                                   fsdp_min_shard_elems=fsdp)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Dict:
    """The cell's step inputs on meta with their specs: training → the
    batch dict; serving → (tokens / batch, cache) with `cache_specs`."""
    if shape.kind == "train":
        batch = train_input_specs(cfg, shape)
        specs = shd.batch_specs(cfg, mesh, shape.global_batch, shape.seq_len)
        return {"batch": batch,
                "specs": {k: specs.get(k, shd.Spec()) for k in batch}}
    tok, cache = serve_input_specs(cfg, shape)
    cspecs = shd.cache_specs(cfg, mesh, shape.global_batch, shape.seq_len)
    ba = shd._batch_axes(mesh, shape.global_batch)
    if shape.kind == "decode":
        tspec: Any = shd.Spec(ba)
    else:
        full = shd.batch_specs(cfg, mesh, shape.global_batch, shape.seq_len)
        tspec = {k: full.get(k, shd.Spec()) for k in tok}
    return {"tokens": tok, "cache": cache,
            "specs": {"tokens": tspec, "cache": cspecs}}
