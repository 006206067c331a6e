"""Decoder LM (every LM family of the reference): embeddings → layers →
final norm (hidden states; the LM head is applied by the serving layer).
A layer is attention then an MLP (dense_lm, and vlm_lm and audio_lm,
which are the dense block with another input) or a MoE block (moe_lm,
which also yields a load-balance aux loss). rwkv6 is attention-free:
each layer a time mix and a channel mix, its cache the per-layer WKV
state and the two shifts' last inputs. zamba2 is a Mamba2 backbone with
one *shared* attention + MLP block applied after every group of
``ssm.shared_period`` layers (the last group included); its cache holds
each layer's recurrent state and, per group, a ring buffer of the shared
block's last ``shared_window`` K/V. `forward` is the full-sequence pass
(no cache); `prefill`, `decode_step` serve every family,
`prefill_packed`, `prefill_continue` and `verify_step` the families with
a slot-addressed K/V cache.

The vlm and audio families' inputs (`_embed_inputs`): ``embeds [B, S,
d]`` (audio frames) are taken in place of the token embeddings as given,
unscaled; ``prefix_embeds [B, P, d]`` (image patches) go in front of
them, unscaled. Token embeddings are scaled by sqrt(d_model) for
dense_lm, moe_lm and vlm_lm only.

Layer weights are stacked ``[L, ...]`` (packed leaves as stacked
`DbbWeight` planes) and the layers run in a Python loop over the layer
index — the reference's scan over the stack. On the fused route the
packed planes of a dense_lm layer go to the DBB kernels as they are; on
the plain route, and for every moe_lm layer, each layer is decompressed
transiently (one layer's dense weights live at a time), as the reference
does (its ``_STREAM_FAMILIES``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.dbb import DbbWeight
from repro_torch.core.dbb_linear import maybe_decompress_tree
from repro_torch.device import resolve_device
from repro_torch.dist.mesh_ctx import (current_mesh, train_layout, use_mesh,
                                       use_train_layout)
from repro_torch.kernels.attn.ref import gather_pages
from repro_torch.kernels.dispatch import pallas_route_active
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import rwkv6 as rw
from repro_torch.models.common import (dtype_of, embed_apply, embed_init,
                                       embed_scale, init_generator,
                                       linear_init, norm_apply, norm_init,
                                       param_dtype_of)
from repro_torch.models.mlp import (mlp_apply, mlp_down, mlp_init, mlp_up,
                                    seq_parallel_ok)
from repro_torch.models.moe import (dense_mlp_cfg, moe_apply, moe_init,
                                    moe_routed)

__all__ = ["init_params", "lm_head_weight", "init_cache", "forward",
           "prefill", "prefill_packed", "prefill_continue", "decode_step",
           "verify_step"]

_FAMILIES = ("dense_lm", "moe_lm", "zamba2", "rwkv6", "vlm_lm", "audio_lm")
# families with a slot-addressed K/V cache: packed prefill, chunked
# continuation and speculative verify (the reference asserts the same)
_KV_FAMILIES = ("dense_lm", "moe_lm", "vlm_lm", "audio_lm")
# families whose packed layer weights stream through the DBB kernels on the
# fused route (the reference's tuple): the dense, vlm and audio layers'
# planes go to the kernels as they are; a MoE layer is expanded to dense,
# its experts then take the dense kernels; rwkv6 and zamba2 layers are
# expanded too (plain matmuls)
_STREAM_FAMILIES = ("dense_lm", "vlm_lm", "audio_lm")


def _check_family(cfg: ModelConfig, families=_FAMILIES) -> None:
    if cfg.family in families:
        return
    if cfg.family in _FAMILIES:
        raise ValueError(f"family {cfg.family!r} has no slot-addressed K/V "
                         f"cache: this entry point serves {families}")
    raise ValueError(f"family {cfg.family!r} is not a decoder LM family: "
                     f"the LM entry points serve {_FAMILIES}")


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cuda") -> Dict:
    """Random weights at the config's widths from ``torch.Generator``
    seeded with ``seed`` on ``device`` (the reference's fan-in scales; its
    jax.random draws are not reproduced)."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = init_generator(dev, seed)
    dt = param_dtype_of(cfg)
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, d, dt, dev),
        "layers": layer_init(gen, (cfg.num_layers,), cfg, dt, dev),
        "final_norm": norm_init(cfg.norm, (), d, dt, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = linear_init(gen, (), d, cfg.vocab_size, dt, dev)
    if cfg.family == "zamba2":
        params["shared_block"] = shared_block_init(gen, cfg, dt, dev)
    return params


def layer_init(gen: torch.Generator, lead, cfg: ModelConfig,
               dtype: torch.dtype, device) -> Dict:
    """The layer stack's parameters ``[*lead, ...]``: attention, its two
    norms, and the MLP (dense_lm, vlm_lm, audio_lm) or the MoE block
    (moe_lm); a zamba2 layer is a Mamba2 block and its norm, an rwkv6
    layer its time mix, channel mix and two norms."""
    d = cfg.d_model
    if cfg.family == "rwkv6":
        return rw.rwkv6_layer_init(gen, lead, cfg, dtype, device)
    if cfg.family == "zamba2":
        return {"mamba": m2.mamba2_init(gen, lead, cfg, dtype, device),
                "ln": norm_init(cfg.norm, lead, d, dtype, device)}
    p = {"attn": attn.attention_init(gen, lead, cfg, dtype, device),
         "ln_attn": norm_init(cfg.norm, lead, d, dtype, device),
         "ln_mlp": norm_init(cfg.norm, lead, d, dtype, device)}
    if cfg.family == "moe_lm":
        p["moe"] = moe_init(gen, lead, cfg, dtype, device)
    else:
        p["mlp"] = mlp_init(gen, lead, d, cfg.d_ff, cfg, dtype, device)
    return p


def shared_block_init(gen: torch.Generator, cfg: ModelConfig,
                      dtype: torch.dtype, device) -> Dict:
    """zamba2's shared attention + MLP block (one set of weights)."""
    d = cfg.d_model
    return {"attn": attn.attention_init(gen, (), cfg, dtype, device),
            "mlp": mlp_init(gen, (), d, cfg.d_ff, cfg, dtype, device),
            "ln_attn": norm_init(cfg.norm, (), d, dtype, device),
            "ln_mlp": norm_init(cfg.norm, (), d, dtype, device)}


def lm_head_weight(params: Dict, cfg: ModelConfig) -> torch.Tensor:
    """The head ``[d, V]``: the embedding table's transpose when tied."""
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["lm_head"]["w"]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> Dict:
    """Contiguous KV cache ``[L, B, max_len, Hkv, D]`` in the activation
    dtype, with per-row lengths. rwkv6's recurrent state instead (any
    ``max_len``): ``wkv [L, B, H, D, D]`` (f32) and the two shifts' last
    inputs ``shift_tm`` / ``shift_cm [L, B, d]``. zamba2's hybrid cache:
    the SSD states ``ssd [L, B, H, P, N]`` (f32), the conv contexts
    ``conv [L, B, W-1, C]`` and, per shared-block call, ring buffers
    ``shared_k`` / ``shared_v [G, B, win, Hkv, D]`` with ``win =
    min(max_len, shared_window or max_len)``."""
    _check_family(cfg)
    dev = resolve_device(device)
    if cfg.family == "rwkv6":
        return dict(rw.init_rwkv_state(cfg, batch, dtype_of(cfg), dev),
                    length=torch.zeros((batch,), dtype=torch.int32,
                                       device=dev))
    if cfg.family == "zamba2":
        d_in, h, p, n = m2._dims(cfg)
        win = min(max_len, cfg.ssm.shared_window or max_len)
        kv = (_n_groups(cfg), batch, win, cfg.num_kv_heads,
              cfg.resolved_head_dim)
        act = dict(dtype=dtype_of(cfg), device=dev)
        return {"ssd": torch.zeros((cfg.num_layers, batch, h, p, n),
                                   dtype=torch.float32, device=dev),
                "conv": torch.zeros((cfg.num_layers, batch,
                                     cfg.ssm.conv_width - 1, d_in + 2 * n),
                                    **act),
                "shared_k": torch.zeros(kv, **act),
                "shared_v": torch.zeros(kv, **act),
                "length": torch.zeros((batch,), dtype=torch.int32,
                                      device=dev)}
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
            "v": torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
            "length": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def _layer(tree: Any, l: int) -> Any:
    """Layer ``l`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    if isinstance(tree, DbbWeight):
        return tree.map(lambda a: a[l])
    return tree[l]


def _layers(tree: Any, n: int) -> list:
    """The ``n`` per-layer trees of a stacked tree, each dense leaf split
    by one ``unbind``: under autograd its backward stacks the layers'
    gradients once, where indexing layer by layer would scatter each
    layer's gradient into a zeroed ``[L, ...]`` tensor (L² traffic)."""
    if isinstance(tree, dict):
        subs = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: subs[k][l] for k in tree} for l in range(n)]
    if isinstance(tree, DbbWeight):
        return [tree.map(lambda a, l=l: a[l]) for l in range(n)]
    return list(torch.unbind(tree, 0))


def _unpack_layer(lp: Any, cfg: ModelConfig) -> Any:
    """On the fused route a streaming family's packed leaves stay packed
    (the kernels stream them); otherwise — the plain route, a moe_lm
    layer or a zamba2 Mamba layer — every packed leaf is decompressed to
    the activation dtype for this layer only."""
    if cfg.family in _STREAM_FAMILIES and pallas_route_active(cfg):
        return lp
    return maybe_decompress_tree(lp, dtype=dtype_of(cfg))


def _ffn(lp: Dict, cfg: ModelConfig, h: torch.Tensor
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A layer's second half on its ``ln_mlp`` input: (the MLP's or the MoE
    block's output, the MoE aux loss or None)."""
    if cfg.family == "moe_lm":
        return moe_apply(lp["moe"], cfg, h)
    return mlp_apply(lp["mlp"], cfg, h), None


def _norm(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """`norm_apply` on the residual stream. On a sequence-parallel stream
    each rank normalises its own positions, so its gradient for the
    (whole) norm weights is a share: they enter through `copy_to`, which
    sums the shares over the model axis."""
    lay = train_layout()
    if lay is not None and lay.sp and p:
        from repro_torch.dist.collectives import copy_to
        p = {k: copy_to(v, "model") for k, v in p.items()}
    return norm_apply(cfg.norm, p, x)


def _attn_block(lp: Dict, cfg: ModelConfig, x: torch.Tensor,
                window_override: Optional[int]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A layer's attention half: (the residual after attention, its
    ``ln_mlp`` norm — the MLP's input)."""
    h = _norm(cfg, lp["ln_attn"], x)
    x = x + attn.attention_apply(lp["attn"], cfg, h,
                                 window_override=window_override)
    return x, _norm(cfg, lp["ln_mlp"], x)


def _attn_mlp_layer(lp: Dict, cfg: ModelConfig, x: torch.Tensor,
                    window_override: Optional[int]
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer of the full-sequence pass (no cache): (x, aux or None)."""
    lp = _unpack_layer(lp, cfg)
    x, h = _attn_block(lp, cfg, x, window_override)
    y, aux = _ffn(lp, cfg, h)
    return x + y, aux


def _moe_down(p: Dict, cfg: ModelConfig, h: torch.Tensor,
              hi: Optional[torch.Tensor], hg: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A MoE block past its dense MLP's up-projections: the routed experts
    on ``h`` plus the dense MLP's rest on ``(hi, hg)`` (None: no dense
    MLP)."""
    y, aux = moe_routed(p, cfg, h)
    if hi is not None:
        y = y + mlp_down(p["dense_mlp"], dense_mlp_cfg(cfg), hi, hg)
    return y, aux


def _auto_remat_layer(lp: Dict, cfg: ModelConfig, x: torch.Tensor,
                      window_override: Optional[int]
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`_attn_mlp_layer` (plain route) under the "auto" policy: the MLP's
    up-projections (``mlp_wi`` / ``mlp_wg``; in a MoE block, its dense
    MLP's — the reference names no expert product) run outside the
    checkpointed regions, so their outputs (and their input, which their
    backward needs) are kept; the attention half, the MLP's down half and
    a MoE block's router and experts are recomputed in the backward
    pass."""
    from torch.utils.checkpoint import checkpoint
    lp = _unpack_layer(lp, cfg)
    x, h = checkpoint(_attn_block, lp, cfg, x, window_override,
                      use_reentrant=False)
    if cfg.family == "moe_lm":
        p = lp["moe"]
        hi = hg = None
        if "dense_mlp" in p:
            hi, hg = mlp_up(p["dense_mlp"], dense_mlp_cfg(cfg), h)
        y, aux = checkpoint(_moe_down, p, cfg, h, hi, hg,
                            use_reentrant=False)
        return x + y, aux
    hi, hg = mlp_up(lp["mlp"], cfg, h)
    return x + checkpoint(mlp_down, lp["mlp"], cfg, hi, hg,
                          use_reentrant=False), None


def _dots_policy():
    """A selective-checkpoint policy keeping every ``aten.mm`` output (the
    reference's ``dots_with_no_batch_dims_saveable``: plain 2-D matmuls,
    not the attention's batched products)."""
    from torch.utils.checkpoint import CheckpointPolicy
    mm = torch.ops.aten.mm.default

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op is mm
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def _wrap_remat(fn, cfg: ModelConfig, auto=_auto_remat_layer):
    """The layer body under the config's activation checkpointing, as the
    reference's ``_wrap_remat``; a pass without gradients runs ``fn`` as
    it is, and so does the kernel route family (the kernels have no
    backward). The values are the same under every policy.

    "none" runs the layer as it is; "full" recomputes the whole layer in
    the backward pass (`torch.utils.checkpoint`, non-reentrant); "auto"
    does nothing below d_model 1024 and above it runs ``auto``: for an
    attention layer `_auto_remat_layer`, which keeps the MLP's
    up-projections (the layer split around them, which costs no per-op
    dispatch); None (a Mamba or rwkv6 layer, which has no ``mlp_wi`` /
    ``mlp_wg`` to keep) checkpoints the whole layer; "dots" keeps every plain
    matmul's output through selective checkpointing
    (`create_selective_checkpoint_contexts`; a torch without it
    checkpoints the whole layer instead)."""
    if (cfg.remat == "none" or (cfg.remat == "auto" and cfg.d_model < 1024)
            or pallas_route_active(cfg)):     # the kernels: no backward
        return fn
    if cfg.remat not in ("full", "dots", "auto"):
        raise ValueError(f"remat={cfg.remat!r}")
    lay = train_layout()
    if lay is not None:
        # a recompute runs on the autograd engine's thread, where the mesh
        # context is not set: the body re-enters it. "auto" checkpoints the
        # whole layer here (its split around the MLP's up-projections
        # would bypass the MLP's tensor-parallel block; the values are the
        # same under every policy)
        mesh, inner, auto = current_mesh(), fn, None

        def fn(*args):
            with use_mesh(mesh), use_train_layout(lay):
                return inner(*args)
    from torch.utils import checkpoint as ckpt
    if cfg.remat == "auto" and auto is not None:
        remat = auto
    elif cfg.remat == "dots" and hasattr(
            ckpt, "create_selective_checkpoint_contexts"):
        policy = _dots_policy()

        def remat(*args):
            return ckpt.checkpoint(
                fn, *args, use_reentrant=False,
                context_fn=lambda: ckpt.create_selective_checkpoint_contexts(
                    policy))
    else:
        def remat(*args):
            return ckpt.checkpoint(fn, *args, use_reentrant=False)

    def wrapped(*args):
        return remat(*args) if torch.is_grad_enabled() else fn(*args)
    return wrapped


def _embed(params: Dict, cfg: ModelConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings, times sqrt(d_model) for the attention
    families (the reference scales dense_lm, moe_lm and vlm_lm, not
    zamba2)."""
    x = embed_apply(params["embed"], tokens, dtype_of(cfg))
    if cfg.family in ("dense_lm", "moe_lm", "vlm_lm"):
        x = embed_scale(x, cfg.d_model)
    return x


def _embed_inputs(params: Dict, cfg: ModelConfig,
                  tokens: Optional[torch.Tensor] = None,
                  embeds: Optional[torch.Tensor] = None,
                  prefix_embeds: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """The layers' input, as the reference's ``_embed_inputs``: ``embeds``
    as given (cast to the activation dtype, unscaled) or the token
    embeddings (`_embed`), with ``prefix_embeds`` (unscaled) in front."""
    dt = dtype_of(cfg)
    x = embeds.to(dt) if embeds is not None else _embed(params, cfg, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(dt), x], dim=1)
    return x


# ---------------------------------------------------------------------------
# rwkv6: time mix + channel mix layers over a recurrent state
# ---------------------------------------------------------------------------

def _rwkv_layer(lp: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """One rwkv6 layer of the full-sequence pass (expanded to dense), from
    a zero state."""
    return rw.rwkv6_layer_apply(_unpack_layer(lp, cfg), cfg, x)[0]


def _rwkv6_pass(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                cache: Dict, carry: bool) -> torch.Tensor:
    """Every rwkv6 layer over ``x``, each writing its final state into
    ``cache`` in place; ``carry`` starts each layer from the cache's state
    (decode), else from zeros (prefill: the reference's prefill starts
    fresh whatever the cache holds)."""
    for l in range(cfg.num_layers):
        lp = _unpack_layer(_layer(params["layers"], l), cfg)
        st = ({k: cache[k][l] for k in ("wkv", "shift_tm", "shift_cm")}
              if carry else None)
        x, st = rw.rwkv6_layer_apply(lp, cfg, x, state=st)
        for k, v in st.items():
            cache[k][l] = v.to(cache[k].dtype)
    return norm_apply(cfg.norm, params["final_norm"], x)


# ---------------------------------------------------------------------------
# zamba2: Mamba2 layers and the shared attention + MLP block
# ---------------------------------------------------------------------------

def _n_groups(cfg: ModelConfig) -> int:
    """Shared-block calls a pass: one after every group of
    ``shared_period`` Mamba layers, the last (shorter) group included."""
    return -(-cfg.num_layers // cfg.ssm.shared_period)


def _shared_after(l: int, cfg: ModelConfig) -> bool:
    """Whether the shared block runs after Mamba layer ``l``."""
    return (l + 1) % cfg.ssm.shared_period == 0 or l == cfg.num_layers - 1


def _shared_cfg(cfg: ModelConfig) -> ModelConfig:
    """The shared block runs as an attention + MLP layer (the reference's
    ``cfg.replace(family="dense_lm")``): on the kernel route its packed
    leaves stream through the DBB kernels."""
    return cfg.replace(family="dense_lm")


def _mamba_layer(lp: Dict, cfg: ModelConfig,
                 x: torch.Tensor) -> torch.Tensor:
    """One Mamba layer of the full-sequence pass (expanded to dense)."""
    lp = _unpack_layer(lp, cfg)
    y, _ = m2.mamba2_apply(lp["mamba"], cfg,
                           norm_apply(cfg.norm, lp["ln"], x))
    return x + y


def _zamba2_forward(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                    window_override: Optional[int]) -> torch.Tensor:
    """The Mamba layers with the shared block after every group, each
    under ``cfg.remat`` (the Mamba body whole under "auto"; the shared
    block by the attention layer's rule)."""
    scfg = _shared_cfg(cfg)
    body = _wrap_remat(_mamba_layer, cfg, auto=None)
    shared = _wrap_remat(_attn_mlp_layer, scfg)
    for l, lp in enumerate(_layers(params["layers"], cfg.num_layers)):
        x = body(lp, cfg, x)
        if _shared_after(l, cfg):
            x, _ = shared(params["shared_block"], scfg, x, window_override)
    return x


def _shared_ffn(sb: Dict, scfg: ModelConfig, x: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
    """The shared block past its attention (output ``y``): residual, norm,
    MLP, residual."""
    x = x + y
    h = norm_apply(scfg.norm, sb["ln_mlp"], x)
    return x + mlp_apply(sb["mlp"], scfg, h)


def _zamba2_prefill(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                    cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """The full-context pass that fills the hybrid cache in place: each
    layer's final SSD state and conv context, and per shared-block call
    the K/V of the last ``win`` positions at their ring slots ``t %
    win``. The shared attention runs with ``window_override=win``. Its
    q/k/v are projected once, for the cache and the attention (the
    reference projects them twice; the values are the same)."""
    b, s, _ = x.shape
    scfg = _shared_cfg(cfg)
    sb = _unpack_layer(params["shared_block"], scfg)
    win = cache["shared_k"].shape[2]
    tail = min(win, s)
    positions = torch.arange(s, device=x.device)[None, :]
    slots = positions[0, s - tail:] % win
    gi = 0
    for l in range(cfg.num_layers):
        lp = _unpack_layer(_layer(params["layers"], l), cfg)
        y, (ssd, conv) = m2.mamba2_apply(lp["mamba"], cfg,
                                         norm_apply(cfg.norm, lp["ln"], x))
        cache["ssd"][l] = ssd
        cache["conv"][l] = conv
        x = x + y
        if _shared_after(l, cfg):
            h = norm_apply(scfg.norm, sb["ln_attn"], x)
            q, k, v = attn._project_qkv(sb["attn"], scfg, h, positions)
            cache["shared_k"][gi][:, slots] = k[:, s - tail:].to(
                cache["shared_k"].dtype)
            cache["shared_v"][gi][:, slots] = v[:, s - tail:].to(
                cache["shared_v"].dtype)
            x = _shared_ffn(sb, scfg, x, attn.attention_apply(
                sb["attn"], scfg, h, positions=positions,
                window_override=win, qkv=(q, k, v)))
            gi += 1
    x = norm_apply(cfg.norm, params["final_norm"], x)
    return x, dict(cache, length=cache["length"] + s)


def _zamba2_decode(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                   cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token through the Mamba layers' recurrence (state and conv
    context updated in place) and the shared block's ring-buffer decode
    attention."""
    scfg = _shared_cfg(cfg)
    sb = _unpack_layer(params["shared_block"], scfg)
    gi = 0
    for l in range(cfg.num_layers):
        lp = _unpack_layer(_layer(params["layers"], l), cfg)
        y, (ssd, conv) = m2.mamba2_apply(
            lp["mamba"], cfg, norm_apply(cfg.norm, lp["ln"], x),
            state=cache["ssd"][l], conv_ctx=cache["conv"][l])
        cache["ssd"][l] = ssd
        cache["conv"][l] = conv
        x = x + y
        if _shared_after(l, cfg):
            h = norm_apply(scfg.norm, sb["ln_attn"], x)
            x = _shared_ffn(sb, scfg, x, attn.decode_attention_apply(
                sb["attn"], scfg, h, cache["shared_k"][gi],
                cache["shared_v"][gi], cache["length"], ring=True))
            gi += 1
    x = norm_apply(cfg.norm, params["final_norm"], x)
    return x, dict(cache, length=cache["length"] + 1)


def forward(params: Dict, cfg: ModelConfig,
            tokens: Optional[torch.Tensor] = None, embeds=None,
            prefix_embeds=None, window_override: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence pass without a cache: ``tokens [B, S]`` (or frame
    ``embeds [B, S, d]``; ``prefix_embeds [B, P, d]`` in front, see
    `_embed_inputs`) → (hidden [B, P + S, d], aux loss — the sum of the
    MoE layers' load-balance losses, a zero scalar for the other
    families). Attention goes through `attention_apply`, so the dispatch
    picks flash, chunked or naive; ``window_override`` replaces the
    config's sliding window. Under autograd each layer runs under
    ``cfg.remat`` (`_wrap_remat`; an rwkv6 layer, like a Mamba layer, is
    checkpointed whole under "auto")."""
    _check_family(cfg)
    x = _embed_inputs(params, cfg, tokens, embeds, prefix_embeds)
    lay = train_layout()
    if lay is not None and lay.tp > 1:
        # a training step on a mesh: the residual stream stays split along
        # the sequence over the model axis where the stack allows it (the
        # blocks gather and reduce-scatter at their edges), else whole
        sp = seq_parallel_ok(cfg, x.shape[1], lay.tp)
        with use_train_layout(dataclasses.replace(lay, sp=sp)):
            if sp:
                from repro_torch.dist.collectives import scatter
                x = scatter(x, "model", 1)
            return _forward_layers(params, cfg, x, window_override)
    return _forward_layers(params, cfg, x, window_override)


def _forward_layers(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                    window_override: Optional[int]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`forward` past the embeddings: the layers and the final norm."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "rwkv6":
        body = _wrap_remat(_rwkv_layer, cfg, auto=None)
        for lp in _layers(params["layers"], cfg.num_layers):
            x = body(lp, cfg, x)
        return norm_apply(cfg.norm, params["final_norm"], x), aux
    if cfg.family == "zamba2":
        x = _zamba2_forward(params, cfg, x, window_override)
        return norm_apply(cfg.norm, params["final_norm"], x), aux
    body = _wrap_remat(_attn_mlp_layer, cfg)
    for lp in _layers(params["layers"], cfg.num_layers):
        x, a = body(lp, cfg, x, window_override)
        if a is not None:
            aux = aux + a
    return _norm(cfg, params["final_norm"], x), aux


def prefill(params: Dict, cfg: ModelConfig,
            tokens: Optional[torch.Tensor] = None,
            cache: Optional[Dict] = None,
            start: Optional[torch.Tensor] = None, *,
            embeds: Optional[torch.Tensor] = None,
            prefix_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Full-prompt forward that fills the cache: ``tokens [B, S]`` (or
    ``embeds``, with ``prefix_embeds`` in front: `_embed_inputs`) →
    (hidden [B, S, d], cache; S counts the prefix). The K/V of every layer
    are written into ``cache`` IN PLACE (slots 0..S-1); the returned dict
    shares its tensors and carries ``length + S`` (and ``start``). A
    ``cache`` of None is made at S slots, as the reference makes it.

    start [B]: per-row left-pad counts of a ragged batch — RoPE positions
    shift to ``t - start`` and pad keys are masked, so a row prefills as
    it would alone. rwkv6 and zamba2 fill their recurrent caches and
    ignore ``start``: the state takes the pads as tokens, as the
    reference's does; rwkv6 starts every layer from a zero state."""
    _check_family(cfg)
    x = _embed_inputs(params, cfg, tokens, embeds, prefix_embeds)
    s = x.shape[1]
    if cache is None:
        cache = init_cache(cfg, x.shape[0], s, device=x.device)
    if cfg.family == "rwkv6":
        x = _rwkv6_pass(params, cfg, x, cache, carry=False)
        return x, dict(cache, length=cache["length"] + s)
    if cfg.family == "zamba2":
        return _zamba2_prefill(params, cfg, x, cache)
    positions = torch.arange(s, device=x.device)[None, :]
    if start is not None:
        positions = positions - start[:, None]
    for l in range(cfg.num_layers):
        lp = _unpack_layer(_layer(params["layers"], l), cfg)
        h = norm_apply(cfg.norm, lp["ln_attn"], x)
        q, k, v = attn._project_qkv(lp["attn"], cfg, h, positions)
        cache["k"][l, :, :s] = k
        cache["v"][l, :, :s] = v
        x = x + attn.attention_apply(lp["attn"], cfg, h, positions=positions,
                                     ragged=start is not None, qkv=(q, k, v))
        h = norm_apply(cfg.norm, lp["ln_mlp"], x)
        x = x + _ffn(lp, cfg, h)[0]
    x = norm_apply(cfg.norm, params["final_norm"], x)
    new_cache = dict(cache, length=cache["length"] + s)
    if start is not None:
        new_cache["start"] = start
    return x, new_cache


def _kv_keys(cache: Dict) -> Tuple[str, str]:
    return ("k_pages", "v_pages") if "k_pages" in cache else ("k", "v")


def _scatter_index(rows: torch.Tensor, cols: torch.Tensor, n_rows: int,
                   device: torch.device):
    """(kept positions, rows, cols) of a packed K/V scatter on ``device``:
    positions whose row is out of range (the padding's sentinel) are
    dropped, as the reference's ``mode="drop"`` scatter drops them. Passing
    host tensors keeps this free of a device sync."""
    keep = ((rows >= 0) & (rows < n_rows)).nonzero().squeeze(1)
    return (keep.to(device), rows[keep].long().to(device),
            cols[keep].long().to(device))


def prefill_packed(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                   seg_ids: torch.Tensor, positions: torch.Tensor,
                   rows: torch.Tensor, cols: torch.Tensor, cache: Dict
                   ) -> Tuple[torch.Tensor, Dict]:
    """Padding-free packed prefill: a ragged batch's prompts concatenated
    in ``tokens [1, Tp]``, with per-token metadata instead of a [B, T_max]
    grid —

      seg_ids   [Tp]    owning request (non-decreasing; padding carries a
                        larger id)
      positions [1, Tp] position within the owning request (RoPE)
      rows/cols [Tp]    K/V scatter address: (batch row, slot) of a
                        contiguous cache, (physical page, offset) of a
                        paged pool; padding carries an out-of-range row and
                        is dropped

    Returns (hidden [1, Tp, d], cache) with every layer's K/V written into
    ``cache`` IN PLACE. The bookkeeping leaves (length / start /
    block_table) are untouched: the engine installs them when a request's
    prefill completes, which keeps half-prefilled rows out of decode."""
    _check_family(cfg, _KV_FAMILIES)
    x = _embed(params, cfg, tokens)
    kk, vv = _kv_keys(cache)
    keep, r, c = _scatter_index(rows, cols, cache[kk].shape[1], x.device)
    for l in range(cfg.num_layers):
        lp = _unpack_layer(_layer(params["layers"], l), cfg)
        h = norm_apply(cfg.norm, lp["ln_attn"], x)
        q, k, v = attn._project_qkv(lp["attn"], cfg, h, positions)
        cache[kk][l][r, c] = k[0, keep].to(cache[kk].dtype)
        cache[vv][l][r, c] = v[0, keep].to(cache[vv].dtype)
        x = x + attn.packed_attention_apply(lp["attn"], cfg, h, seg_ids,
                                            positions, qkv=(q, k, v))
        h = norm_apply(cfg.norm, lp["ln_mlp"], x)
        x = x + _ffn(lp, cfg, h)[0]
    return norm_apply(cfg.norm, params["final_norm"], x), cache


def prefill_continue(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                     positions: torch.Tensor, rows: torch.Tensor,
                     cols: torch.Tensor, kv_sel, cache: Dict
                     ) -> Tuple[torch.Tensor, Dict]:
    """Chunked-prefill continuation of ONE request: ``tokens [1, C]`` is
    the next chunk of a prompt whose earlier chunks already sit in the
    cache, ``positions [1, C]`` its absolute slots (``offset ..
    offset+C-1``; packed rows have no left padding). rows/cols address the
    K/V scatter as in `prefill_packed`. ``kv_sel`` selects the row's cache
    for attention: the slot index (contiguous) or the [n_log] block-table
    row (paged; its pages are gathered into one contiguous row). The chunk
    attends its own keys and every earlier slot of its row — never another
    row's."""
    _check_family(cfg, _KV_FAMILIES)
    x = _embed(params, cfg, tokens)
    offset = positions[0, :1]
    kk, vv = _kv_keys(cache)
    paged = kk == "k_pages"
    keep, r, c = _scatter_index(rows, cols, cache[kk].shape[1], x.device)
    for l in range(cfg.num_layers):
        lp = _unpack_layer(_layer(params["layers"], l), cfg)
        h = norm_apply(cfg.norm, lp["ln_attn"], x)
        q, k, v = attn._project_qkv(lp["attn"], cfg, h, positions)
        ck, cv = cache[kk][l], cache[vv][l]
        ck[r, c] = k[0, keep].to(ck.dtype)
        cv[r, c] = v[0, keep].to(cv.dtype)
        if paged:
            krow = gather_pages(ck, kv_sel[None])        # [1, S, Hkv, D]
            vrow = gather_pages(cv, kv_sel[None])
        else:
            krow, vrow = ck[kv_sel:kv_sel + 1], cv[kv_sel:kv_sel + 1]
        x = x + attn.chunk_attention_apply(lp["attn"], cfg, q, krow, vrow,
                                           offset)
        h = norm_apply(cfg.norm, lp["ln_mlp"], x)
        x = x + _ffn(lp, cfg, h)[0]
    return norm_apply(cfg.norm, params["final_norm"], x), cache


def decode_step(params: Dict, cfg: ModelConfig,
                tokens: Optional[torch.Tensor], cache: Dict,
                embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """One new token per row: ``tokens [B]`` (or ``embeds [B, 1, d]``, as
    given) → (hidden [B, 1, d], cache). Each layer's new K/V go into
    ``cache`` in place (the contiguous cache, or the paged pool through
    the block table); the returned dict shares its tensors with ``length +
    1``. A ragged cache (``start``) masks the left-pad slots and shifts
    RoPE per row. rwkv6 steps each layer's state in place; zamba2 decodes
    through its hybrid cache (`_zamba2_decode`)."""
    _check_family(cfg)
    x = (embeds.to(dtype_of(cfg)) if embeds is not None
         else _embed(params, cfg, tokens[:, None]))
    if cfg.family == "rwkv6":
        x = _rwkv6_pass(params, cfg, x, cache, carry=True)
        return x, dict(cache, length=cache["length"] + 1)
    if cfg.family == "zamba2":
        return _zamba2_decode(params, cfg, x, cache)
    start = cache.get("start")
    paged = "k_pages" in cache
    for l in range(cfg.num_layers):
        lp = _unpack_layer(_layer(params["layers"], l), cfg)
        h = norm_apply(cfg.norm, lp["ln_attn"], x)
        if paged:
            y = attn.paged_decode_attention_apply(
                lp["attn"], cfg, h, cache["k_pages"][l],
                cache["v_pages"][l], cache["block_table"], cache["length"],
                start=start)
        else:
            y = attn.decode_attention_apply(
                lp["attn"], cfg, h, cache["k"][l], cache["v"][l],
                cache["length"], start=start)
        x = x + y
        h = norm_apply(cfg.norm, lp["ln_mlp"], x)
        x = x + _ffn(lp, cfg, h)[0]
    x = norm_apply(cfg.norm, params["final_norm"], x)
    return x, dict(cache, length=cache["length"] + 1)


def verify_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """Speculative verify: score T candidate tokens per row in one batched
    pass. ``tokens [B, T]`` holds the current token and the T-1 draft
    tokens; every layer's K/V are written into ``cache`` in place at slots
    ``length .. length+T-1`` (contiguous cache, or the paged pool through
    the block table), and the hidden states ``[B, T, d]`` give the full
    model's distribution at each candidate. ``cache["length"]`` is left
    as it was: the caller advances it by the accepted count."""
    _check_family(cfg, _KV_FAMILIES)
    x = _embed(params, cfg, tokens)
    start = cache.get("start")
    lengths = cache["length"]
    paged = "k_pages" in cache
    for l in range(cfg.num_layers):
        lp = _unpack_layer(_layer(params["layers"], l), cfg)
        h = norm_apply(cfg.norm, lp["ln_attn"], x)
        if paged:
            y = attn.paged_verify_attention_apply(
                lp["attn"], cfg, h, cache["k_pages"][l],
                cache["v_pages"][l], cache["block_table"], lengths,
                start=start)
        else:
            y = attn.verify_attention_apply(
                lp["attn"], cfg, h, cache["k"][l], cache["v"][l], lengths,
                start=start)
        x = x + y
        h = norm_apply(cfg.norm, lp["ln_mlp"], x)
        x = x + _ffn(lp, cfg, h)[0]
    return norm_apply(cfg.norm, params["final_norm"], x), cache
