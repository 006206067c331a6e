"""Decoder LM (the dense_lm and moe_lm families): embeddings → layers →
final norm (hidden states; the LM head is applied by the serving layer).
A layer is attention then an MLP (dense_lm) or a MoE block (moe_lm, which
also yields a load-balance aux loss). `forward` is the full-sequence pass
(no cache); `prefill`, `prefill_packed`, `prefill_continue`,
`decode_step` and `verify_step` serve.

Layer weights are stacked ``[L, ...]`` (packed leaves as stacked
`DbbWeight` planes) and the layers run in a Python loop over the layer
index — the reference's scan over the stack. On the fused route the
packed planes of a dense_lm layer go to the DBB kernels as they are; on
the plain route, and for every moe_lm layer, each layer is decompressed
transiently (one layer's dense weights live at a time), as the reference
does (its ``_STREAM_FAMILIES``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.dbb import DbbWeight
from repro_torch.core.dbb_linear import maybe_decompress_tree
from repro_torch.device import resolve_device
from repro_torch.kernels.attn.ref import gather_pages
from repro_torch.kernels.dispatch import pallas_route_active
from repro_torch.models import attention as attn
from repro_torch.models.common import (dtype_of, embed_apply, embed_init,
                                       embed_scale, linear_init, norm_apply,
                                       norm_init, param_dtype_of)
from repro_torch.models.mlp import mlp_apply, mlp_down, mlp_init, mlp_up
from repro_torch.models.moe import (dense_mlp_cfg, moe_apply, moe_init,
                                    moe_routed)

__all__ = ["init_params", "lm_head_weight", "init_cache", "forward",
           "prefill", "prefill_packed", "prefill_continue", "decode_step",
           "verify_step"]

_FAMILIES = ("dense_lm", "moe_lm")
# families whose packed layer weights stream through the DBB kernels on the
# fused route (the reference's tuple; the vlm and audio families are not
# ported): a MoE layer is expanded to dense, its experts then take the
# dense kernels
_STREAM_FAMILIES = ("dense_lm", "vlm_lm", "audio_lm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r}: the port serves {_FAMILIES}")


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cuda") -> Dict:
    """Random weights at the config's widths from ``torch.Generator``
    seeded with ``seed`` on ``device`` (the reference's fan-in scales; its
    jax.random draws are not reproduced)."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = param_dtype_of(cfg)
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, d, dt, dev),
        "layers": layer_init(gen, (cfg.num_layers,), cfg, dt, dev),
        "final_norm": norm_init(cfg.norm, (), d, dt, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = linear_init(gen, (), d, cfg.vocab_size, dt, dev)
    return params


def layer_init(gen: torch.Generator, lead, cfg: ModelConfig,
               dtype: torch.dtype, device) -> Dict:
    """The layer stack's parameters ``[*lead, ...]``: attention, its two
    norms, and the MLP (dense_lm) or the MoE block (moe_lm)."""
    d = cfg.d_model
    p = {"attn": attn.attention_init(gen, lead, cfg, dtype, device),
         "ln_attn": norm_init(cfg.norm, lead, d, dtype, device),
         "ln_mlp": norm_init(cfg.norm, lead, d, dtype, device)}
    if cfg.family == "moe_lm":
        p["moe"] = moe_init(gen, lead, cfg, dtype, device)
    else:
        p["mlp"] = mlp_init(gen, lead, d, cfg.d_ff, cfg, dtype, device)
    return p


def lm_head_weight(params: Dict, cfg: ModelConfig) -> torch.Tensor:
    """The head ``[d, V]``: the embedding table's transpose when tied."""
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["lm_head"]["w"]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> Dict:
    """Contiguous KV cache ``[L, B, max_len, Hkv, D]`` in the activation
    dtype, with per-row lengths."""
    _check_family(cfg)
    dev = resolve_device(device)
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
    (the kernels stream them); otherwise — the plain route, or a moe_lm
    layer — every packed leaf is decompressed to the activation dtype for
    this layer only."""
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


def _attn_block(lp: Dict, cfg: ModelConfig, x: torch.Tensor,
                window_override: Optional[int]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A layer's attention half: (the residual after attention, its
    ``ln_mlp`` norm — the MLP's input)."""
    h = norm_apply(cfg.norm, lp["ln_attn"], x)
    x = x + attn.attention_apply(lp["attn"], cfg, h,
                                 window_override=window_override)
    return x, norm_apply(cfg.norm, lp["ln_mlp"], x)


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


def _wrap_remat(fn, cfg: ModelConfig):
    """The layer body under the config's activation checkpointing, as the
    reference's ``_wrap_remat``; a pass without gradients runs ``fn`` as
    it is, and so does the kernel route family (the kernels have no
    backward). The values are the same under every policy.

    "none" runs the layer as it is; "full" recomputes the whole layer in
    the backward pass (`torch.utils.checkpoint`, non-reentrant); "auto"
    does nothing below d_model 1024 and above it keeps the MLP's
    up-projections (`_auto_remat_layer`: the layer split around them,
    which costs no per-op dispatch); "dots" keeps every plain matmul's
    output through selective checkpointing
    (`create_selective_checkpoint_contexts`; a torch without it
    checkpoints the whole layer instead)."""
    if (cfg.remat == "none" or (cfg.remat == "auto" and cfg.d_model < 1024)
            or pallas_route_active(cfg)):     # the kernels: no backward
        return fn
    if cfg.remat not in ("full", "dots", "auto"):
        raise ValueError(f"remat={cfg.remat!r}")
    from torch.utils import checkpoint as ckpt
    if cfg.remat == "auto":
        remat = _auto_remat_layer
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
    return embed_scale(embed_apply(params["embed"], tokens, dtype_of(cfg)),
                       cfg.d_model)


def forward(params: Dict, cfg: ModelConfig,
            tokens: Optional[torch.Tensor] = None, embeds=None,
            prefix_embeds=None, window_override: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence pass without a cache: ``tokens [B, S]`` → (hidden [B,
    S, d], aux loss — the sum of the MoE layers' load-balance losses, a
    zero scalar for the dense family). Attention goes
    through `attention_apply`, so the dispatch picks flash, chunked or
    naive; ``window_override`` replaces the config's sliding window. Under
    autograd each layer runs under ``cfg.remat`` (`_wrap_remat`).
    ``embeds`` / ``prefix_embeds`` (the vlm and audio families' inputs)
    are not ported."""
    _check_family(cfg)
    if embeds is not None or prefix_embeds is not None:
        raise NotImplementedError(
            "forward(embeds=, prefix_embeds=): the vlm and audio families' "
            "inputs are not ported")
    x = _embed(params, cfg, tokens)
    body = _wrap_remat(_attn_mlp_layer, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _layers(params["layers"], cfg.num_layers):
        x, a = body(lp, cfg, x, window_override)
        if a is not None:
            aux = aux + a
    x = norm_apply(cfg.norm, params["final_norm"], x)
    return x, aux


def prefill(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Dict, start: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Full-prompt forward that fills the cache: ``tokens [B, S]`` →
    (hidden [B, S, d], cache). The K/V of every layer are written into
    ``cache`` IN PLACE (slots 0..S-1); the returned dict shares its
    tensors and carries ``length + S`` (and ``start``).

    start [B]: per-row left-pad counts of a ragged batch — RoPE positions
    shift to ``t - start`` and pad keys are masked, so a row prefills as
    it would alone."""
    _check_family(cfg)
    x = _embed(params, cfg, tokens)
    s = x.shape[1]
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
    _check_family(cfg)
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
    _check_family(cfg)
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


def decode_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One new token per row: ``tokens [B]`` → (hidden [B, 1, d], cache).
    Each layer's new K/V go into ``cache`` in place (the contiguous cache,
    or the paged pool through the block table); the returned dict shares
    its tensors with ``length + 1``. A ragged cache (``start``) masks the
    left-pad slots and shifts RoPE per row."""
    _check_family(cfg)
    x = _embed(params, cfg, tokens[:, None])
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
    _check_family(cfg)
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
