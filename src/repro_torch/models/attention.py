"""GQA/MHA attention: projections; prefill attention over a padded batch
(flash kernel, the chunked route or the naive route), a packed ragged
batch (packed flash kernel or its plain version) and a chunked-prefill
continuation; one-token decode against the contiguous KV cache (the paged
decode kernel under an identity block table, or the plain softmax route;
a ring-buffer cache always the latter) and against a paged pool; and the
speculative verify pass (T candidate tokens per row, naive attention) on
both caches."""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.dbb import DbbWeight
from repro_torch.kernels import dispatch
from repro_torch.kernels.attn import (DEFAULT_PAGE, flash_attention,
                                      gather_pages, identity_block_table,
                                      paged_decode_attention)
from repro_torch.kernels.common import FLOAT_DTYPES
from repro_torch.models.common import apply_rope, linear_init

__all__ = ["attention_init", "attention_apply", "packed_attention_apply",
           "chunk_attention_apply", "decode_attention_apply",
           "paged_decode_attention_apply", "verify_attention_apply",
           "paged_verify_attention_apply"]

_NEG_INF = -1e30


def attention_init(gen: torch.Generator, lead, cfg: ModelConfig,
                   dtype: torch.dtype, device) -> Dict:
    d, hq, hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    return {
        "q_proj": linear_init(gen, lead, d, hq * hd, dtype, device,
                              bias=cfg.qkv_bias),
        "k_proj": linear_init(gen, lead, d, hkv * hd, dtype, device,
                              bias=cfg.qkv_bias),
        "v_proj": linear_init(gen, lead, d, hkv * hd, dtype, device,
                              bias=cfg.qkv_bias),
        "o_proj": linear_init(gen, lead, hq * hd, d, dtype, device,
                              scale=1.0 / math.sqrt(hq * hd * 2
                                                    * cfg.num_layers)),
    }


def _lin(pp: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Projection against a dense or packed weight. Packed weights take
    the DBB kernels (bias fused into the epilogue); dense ones keep the
    plain matmul (``dense_fused=False``)."""
    w = pp["w"]
    packed = isinstance(w, DbbWeight)
    return dispatch.matmul(x, w, pp.get("b"),
                           out_dtype=x.dtype if packed else None, cfg=cfg,
                           pallas=packed, dense_fused=False)


def _o_proj(p: Dict, o2d: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The output projection. Inside a TP shard body ``o_proj`` arrives
    row-split over the local heads' K slice, so its product is a partial
    sum and one boundary all-reduce in the activation dtype completes the
    attention block (issued once, not in the reference's chunks: see
    `dist.collectives`); outside one it is `_lin`."""
    from repro_torch.dist.mesh_ctx import shard_tp
    y = _lin(p["o_proj"], o2d, cfg)
    if shard_tp() > 1:
        from repro_torch.dist.collectives import all_reduce
        y = all_reduce(y)
    return y


def _project_qkv(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = _lin(p["q_proj"], x, cfg).reshape(b, s, hq, hd)
    k = _lin(p["k_proj"], x, cfg).reshape(b, s, hkv, hd)
    v = _lin(p["v_proj"], x, cfg).reshape(b, s, hkv, hd)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _scores(q: torch.Tensor, k: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """q [B,T,Hkv,G,D], k [B,S,Hkv,D] → f32 scores [B,Hkv,G,T,S]."""
    hd = q.shape[-1]
    s = torch.einsum("bthgd,bshd->bhgts", q.float(), k.float()) / math.sqrt(hd)
    if cfg.attn_logit_softcap > 0:
        c = cfg.attn_logit_softcap
        s = c * torch.tanh(s / c)
    return s


def _mask_bias(qpos: torch.Tensor, kpos: torch.Tensor,
               window: int) -> torch.Tensor:
    """Additive bias [T, S] (1-D positions) or [B, T, S] (per-row ragged
    positions): causal (+ window); keys at negative positions are left
    padding and masked."""
    q = qpos[..., :, None]
    kk = kpos[..., None, :]
    m = (kk <= q) & (kk >= 0)
    if window > 0:
        m &= kk > (q - window)
    return torch.where(m, 0.0, _NEG_INF)


def _naive_attention(q, k, v, qpos, kpos, cfg: ModelConfig) -> torch.Tensor:
    """q [B,T,Hq,D], k/v [B,S,Hkv,D]; the quadratic route. Probabilities
    are cast to V's dtype for P·V with f32 accumulation."""
    b, t, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, t, hkv, hq // hkv, hd)
    bias = _mask_bias(qpos, kpos, cfg.sliding_window)
    if bias.ndim == 3:                     # [B,T,S] -> [B,1,1,T,S]
        bias = bias[:, None, None]
    p = torch.softmax(_scores(qg, k, cfg) + bias, dim=-1)
    o = torch.einsum("bhgts,bshd->bthgd", p.to(v.dtype).float(), v.float())
    return o.reshape(b, t, hq, hd).to(q.dtype).contiguous()


def _chunked_causal_attention(q, k, v, cfg: ModelConfig,
                               chunk: int) -> torch.Tensor:
    """Blocked causal attention with a running-softmax combine, the
    reference's order: query chunk i walks key chunks j0..i (j0 skips the
    chunks wholly outside the sliding window), each chunk's f32 scores
    folded into the running (max, sum, acc); P·V takes the probabilities
    in V's dtype with f32 accumulation. q [B,S,Hq,D], k/v [B,S,Hkv,D], S a
    multiple of ``chunk``; shared positions ``arange(S)``."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    if s % chunk:
        raise ValueError(f"S={s} not a multiple of chunk={chunk}")
    n = s // chunk
    window = cfg.sliding_window
    qg = q.reshape(b, n, chunk, hkv, g, hd)
    kc = k.reshape(b, n, chunk, hkv, hd)
    vc = v.reshape(b, n, chunk, hkv, hd)
    ar = torch.arange(chunk, device=q.device)
    outs = []
    for i in range(n):
        j0 = max(0, (i * chunk - window) // chunk) if window > 0 else 0
        qi = qg[:, i]                                   # [B,C,Hkv,G,D]
        qpos = i * chunk + ar
        shape_ml = (b, hkv, g, chunk)
        m_run = torch.full(shape_ml, _NEG_INF, dtype=torch.float32,
                           device=q.device)
        l_run = torch.zeros(shape_ml, dtype=torch.float32, device=q.device)
        acc = torch.zeros((*shape_ml, hd), dtype=torch.float32,
                          device=q.device)
        for j in range(j0, i + 1):
            kj, vj = kc[:, j], vc[:, j]
            sc = _scores(qi, kj, cfg) + _mask_bias(qpos, j * chunk + ar,
                                                   window)
            m_new = torch.maximum(m_run, sc.amax(dim=-1))
            alpha = torch.exp(m_run - m_new)
            pj = torch.exp(sc - m_new[..., None])
            l_run = l_run * alpha + pj.sum(dim=-1)
            oj = torch.einsum("bhgts,bshd->bhgtd", pj.to(vj.dtype).float(),
                              vj.float())
            acc = acc * alpha[..., None] + oj
            m_run = m_new
        o = acc / torch.clamp(l_run[..., None], min=1e-30)   # [B,H,G,T,D]
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, chunk, hq, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


def attention_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: Optional[torch.Tensor] = None,
                    window_override: Optional[int] = None,
                    ragged: bool = False,
                    qkv: Optional[Tuple] = None) -> torch.Tensor:
    """Full-sequence (prefill) attention + output projection. ``ragged``:
    positions are per-row ladders of a left-padded batch.
    ``window_override`` replaces the config's sliding window. ``qkv``
    reuses projections the caller already made for the cache fill.

    Inside a training step on a mesh whose layout splits attention
    ("attn"; the heads dividing the model axis, one shared position
    ladder), `_attention_tp`; with the weights whole, the plain block on
    the whole sequence (`mlp.replicated_block`)."""
    from repro_torch.dist.mesh_ctx import shard_tp, train_layout
    if window_override is not None:
        cfg = cfg.replace(sliding_window=window_override)
    lay = train_layout()
    if lay is not None and shard_tp() == 0:
        if ("attn" in lay.split and cfg.num_heads % lay.tp == 0 and not ragged
                and qkv is None and positions is None
                and (x.shape[1] > 1 or lay.sp)):
            return _attention_tp(p, cfg, x, lay.tp, lay.sp)
        from repro_torch.models.mlp import replicated_block
        return replicated_block(
            lambda xx: _attention_plain(p, cfg, xx, positions, ragged, qkv),
            x)
    return _attention_plain(p, cfg, x, positions, ragged, qkv)


def _attention_plain(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                     positions: Optional[torch.Tensor], ragged: bool,
                     qkv: Optional[Tuple]) -> torch.Tensor:
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = qkv if qkv is not None else _project_qkv(p, cfg, x, positions)
    o = dispatch.attention(q, k, v, positions, cfg, ragged=ragged)
    return _o_proj(p, o.reshape(b, s, -1), cfg)


def _attention_tp(p: Dict, cfg: ModelConfig, x: torch.Tensor, tp: int,
                  sp: bool) -> torch.Tensor:
    """The reference's explicit tensor-parallel attention on this rank's
    slice: its ``hq / tp`` Q heads (``q_proj`` split by column), the K/V
    projections split by column and then gathered, so every rank holds
    every KV head and each local Q head reads its own, and ``o_proj``
    split by row. A sequence-parallel stream is gathered at the entry and
    reduce-scattered at the exit; a replicated one enters through
    `copy_to` and leaves through one all-reduce. Where the KV width does
    not divide the axis the K/V weights arrive whole, and their gradient
    (each rank's a share: its heads' keys) is summed over the axis."""
    from repro_torch.dist import collectives as col
    from repro_torch.dist.mesh_ctx import current_mesh
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    hq_l, g = hq // tp, hq // hkv
    if p["q_proj"]["w"].shape[-1] != hq_l * hd:
        raise ValueError(f"attention: q_proj holds "
                         f"{p['q_proj']['w'].shape[-1]} columns, not this "
                         f"rank's {hq_l} heads of {hd}")
    midx = current_mesh().index["model"]
    xl = col.gather_partial(x, "model", 1) if sp else col.copy_to(x, "model")
    b, s, _ = xl.shape
    kv_split = (hkv * hd) % tp == 0

    def lin(pp, split):
        w, bias = pp["w"], pp.get("b")
        if not split:
            w = col.copy_to(w, "model")
            bias = None if bias is None else col.copy_to(bias, "model")
        y = xl @ w.to(xl.dtype)
        return y if bias is None else y + bias.to(xl.dtype)

    q = lin(p["q_proj"], True).reshape(b, s, hq_l, hd)
    k, v = lin(p["k_proj"], kv_split), lin(p["v_proj"], kv_split)
    if kv_split:
        k = col.gather_partial(k, "model", 2)
        v = col.gather_partial(v, "model", 2)
    k, v = k.reshape(b, s, hkv, hd), v.reshape(b, s, hkv, hd)
    pos = torch.arange(s, device=x.device)[None, :]
    if cfg.rope:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    kv_idx = (midx * hq_l + torch.arange(hq_l, device=x.device)) // g
    o = dispatch.attention(q, k[:, :, kv_idx], v[:, :, kv_idx], pos, cfg)
    y = o.reshape(b, s, hq_l * hd) @ p["o_proj"]["w"].to(o.dtype)
    return (col.reduce_scatter(y, "model", 1) if sp
            else col.reduce_from(y, "model"))


def packed_attention_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                           seg_ids: torch.Tensor, positions: torch.Tensor,
                           qkv: Optional[Tuple] = None) -> torch.Tensor:
    """Packed (cu_seqlens) prefill attention + output projection: x [1, T,
    d] is a ragged batch's tokens concatenated on one axis, ``seg_ids [T]``
    the owning request of each position (non-decreasing), ``positions [1,
    T]`` each token's position within its request (RoPE). No query attends
    another request's key."""
    q, k, v = qkv if qkv is not None else _project_qkv(p, cfg, x, positions)
    o = dispatch.packed_attention(q, k, v, seg_ids, cfg)
    b, t, hq, hd = o.shape
    return _o_proj(p, o.reshape(b, t, hq * hd), cfg)


def chunk_attention_apply(p: Dict, cfg: ModelConfig, q: torch.Tensor,
                          cache_k: torch.Tensor, cache_v: torch.Tensor,
                          offset: torch.Tensor) -> torch.Tensor:
    """Continuation attention of one chunk-prefilling row: q [1, C, Hq, D]
    are the chunk's queries at absolute slots ``offset .. offset+C-1``
    (``offset`` a [1] int tensor); cache_k/v [1, S, Hkv, D] the row's whole
    cache with this chunk already written. The causal mask bounds reads to
    slots <= the query's, all real (packed rows have no left padding).
    Returns the o_proj output [1, C, d]."""
    c, s = q.shape[1], cache_k.shape[1]
    hq, hd = q.shape[2], q.shape[3]
    off = offset.reshape(1).to(torch.int32)
    with dispatch.chunk_attention(cfg, heads=hq, t=c, s=s, d=hd,
                                  itemsize=q.element_size(),
                                  floating=q.dtype in FLOAT_DTYPES) as route:
        dispatch.no_autograd(route, q, cache_k, cache_v)
        if route == "attn_flash":
            o = flash_attention(q.contiguous(), cache_k, cache_v,
                                q_offset=off.contiguous(),
                                window=cfg.sliding_window,
                                softcap=cfg.attn_logit_softcap)
        else:
            qpos = off + torch.arange(c, device=q.device)
            kpos = torch.arange(s, device=q.device)
            o = _naive_attention(q, cache_k, cache_v, qpos, kpos, cfg)
    return _o_proj(p, o.reshape(1, c, hq * hd), cfg)


def decode_attention_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                           cache_k: torch.Tensor, cache_v: torch.Tensor,
                           lengths: torch.Tensor,
                           start: Optional[torch.Tensor] = None,
                           window_override: Optional[int] = None,
                           ring: bool = False) -> torch.Tensor:
    """One-token decode: x [B, 1, d]; cache_k/v [B, Smax, Hkv, D] (one
    layer of the contiguous cache); lengths [B] the new token's absolute
    position.

    The new K/V are written INTO cache_k / cache_v in place (the reference
    returns updated copies); the slot clamps to Smax - 1 as the
    reference's dynamic_update_slice clamps an overshooting write.
    ``start`` [B]: first real slot of a left-padded row — RoPE runs at
    ``lengths - start`` and slots below ``start`` are masked.
    ``window_override`` replaces the config's sliding window.

    ``ring``: the cache is a sliding-window ring buffer of Smax slots
    (zamba2's shared block): the new K/V go to slot ``lengths % Smax``
    and every slot written so far is attended (``kpos < min(length + 1,
    Smax)``: the window is Smax by construction). K stays RoPE-rotated at
    its absolute position, so relative offsets hold across the wrap. The
    paged kernel has no ring layout, so a ring decode takes the plain
    softmax route."""
    b = x.shape[0]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    g = hq // hkv
    smax = cache_k.shape[1]
    window = (cfg.sliding_window if window_override is None
              else window_override)
    rope_pos = lengths if start is None else lengths - start
    q, k, v = _project_qkv(p, cfg, x, rope_pos[:, None])
    rows = torch.arange(b, device=x.device)
    ins = (lengths % smax if ring else lengths.clamp(max=smax - 1)).long()
    cache_k[rows, ins] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, ins] = v[:, 0].to(cache_v.dtype)

    page = cfg.kv_page_size or math.gcd(smax, DEFAULT_PAGE)
    with dispatch.attn_decode(
            cfg, pairs=b * hkv, group=g, head_dim=hd, page=page, smax=smax,
            itemsize=cache_k.element_size(), ring=ring,
            floating=x.dtype in (torch.float32, torch.bfloat16)) as route:
        if route == "attn_decode_flash":
            dispatch.no_autograd(route, q, cache_k, cache_v)
            n_log = smax // page
            o = paged_decode_attention(
                q.reshape(b, hkv, g, hd),
                cache_k.view(b * n_log, page, hkv, hd),
                cache_v.view(b * n_log, page, hkv, hd),
                identity_block_table(b, n_log, x.device), lengths, start,
                window=window, softcap=cfg.attn_logit_softcap)
            o = o.reshape(b, 1, hq * hd).to(x.dtype)
        else:
            qg = q.reshape(b, 1, hkv, g, hd)
            sc = _scores(qg, cache_k, cfg)               # [B,H,G,1,Smax]
            kpos = torch.arange(smax, device=x.device)[None, :]
            if ring:
                valid = kpos < torch.clamp(lengths[:, None] + 1, max=smax)
            else:
                valid = kpos <= lengths[:, None]
                if start is not None:
                    valid &= kpos >= start[:, None]
                if window > 0:
                    valid &= kpos > (lengths[:, None] - window)
            sc = sc + torch.where(valid, 0.0,
                                  _NEG_INF)[:, None, None, None, :]
            pr = torch.softmax(sc, dim=-1)
            o = torch.einsum("bhgts,bshd->bthgd",
                             pr.to(cache_v.dtype).float(), cache_v.float())
            o = o.reshape(b, 1, hq * hd).to(x.dtype).contiguous()
    return _o_proj(p, o, cfg)


def paged_decode_attention_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                                 k_pages: torch.Tensor, v_pages: torch.Tensor,
                                 block_table: torch.Tensor,
                                 lengths: torch.Tensor,
                                 start: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """One-token decode against a paged pool: x [B, 1, d]; k_pages/v_pages
    [P, page, Hkv, D] (one layer); block_table [B, n_log] maps each row's
    logical pages to pool pages.

    The new K/V are written INTO the pool in place, at the physical page
    the table names for slot ``lengths``; the logical page clamps to the
    table's last, so an overshooting row never runs off it, and a retired
    row (its table pointing at the dummy page 0) writes there. The
    attention is the paged decode kernel, which runs on every route."""
    b = x.shape[0]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    g = hq // hkv
    page = k_pages.shape[1]
    n_log = block_table.shape[1]
    rope_pos = lengths if start is None else lengths - start
    q, k, v = _project_qkv(p, cfg, x, rope_pos[:, None])
    logp = (lengths // page).clamp(0, n_log - 1).long()
    phys = block_table.gather(1, logp[:, None])[:, 0].long()
    off = (lengths % page).long()
    k_pages[phys, off] = k[:, 0].to(k_pages.dtype)
    v_pages[phys, off] = v[:, 0].to(v_pages.dtype)
    dispatch.no_autograd("attn_decode_flash", q, k_pages, v_pages)
    with dispatch.attn_decode(
            cfg, pairs=b * hkv, group=g, head_dim=hd, page=page,
            smax=n_log * page, itemsize=k_pages.element_size(),
            floating=x.dtype in (torch.float32, torch.bfloat16),
            paged=True):
        o = paged_decode_attention(
            q.reshape(b, hkv, g, hd), k_pages, v_pages, block_table,
            lengths, start, window=cfg.sliding_window,
            softcap=cfg.attn_logit_softcap)
    return _o_proj(p, o.reshape(b, 1, hq * hd).to(x.dtype), cfg)


def _verify_positions(lengths: torch.Tensor, start: Optional[torch.Tensor],
                      t: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row starts [B] — zeros for an unpadded cache, logical query
    positions [B, T] = ``lengths - start + t``)."""
    st = torch.zeros_like(lengths) if start is None else start
    qpos = (lengths - st)[:, None] + torch.arange(
        t, device=lengths.device)[None, :]
    return st, qpos


def verify_attention_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                           cache_k: torch.Tensor, cache_v: torch.Tensor,
                           lengths: torch.Tensor,
                           start: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Speculative verify attention on one layer of the contiguous cache:
    x [B, T, d] holds the current token and the T-1 draft tokens of each
    row. Their K/V are written INTO cache_k / cache_v in place at slots
    ``lengths .. lengths+T-1`` (the slab's first slot clamps to Smax - T,
    as the reference's dynamic_update_slice clamps it), then every
    position attends the row's cache causally through the naive route.
    ``lengths`` is not advanced here: the engine advances it by the
    accepted count, and stale slots past it are masked and rewritten by
    the next step. RoPE runs at logical positions ``lengths - start + t``;
    slots below ``start`` are never attended. Returns the o_proj output."""
    b, t, _ = x.shape
    hq, hd = cfg.num_heads, cfg.resolved_head_dim
    smax = cache_k.shape[1]
    st, qpos = _verify_positions(lengths, start, t)
    q, k, v = _project_qkv(p, cfg, x, qpos)
    first = lengths.clamp(0, smax - t).long()
    slots = first[:, None] + torch.arange(t, device=x.device)[None, :]
    rows = torch.arange(b, device=x.device)[:, None]
    cache_k[rows, slots] = k.to(cache_k.dtype)
    cache_v[rows, slots] = v.to(cache_v.dtype)
    # slot s holds logical position s - start: pad slots fall below zero
    kpos = torch.arange(smax, device=x.device)[None, :] - st[:, None]
    o = _naive_attention(q, cache_k, cache_v, qpos, kpos, cfg)
    return _o_proj(p, o.reshape(b, t, hq * hd), cfg)


def paged_verify_attention_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                                 k_pages: torch.Tensor, v_pages: torch.Tensor,
                                 block_table: torch.Tensor,
                                 lengths: torch.Tensor,
                                 start: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """`verify_attention_apply` against a paged pool: the T candidates' K/V
    are written into the pool in place through the block table (logical
    pages clamp to the table's last; a retired row's table points at the
    dummy page), then the row's pages are gathered back into one
    contiguous row for the same naive attention — the same keys in the
    same order as the contiguous cache, so both caches give bit-identical
    results."""
    b, t, _ = x.shape
    hq, hd = cfg.num_heads, cfg.resolved_head_dim
    page = k_pages.shape[1]
    n_log = block_table.shape[1]
    st, qpos = _verify_positions(lengths, start, t)
    q, k, v = _project_qkv(p, cfg, x, qpos)
    slots = lengths[:, None] + torch.arange(t, device=x.device)[None, :]
    logp = (slots // page).clamp(0, n_log - 1).long()
    phys = block_table.gather(1, logp).long()                 # [B, T]
    off = (slots % page).long()
    k_pages[phys, off] = k.to(k_pages.dtype)
    v_pages[phys, off] = v.to(v_pages.dtype)
    krow = gather_pages(k_pages, block_table)                 # [B, S, Hkv, D]
    vrow = gather_pages(v_pages, block_table)
    kpos = torch.arange(n_log * page, device=x.device)[None, :] - st[:, None]
    o = _naive_attention(q, krow, vrow, qpos, kpos, cfg)
    return _o_proj(p, o.reshape(b, t, hq * hd), cfg)
