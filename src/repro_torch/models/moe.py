"""Mixture-of-Experts FFN: top-k routing, capacity-bounded dispatch and
combine, as the reference's ``local`` path (every expert on the one
device).

`moe_apply` routes each token to its ``top_k`` experts by an f32 router
product, sorts the (token, expert) pairs by expert, gives each pair a rank
within its expert and keeps the first ``capacity`` of each expert (the rest
drop), gathers the kept tokens into ``[E, C, d]``, runs the experts'
gated MLPs and adds each token's weighted contributions back. Arctic's
dense residual MLP and Kimi's shared expert are both ``dense_residual_ff``
(an always-active MLP beside the experts).

The reference's expert-parallel path (``impl="ep"``, experts sharded over a
mesh axis) is not ported.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import dispatch
from repro_torch.kernels.epilogue import apply_act
from repro_torch.models.common import normal_init
from repro_torch.models.mlp import mlp_apply, mlp_init

__all__ = ["moe_init", "moe_apply", "moe_routed", "dense_mlp_cfg"]

# up to this many experts the kernel route runs each expert's GEMMs as
# separate dispatch.matmul calls; above it, batched products
_FUSED_EXPERT_MAX = 16


def dense_mlp_cfg(cfg: ModelConfig) -> ModelConfig:
    """The config the dense residual MLP runs under (its own width)."""
    return cfg.replace(d_ff=cfg.moe.dense_residual_ff)


def moe_init(gen: torch.Generator, lead, cfg: ModelConfig,
             dtype: torch.dtype, device) -> Dict:
    """A MoE block's parameters, stacked ``[*lead, ...]``: the f32 router
    ``[d, E]``, the expert planes ``[E, d, f]`` / ``[E, f, d]`` (raw
    tensors, as the reference keeps them) and the dense residual MLP, at
    the reference's fan-in scales."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    scale_in = 1.0 / (d ** 0.5)
    scale_out = 1.0 / (f ** 0.5 * (2 * cfg.num_layers) ** 0.5)
    p = {
        "router": {"w": normal_init(gen, (*lead, d, e), scale_in,
                                    torch.float32, device)},
        "experts": {
            "wi": normal_init(gen, (*lead, e, d, f), scale_in, dtype, device),
            "wo": normal_init(gen, (*lead, e, f, d), scale_out, dtype,
                              device),
        },
    }
    if cfg.mlp_gated:
        p["experts"]["wg"] = normal_init(gen, (*lead, e, d, f), scale_in,
                                         dtype, device)
    if cfg.moe.dense_residual_ff:
        p["dense_mlp"] = mlp_init(gen, lead, d, cfg.moe.dense_residual_ff,
                                  cfg, dtype, device)
    return p


def _expert_ffn(ew: Dict, xs: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``xs [E, C, d]`` → ``[E, C, d]`` through each expert's (gated) MLP.

    On the kernel route with at most ``_FUSED_EXPERT_MAX`` experts every
    expert's three GEMMs are `dispatch.matmul` calls (the M-tiled or skinny
    dense kernels by the route costs), the activation fused into the gate
    GEMM's epilogue; every expert runs, empty ones included. Otherwise
    three batched products."""
    e = xs.shape[0]
    if dispatch.pallas_route_active(cfg) and e <= _FUSED_EXPERT_MAX:
        outs = []
        for i in range(e):
            h = dispatch.matmul(
                xs[i], ew["wi"][i].to(xs.dtype),
                act="none" if cfg.mlp_gated else cfg.act,
                out_dtype=xs.dtype, cfg=cfg, pallas=True)
            if cfg.mlp_gated:
                h = dispatch.matmul(xs[i], ew["wg"][i].to(xs.dtype),
                                    act=cfg.act, out_dtype=xs.dtype,
                                    cfg=cfg, pallas=True) * h
            outs.append(dispatch.matmul(h, ew["wo"][i].to(xs.dtype),
                                        out_dtype=xs.dtype, cfg=cfg,
                                        pallas=True))
        return torch.stack(outs, dim=0)
    h = torch.bmm(xs, ew["wi"].to(xs.dtype))
    if cfg.mlp_gated:
        h = apply_act(torch.bmm(xs, ew["wg"].to(xs.dtype)), cfg.act) * h
    else:
        h = apply_act(h, cfg.act)
    return torch.bmm(h, ew["wo"].to(xs.dtype))


def _dispatch_compute_combine(x: torch.Tensor, ew: Dict,
                              top_idx: torch.Tensor, top_p: torch.Tensor,
                              e0: int, e_loc: int, capacity: int,
                              cfg: ModelConfig) -> torch.Tensor:
    """Capacity-bounded sort-based dispatch of ``x [T, d]`` to the experts
    ``e0 .. e0+e_loc-1`` and the weighted combine back to ``[T, d]``.

    The pairs sort stably by local expert (out-of-range experts sink to
    the end); a pair's rank is its position within its expert's run; pairs
    at rank ``capacity`` and above, and out-of-range ones, go to a trash
    slot ``e_loc * capacity`` and contribute zero. Each token's k
    contributions are added in ascending expert order, one add at a time
    in x's dtype (the order the reference's scatter-add takes them), with
    no atomics, so a row's bits repeat from run to run."""
    t, d = x.shape
    k = top_idx.shape[1]
    dev = x.device
    # each token's pairs in ascending expert order, the order the combine
    # adds them in (ranks do not move: a token meets an expert once)
    top_idx, perm = torch.sort(top_idx, dim=1)
    top_p = top_p.gather(1, perm)
    e_flat = top_idx.reshape(-1)
    t_flat = torch.arange(t, device=dev).repeat_interleave(k)
    p_flat = top_p.reshape(-1).float()

    local = e_flat - e0
    in_range = (local >= 0) & (local < e_loc)
    sort_key = torch.where(in_range, local, torch.full_like(local, e_loc))
    order = torch.argsort(sort_key, stable=True)
    se, st = sort_key[order], t_flat[order]
    start = torch.searchsorted(se, torch.arange(e_loc, device=dev))
    rank = torch.arange(t * k, device=dev) - start[se.clamp(0, e_loc - 1)]
    valid = (se < e_loc) & (rank < capacity)
    trash = e_loc * capacity
    slot = torch.where(valid, se * capacity + rank,
                       torch.full_like(se, trash))

    xs = torch.zeros((trash + 1, d), dtype=x.dtype, device=dev)
    xs[slot] = x[st]
    ys = _expert_ffn(ew, xs[:-1].reshape(e_loc, capacity, d), cfg)
    ys = ys.reshape(trash, d)
    # the pairs' slots back in token-major order, so the gather lands each
    # contribution at [T, k] directly
    slot_t = torch.empty_like(slot)
    slot_t[order] = slot
    valid_t = torch.empty_like(valid)
    valid_t[order] = valid
    contrib = torch.where(valid_t[:, None], ys[slot_t.clamp(max=trash - 1)],
                          torch.zeros((), dtype=x.dtype, device=dev))
    per_tok = (contrib * p_flat[:, None].to(x.dtype)).reshape(t, k, d)
    y = per_tok[:, 0]
    for j in range(1, k):
        y = y + per_tok[:, j]
    return y


def _route(x: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(top_idx [T, k], top_p [T, k], aux loss) for ``x [T, d]``.

    The gates are the softmax of an f32 product on an f32 copy of x. The
    top k come from a stable descending sort, so equal gates go to the
    lower expert index first, as ``jax.lax.top_k`` orders them. top_p is
    renormalised over the k. The Switch load-balance loss is ``E · Σ_e f_e
    P_e`` with ``f_e`` the share of routed pairs on expert e (counted by a
    scatter of ones, exact in f32, then divided) and ``P_e`` its mean
    gate."""
    logits = x.float() @ router_w.float()                    # [T, E]
    gates = torch.softmax(logits, dim=-1)
    kk = cfg.moe.top_k
    top_idx = torch.argsort(gates, dim=-1, descending=True,
                            stable=True)[:, :kk]
    top_p = gates.gather(1, top_idx)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    e = gates.shape[-1]
    pe = gates.mean(dim=0)
    flat = top_idx.reshape(-1)
    counts = torch.zeros((e,), dtype=torch.float32, device=x.device)
    counts = counts.scatter_add(0, flat, torch.ones_like(flat,
                                                         dtype=torch.float32))
    fe = counts / flat.numel()
    aux = e * torch.sum(fe * pe)
    return top_idx, top_p, aux


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``tokens`` routed tokens: ``capacity_factor``
    times the even share, rounded up to a multiple of 8, at least 8."""
    c = int(tokens * cfg.moe.top_k * cfg.moe.capacity_factor
            / max(1, cfg.moe.num_experts))
    return max(8, -(-c // 8) * 8)


def moe_routed(p: Dict, cfg: ModelConfig, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts alone: ``x [B, S, d]`` → (y [B, S, d], aux
    loss). All B·S tokens share one capacity (pad rows and positions
    included, as in the reference)."""
    impl = cfg.moe.impl
    if impl == "ep":
        raise NotImplementedError(
            "moe.impl='ep' (expert parallelism) is not ported: it comes "
            "with tensor parallelism (ROADMAP.md, Queue 1, item 2)")
    if impl not in ("auto", "local"):
        raise ValueError(f"moe.impl={impl!r}")
    b, s, d = x.shape
    e = cfg.moe.num_experts
    xt = x.reshape(b * s, d)
    top_idx, top_p, aux = _route(xt, p["router"]["w"], cfg)
    y = _dispatch_compute_combine(xt, p["experts"], top_idx, top_p, 0, e,
                                  _capacity(b * s, cfg), cfg)
    return y.reshape(b, s, d), aux


def moe_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [B, S, d]`` → (y [B, S, d], aux loss): the routed experts plus
    the dense residual MLP where the block has one."""
    y, aux = moe_routed(p, cfg, x)
    if "dense_mlp" in p:
        y = y + mlp_apply(p["dense_mlp"], dense_mlp_cfg(cfg), x)
    return y, aux
