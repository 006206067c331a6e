"""Optimizers written out (no `torch.optim`: the JAX package's arithmetic
is the spec): AdamW, Adafactor (factored second moment), SGD-momentum; a
warmup + cosine learning-rate schedule; global-norm clipping.

`make_optimizer` returns ``(init, update)``: ``update(grads, state,
params, step, specs=None) -> (updates, new_state)``, where updates are
deltas the caller adds to the params. Nothing is modified in place: the
old state stays valid, so a failed step can be retried from it. The
schedule and Adam's ``b1**t``, ``b2**t`` are float32 scalars on the host,
as in the reference (a 0-d CPU tensor enters a CUDA op as a scalar
argument).

On a mesh the trees hold each rank's shards and ``specs`` (a tree of
`dist.sharding.Spec` mirroring the params) says which axes split each
leaf: `global_norm` adds each leaf's sum of squares over the axes that
split it, and only those (a replicated leaf counts once), and Adafactor's
row and column means, its update RMS and its parameter RMS are global
means over a split leaf. AdamW and SGD are elementwise and read no spec.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.train.tree import tree_leaves, tree_map, tree_unzip

__all__ = ["make_optimizer", "lr_schedule", "global_norm",
           "clip_by_global_norm"]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def lr_schedule(cfg: TrainConfig) -> Callable[[int], torch.Tensor]:
    """Linear warmup to ``learning_rate``, then a cosine decay to a tenth
    of it at ``steps``; a float32 scalar for an integer step."""
    base, warm, total = cfg.learning_rate, cfg.warmup_steps, max(cfg.steps, 1)

    def fn(step: int) -> torch.Tensor:
        s = _f32(step)
        if step < warm:
            return _f32(base) * (s + 1) / _f32(max(warm, 1))
        t = torch.clamp((s - warm) / _f32(max(total - warm, 1)), 0.0, 1.0)
        return _f32(base) * (0.1 + 0.9 * 0.5 * (1 + torch.cos(
            _f32(math.pi) * t)))

    return fn


def _axes(spec, nd: int, dims=None) -> Tuple[str, ...]:
    """The mesh axes that split dims ``dims`` (negative indices; None: all)
    of a rank-``nd`` leaf under ``spec``."""
    if spec is None:
        return ()
    ents = tuple(spec) + (None,) * (nd - len(tuple(spec)))
    out = []
    for d, e in enumerate(ents):
        if dims is not None and d - nd not in dims:
            continue
        out += [e] if isinstance(e, str) else list(e or ())
    return tuple(out)


def _mean(x: torch.Tensor, dim: Optional[int], axes: Tuple[str, ...],
          keepdim: bool = False) -> torch.Tensor:
    """``x.mean(dim)`` (all of x when None) over the whole leaf: the sums
    added over ``axes`` first, whose ranks hold the dim's other blocks."""
    if not axes:
        return (x.mean() if dim is None
                else x.mean(dim=dim, keepdim=keepdim))
    from repro_torch.dist.collectives import sum_over
    from repro_torch.dist.mesh_ctx import current_mesh
    n = x.numel() if dim is None else x.shape[dim]
    for a in axes:
        n *= current_mesh().shape[a]
    tot = x.sum() if dim is None else x.sum(dim=dim, keepdim=keepdim)
    return sum_over(tot, axes) / n


def global_norm(tree: Any, specs: Any = None) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares (leaves added in
    the reference's order); with ``specs``, each leaf's sum over the
    shards that split it (one all-reduce per set of axes)."""
    if specs is None:
        leaves = [torch.sum(torch.square(x.float()))
                  for x in tree_leaves(tree)]
        if not leaves:
            return torch.zeros((), dtype=torch.float32)
        total = leaves[0]
        for x in leaves[1:]:
            total = total + x
        return torch.sqrt(total)
    from repro_torch.dist.collectives import sum_over
    groups: Dict[Tuple[str, ...], torch.Tensor] = {}

    def add(x, spec):
        ax = _axes(spec, x.ndim)
        sq = torch.sum(torch.square(x.float()))
        groups[ax] = sq if ax not in groups else groups[ax] + sq
    tree_map(add, tree, specs)
    total = None
    for ax, sq in groups.items():
        sq = sum_over(sq, ax)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(tree: Any, max_norm: float, specs: Any = None
                        ) -> Tuple[Any, torch.Tensor]:
    """(the tree scaled by min(1, max_norm / global norm), the norm)."""
    gn = global_norm(tree, specs)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), gn


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _adamw(cfg: TrainConfig, b1=0.9, b2=0.95, eps=1e-8):
    sched = lr_schedule(cfg)

    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params, step: int, specs=None):
        t = _f32(step) + 1.0
        lr = sched(step)
        c1, c2 = 1 - _f32(b1) ** t, 1 - _f32(b2) ** t

        def upd(g, m, v, p):
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            if p.ndim >= 2:          # decoupled decay, matrices only
                u = u + cfg.weight_decay * p.float()
            return (-lr * u).to(p.dtype), m, v

        ups, m, v = tree_unzip(
            tree_map(upd, grads, state["m"], state["v"], params), 3)
        return ups, {"m": m, "v": v}

    return init, update


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018), factored for leaves of rank >= 2
# ---------------------------------------------------------------------------

def _adafactor(cfg: TrainConfig, eps1=1e-30, eps2=1e-3, clip_thr=1.0,
               beta2_cap=0.999):
    sched = lr_schedule(cfg)

    def init(params):
        def st(p):
            z = dict(dtype=torch.float32, device=p.device)
            if p.ndim >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}
        return {"s": tree_map(st, params)}

    def update(grads, state, params, step: int, specs=None):
        t = _f32(step) + 1.0
        beta2 = torch.clamp(1.0 - t ** -0.8, max=beta2_cap)
        lr = sched(step)

        def upd(g, p, s, spec=None):
            g = g.float()
            g2 = g * g + eps1
            nd = p.ndim
            if nd >= 2:
                ax_n, ax_k = _axes(spec, nd, (-1,)), _axes(spec, nd, (-2,))
                vr = beta2 * s["vr"] + (1 - beta2) * _mean(g2, -1, ax_n)
                vc = beta2 * s["vc"] + (1 - beta2) * _mean(g2, -2, ax_k)
                denom = torch.clamp(_mean(vr, -1, ax_k, keepdim=True),
                                    min=eps1)[..., None]       # [..., 1, 1]
                u = (g * torch.rsqrt(vr[..., None] / denom)
                     * torch.rsqrt(vc[..., None, :]))
                ns = {"vr": vr, "vc": vc}
            else:
                v = beta2 * s["v"] + (1 - beta2) * g2
                u = g * torch.rsqrt(v)
                ns = {"v": v}
            ax = _axes(spec, nd)
            # update clipping by RMS
            rms_u = torch.sqrt(_mean(u * u, None, ax) + eps1)
            u = u / torch.clamp(rms_u / clip_thr, min=1.0)
            # relative step size
            p32 = p.float()
            scale = torch.clamp(torch.sqrt(_mean(p32 * p32, None, ax)),
                                min=eps2)
            upd_ = -lr * scale * u
            if p.ndim >= 2 and cfg.weight_decay:
                upd_ = upd_ - lr * cfg.weight_decay * p32
            return upd_.to(p.dtype), ns

        # the state's per-leaf dicts sit where the grads have tensors
        trees = (grads, params, state["s"]) + (() if specs is None
                                                else (specs,))
        ups, ns = tree_unzip(tree_map(upd, *trees), 2)
        return ups, {"s": ns}

    return init, update


# ---------------------------------------------------------------------------
# SGD-momentum
# ---------------------------------------------------------------------------

def _sgd(cfg: TrainConfig, momentum=0.9):
    sched = lr_schedule(cfg)

    def init(params):
        return {"mom": tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)}

    def update(grads, state, params, step: int, specs=None):
        lr = sched(step)

        def upd(g, m, p):
            m = momentum * m + g.float()
            u = -lr * (m + cfg.weight_decay * p.float()
                       if p.ndim >= 2 else m)
            return u.to(p.dtype), m

        ups, m = tree_unzip(tree_map(upd, grads, state["mom"], params), 2)
        return ups, {"mom": m}

    return init, update


def make_optimizer(cfg: TrainConfig):
    """``(init_fn, update_fn)`` of ``cfg.optimizer``."""
    if cfg.optimizer == "adamw":
        return _adamw(cfg)
    if cfg.optimizer == "adafactor":
        return _adafactor(cfg)
    if cfg.optimizer == "sgd":
        return _sgd(cfg)
    raise ValueError(cfg.optimizer)
