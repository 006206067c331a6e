"""Optimizers written out (no `torch.optim`: the JAX package's arithmetic
is the spec): AdamW, Adafactor (factored second moment), SGD-momentum; a
warmup + cosine learning-rate schedule; global-norm clipping.

`make_optimizer` returns ``(init, update)``: ``update(grads, state,
params, step) -> (updates, new_state)``, where updates are deltas the
caller adds to the params. Nothing is modified in place: the old state
stays valid, so a failed step can be retried from it. The schedule and
Adam's ``b1**t``, ``b2**t`` are float32 scalars on the host, as in the
reference (a 0-d CPU tensor enters a CUDA op as a scalar argument).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Tuple

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


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares (leaves added in
    the reference's order)."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    total = leaves[0]
    for x in leaves[1:]:
        total = total + x
    return torch.sqrt(total)


def clip_by_global_norm(tree: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """(the tree scaled by min(1, max_norm / global norm), the norm)."""
    gn = global_norm(tree)
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

    def update(grads, state, params, step: int):
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

    def update(grads, state, params, step: int):
        t = _f32(step) + 1.0
        beta2 = torch.clamp(1.0 - t ** -0.8, max=beta2_cap)
        lr = sched(step)

        def upd(g, p, s):
            g = g.float()
            g2 = g * g + eps1
            if p.ndim >= 2:
                vr = beta2 * s["vr"] + (1 - beta2) * g2.mean(dim=-1)
                vc = beta2 * s["vc"] + (1 - beta2) * g2.mean(dim=-2)
                denom = torch.clamp(vr.mean(dim=-1, keepdim=True),
                                    min=eps1)[..., None]       # [..., 1, 1]
                u = (g * torch.rsqrt(vr[..., None] / denom)
                     * torch.rsqrt(vc[..., None, :]))
                ns = {"vr": vr, "vc": vc}
            else:
                v = beta2 * s["v"] + (1 - beta2) * g2
                u = g * torch.rsqrt(v)
                ns = {"v": v}
            # update clipping by RMS
            rms_u = torch.sqrt(torch.mean(u * u) + eps1)
            u = u / torch.clamp(rms_u / clip_thr, min=1.0)
            # relative step size
            p32 = p.float()
            scale = torch.clamp(torch.sqrt(torch.mean(p32 * p32)), min=eps2)
            upd_ = -lr * scale * u
            if p.ndim >= 2 and cfg.weight_decay:
                upd_ = upd_ - lr * cfg.weight_decay * p32
            return upd_.to(p.dtype), ns

        # the state's per-leaf dicts sit where the grads have tensors
        ups, ns = tree_unzip(tree_map(upd, grads, params, state["s"]), 2)
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

    def update(grads, state, params, step: int):
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
