"""The train step: DBB projection → forward → cross-entropy → gradients
(optionally over microbatches) → global-norm clip → optional compression
→ optimizer update.

The structure is the JAX package's. The projection runs once a step,
outside the gradient graph (``straight_through=False``), and the loss is
differentiated at the projected params; applying those gradients to the
dense masters IS the straight-through estimator. The loss forces the
plain GEMM route (``gemm_impl="xla"``): the hand-written kernels have no
backward, and `kernels.dispatch.no_autograd` raises if a kernel route
would run under autograd anyway.

A step builds a new `TrainState` and modifies none of the old one's
tensors, so a failed step can be retried from the same state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, RunConfig
from repro_torch.core.sparsity import apply_dbb_to_tree, map_with_path
from repro_torch.device import resolve_device
from repro_torch.dist.collectives import cross_entropy
from repro_torch.models import registry
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.grad_compress import compress_grads, init_ef_state
from repro_torch.train.tree import tree_map

__all__ = ["TrainState", "init_train_state", "make_loss_fn",
           "make_train_step", "make_eval_step", "loss_and_grads"]

@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    ef: Any                      # error-feedback state or None
    step: int


def init_train_state(run_cfg: RunConfig, *, seed: Optional[int] = None,
                     device="cuda", params: Optional[Dict] = None
                     ) -> TrainState:
    """Fresh params (the port's `init_params`, a ``torch.Generator`` seeded
    with ``seed``, by default ``run_cfg.train.seed``), or ``params`` as
    given (e.g. a tree carried across from the reference), with zeroed
    optimizer and error-feedback state, at step 0."""
    dev = resolve_device(device)
    if params is None:
        seed = run_cfg.train.seed if seed is None else seed
        params = registry.init_params(run_cfg.model, seed=seed, device=dev)
    init_fn, _ = opt_mod.make_optimizer(run_cfg.train)
    return TrainState(params=params, opt_state=init_fn(params),
                      ef=init_ef_state(params, run_cfg.train.grad_compress),
                      step=0)


def _classification_ce(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[:, None])[:, 0]
    return (lse - ll).mean()


def make_loss_fn(cfg: ModelConfig, nnz: Optional[int] = None,
                 project_dbb: bool = True
                 ) -> Callable[[Any, Dict], Tuple[torch.Tensor, Dict]]:
    """``loss_fn(params, batch) -> (loss, metrics)``, the batch a dict of
    tensors on the params' device. ``project_dbb`` applies the DBB
    straight-through projection inside (the train step projects once
    outside instead)."""
    # training differentiates the forward; the kernels have no backward,
    # so the loss graph takes the plain GEMM route
    if cfg.gemm_impl != "xla":
        cfg = cfg.replace(gemm_impl="xla")

    def loss_fn(params, batch):
        p_eff = (apply_dbb_to_tree(params, cfg.dbb, nnz=nnz)
                 if project_dbb else params)
        if cfg.family == "cnn":
            logits, _ = registry.forward(p_eff, cfg, batch)
            loss = _classification_ce(logits, batch["labels"])
            acc = (logits.argmax(-1) == batch["labels"]).float().mean()
            return loss, {"loss": loss, "acc": acc}
        hidden, aux = registry.forward(p_eff, cfg, batch)
        w_head = registry.lm_head_weight(p_eff, cfg)
        loss = cross_entropy(hidden, w_head, batch["labels"],
                             mask=batch.get("loss_mask"))
        total = loss + cfg.moe.aux_loss_weight * aux
        return total, {"loss": loss, "aux": aux}

    return loss_fn


def _grad_leaves(params: Any) -> Tuple[Any, List[Tuple[str, torch.Tensor]]]:
    """(params with every float tensor replaced by a detached alias that
    requires grad, [(path, alias)])."""
    leaves: List[Tuple[str, torch.Tensor]] = []

    def visit(path, leaf):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            leaf = leaf.detach().requires_grad_(True)
            leaves.append((path, leaf))
        return leaf

    return map_with_path(visit, params), leaves


def loss_and_grads(loss_fn, params: Any, batch: Dict
                   ) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """(the gradient of ``loss_fn``'s loss for every float leaf of
    ``params``, in the params' structure; the detached metrics). Raises if
    a leaf received no gradient: every trainable leaf takes part in the
    loss, so a missing one means the graph was cut (a kernel's output has
    no ``grad_fn``). The one exception: a batch of frame ``embeds`` and
    no ``tokens`` (the audio family) never reads the embedding table,
    whose gradient is then zeros, as ``jax.grad`` gives."""
    req, leaves = _grad_leaves(params)
    with torch.enable_grad():
        loss, metrics = loss_fn(req, batch)
        grads = torch.autograd.grad(loss, [t for _, t in leaves],
                                    allow_unused=True)
    unread = {"embed/table"} if "tokens" not in batch else set()
    missing = [p for (p, _), g in zip(leaves, grads)
               if g is None and p not in unread]
    if missing:
        raise RuntimeError(f"no gradient reached {missing}")
    by_path = {p: torch.zeros_like(t) if g is None else g
               for (p, t), g in zip(leaves, grads)}
    out = map_with_path(lambda p, leaf: by_path.get(p, leaf), params)
    return out, {k: v.detach() for k, v in metrics.items()}


def _microbatches(batch: Dict, m: int) -> List[Dict]:
    return [{k: v.chunk(m)[i] for k, v in batch.items()} for i in range(m)]


def make_train_step(run_cfg: RunConfig, nnz: Optional[int] = None
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """``train_step(state, batch) -> (new state, metrics)`` at density
    bound ``nnz`` (None: the config's). Metrics are device scalars: the
    loss terms, ``grad_norm`` (before clipping) and ``lr``."""
    cfg = run_cfg.model
    tcfg = run_cfg.train
    loss_fn = make_loss_fn(cfg, nnz=nnz, project_dbb=False)
    _, update_fn = opt_mod.make_optimizer(tcfg)
    sched = opt_mod.lr_schedule(tcfg)

    def grads_of(params, batch):
        m = tcfg.microbatches
        if m <= 1:
            return loss_and_grads(loss_fn, params, batch)
        g_acc, met_acc = None, None
        for mb in _microbatches(batch, m):
            g, met = loss_and_grads(loss_fn, params, mb)
            g = tree_map(lambda t: t.float(), g)
            met = {k: v.float() for k, v in met.items()}
            if g_acc is None:
                g_acc, met_acc = g, met
            else:
                g_acc = tree_map(torch.add, g_acc, g)
                met_acc = {k: met_acc[k] + met[k] for k in met_acc}
        inv = 1.0 / m
        return (tree_map(lambda t: t * inv, g_acc),
                {k: v * inv for k, v in met_acc.items()})

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        p_eff = apply_dbb_to_tree(state.params, cfg.dbb, nnz=nnz,
                                  straight_through=False)
        grads, metrics = grads_of(p_eff, batch)
        del p_eff
        with torch.no_grad():
            grads, gnorm = opt_mod.clip_by_global_norm(grads, tcfg.grad_clip)
            grads, new_ef = compress_grads(grads, state.ef,
                                           tcfg.grad_compress)
            updates, new_opt = update_fn(grads, state.opt_state,
                                         state.params, state.step)
            del grads
            new_params = tree_map(
                lambda p, u: (p.float() + u.float()).to(p.dtype),
                state.params, updates)
        metrics = dict(metrics, grad_norm=gnorm, lr=sched(state.step))
        return TrainState(params=new_params, opt_state=new_opt, ef=new_ef,
                          step=state.step + 1), metrics

    return train_step


def make_eval_step(run_cfg: RunConfig, nnz: Optional[int] = None):
    """``eval_step(params, batch) -> metrics`` without gradients, on the
    params projected at ``nnz`` (the plain route)."""
    loss_fn = make_loss_fn(run_cfg.model, nnz=nnz)

    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = loss_fn(params, batch)
        return metrics

    return eval_step
