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

On a mesh (`plan_mesh`, then ``make_train_step(..., plan=)``) every rank
runs the step on its own shards, as plain local tensors, and computes what
the reference's GSPMD step computes on the global arrays:

  * the params, the optimizer state and the error feedback are held as
    `dist.sharding.param_specs` / ``opt_state_specs_like`` cut them: TP
    over "model", ZeRO over the batch axes for leaves of at least
    ``fsdp_min_shard_elems`` elements;
  * before the forward each leaf is gathered over its ZeRO axes, and over
    "model" too where no tensor-parallel block reads that split (the
    `TrainLayout`'s ``split``); the DBB projection runs on these forward
    leaves, whose K blocks are whole (a row split keeps whole blocks, or
    `plan_mesh` refuses it);
  * the forward runs under the layout: vocab-parallel embedding and CE,
    Megatron's column / row blocks with sequence parallelism, expert
    parallelism, each collective carrying its gradient;
  * each forward leaf's gradient is summed over the batch axes (one
    all-reduce of all of them) and cut back to the rank's block: a
    reduce-scatter for the ZeRO leaves;
  * clipping, Adafactor's means and int8_ef's scale reduce over the axes
    that split each leaf (`train.optimizer`, `train.grad_compress`).

Each global microbatch is split over the batch axes as the reference
does it: rank r's rows of microbatch i are its block of the global
microbatch i (`rank_batch`).

A step builds a new `TrainState` and modifies none of the old one's
tensors, so a failed step can be retried from the same state (on one
device: on a mesh a failed rank fails the world).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, RunConfig
from repro_torch.core.sparsity import apply_dbb_to_tree, map_with_path
from repro_torch.device import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.dist.collectives import all_gather, all_reduce, cross_entropy
from repro_torch.dist.mesh_ctx import (TrainLayout, data_axes_of,
                                       shard_hint, train_layout, use_mesh,
                                       use_train_layout)
from repro_torch.models import registry
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.grad_compress import compress_grads, init_ef_state
from repro_torch.train.tree import tree_map

__all__ = ["TrainState", "init_train_state", "make_loss_fn",
           "make_train_step", "make_eval_step", "loss_and_grads", "MeshPlan",
           "plan_mesh", "rank_batch", "gather_state", "shard_state"]

@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    ef: Any                      # error-feedback state or None
    step: int


def init_train_state(run_cfg: RunConfig, *, seed: Optional[int] = None,
                     device="cuda", params: Optional[Dict] = None,
                     plan: Optional["MeshPlan"] = None) -> TrainState:
    """Fresh params (the port's `init_params`, a ``torch.Generator`` seeded
    with ``seed``, by default ``run_cfg.train.seed``), or ``params`` as
    given (e.g. a tree carried across from the reference), with zeroed
    optimizer and error-feedback state, at step 0. With ``plan`` the
    params are the whole tree and the state is this rank's shards (the
    plan takes the optimizer state's specs)."""
    dev = resolve_device(device)
    if params is None:
        seed = run_cfg.train.seed if seed is None else seed
        params = registry.init_params(run_cfg.model, seed=seed, device=dev)
    if plan is not None:
        params = tree_map(lambda t: t.to(dev),
                          shd.shard_tree(params, plan.specs, plan.mesh))
    init_fn, _ = opt_mod.make_optimizer(run_cfg.train)
    opt_state = init_fn(params)
    if plan is not None:
        plan.opt_specs = shd.opt_state_specs_like(opt_state, params,
                                                  plan.specs, plan.mesh)
    return TrainState(params=params, opt_state=opt_state,
                      ef=init_ef_state(params, run_cfg.train.grad_compress),
                      step=0)


def _classification_ce(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[:, None])[:, 0]
    return _batch_mean(lse - ll)


def _batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x``; inside a training step on a mesh the global
    batch's (the sum and the count added over the layout's batch axes)."""
    lay = train_layout()
    if lay is None or not lay.batch_axes:
        return x.mean()
    from repro_torch.dist.collectives import sum_over
    n = torch.full((), float(x.numel()), device=x.device)
    return sum_over(x.sum(), lay.batch_axes) / sum_over(n, lay.batch_axes)


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
            acc = _batch_mean((logits.argmax(-1)
                               == batch["labels"]).float())
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


# ---------------------------------------------------------------------------
# training on a mesh
# ---------------------------------------------------------------------------

# the families whose attention / MLP / expert blocks run tensor-parallel
# (the hybrid stacks keep every layer weight whole on each rank)
_TP_FAMILIES = ("dense_lm", "moe_lm", "vlm_lm", "audio_lm")


def _owner(names: Tuple[str, ...], cfg: ModelConfig) -> str:
    """The block that reads a leaf, by its path: "experts", "vocab" (the
    embedding table, also the tied head), "head", "attn", "mlp" or
    "other"."""
    nameset = set(names)
    if "experts" in nameset:
        return "experts"
    if "embed" in nameset:
        return "vocab"
    if "lm_head" in nameset:
        return "head"
    if cfg.family in _TP_FAMILIES and "attn" in nameset:
        return "attn"
    if cfg.family in _TP_FAMILIES and nameset & {"mlp", "dense_mlp"}:
        return "mlp"
    return "other"


def _entry_axes(e) -> Tuple[str, ...]:
    return (e,) if isinstance(e, str) else tuple(e or ())


@dataclasses.dataclass
class MeshPlan:
    """How a tree trains on ``mesh``: the param specs (`specs`, a tree of
    `dist.sharding.Spec`), the optimizer state's specs, the training
    layout the forward runs under, and for every leaf path the part of its
    spec to gather before the forward (``gather``: path → `Spec`; the
    forward leaf's gradient is cut back by it)."""
    mesh: Any
    cfg: ModelConfig
    specs: Any
    opt_specs: Any
    layout: TrainLayout
    gather: Dict[str, shd.Spec]

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return self.layout.batch_axes


def plan_mesh(params: Any, run_cfg: RunConfig, mesh,
              fsdp_min_shard_elems: Optional[int] =
              shd.FSDP_MIN_SHARD_ELEMS) -> MeshPlan:
    """The `MeshPlan` of the whole tree ``params`` (the reference's
    ``param_specs`` with the given ZeRO threshold; the reference's dry run
    lowers it to ``1 << 12`` to exercise ZeRO at small widths). Raises
    where a rank's forward leaf would cut a DBB block."""
    cfg = run_cfg.model
    specs = shd.param_specs(params, mesh, cfg,
                            fsdp_min_shard_elems=fsdp_min_shard_elems)
    tp = mesh.shape["model"] if "model" in mesh.axis_names else 1
    keep = set()
    if tp > 1 and cfg.parallel != "dp" and cfg.family != "cnn":
        keep = {"vocab", "head"}
        if cfg.family in _TP_FAMILIES:
            keep |= {"mlp", "experts"}
            if cfg.num_heads % tp == 0:
                keep.add("attn")
    batch_axes = tuple(a for a in data_axes_of(mesh) if mesh.shape[a] > 1)
    if cfg.parallel == "dp" and tp > 1:
        batch_axes += ("model",)
    spec_of = dict(shd._flatten(specs))
    gather, split = {}, set()
    for names, leaf in shd._flatten(params):
        path = "/".join(names)
        owner = _owner(names, cfg)
        entries = list(spec_of.get(names, shd.Spec()))
        for dim, e in enumerate(entries):
            axes = _entry_axes(e)
            if "model" in axes and owner in keep:
                if axes != ("model",):
                    raise ValueError(f"{path}: dim {dim} splits over {axes}; "
                                     "a kept model split must be alone")
                split.add(owner)
                if owner == "vocab" and cfg.tie_embeddings:
                    split.add("head")          # the head is table.T
                _check_blocks(path, leaf, dim, tp, cfg)
                entries[dim] = None
        gather[path] = shd.Spec(*entries)
    layout = TrainLayout(tp=tp, split=frozenset(split),
                         batch_axes=batch_axes)
    return MeshPlan(mesh=mesh, cfg=cfg, specs=specs, opt_specs=None,
                    layout=layout, gather=gather)


def _check_blocks(path: str, leaf, dim: int, tp: int,
                  cfg: ModelConfig) -> None:
    """A model split of a DBB-projected leaf's K axis keeps whole blocks."""
    from repro_torch.core.sparsity import packable
    if (cfg.dbb.enabled and dim == leaf.ndim - 2
            and packable(path, leaf, cfg.dbb)
            and (leaf.shape[dim] // tp) % cfg.dbb.block):
        raise ValueError(f"{path}: K {leaf.shape[dim]} over a model axis of "
                         f"{tp} cuts the DBB blocks of {cfg.dbb.block}")


def rank_batch(batch: Dict, plan: MeshPlan, microbatches: int = 1) -> Dict:
    """This rank's rows of the global ``batch`` (tensors or arrays
    ``[B, ...]``), as tensors: its block (`dist.mesh_ctx.shard_hint` under
    `dist.sharding.batch_specs`) of each of the ``microbatches`` global
    microbatches, microbatch-major, as the reference splits a microbatch
    over the batch axes. A microbatch that the batch axes do not divide
    raises (the specs would replicate it)."""
    axes = plan.batch_axes
    mesh = plan.mesh
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        spec = shd.batch_specs(plan.cfg, mesh, b // microbatches,
                               v.shape[1] if v.ndim > 1 else 1)[k]
        got = tuple(a for a in _entry_axes(spec[0])
                    if mesh.shape[a] > 1) + (("model",) if "model" in axes
                                             else ())
        if b % microbatches or got != axes:
            raise ValueError(f"batch {b} does not split into {microbatches} "
                             f"microbatches over {axes}")
        with use_mesh(mesh):
            parts = [shard_hint(c, axes)
                     for c in torch.as_tensor(v).chunk(microbatches)]
        out[k] = torch.cat(parts) if microbatches > 1 else parts[0]
    return out


def _gather_leaf(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The leaf whole along the axes of ``spec`` (the inverse of
    `dist.sharding.shard_tree`; the first axis of a tuple is the major
    one, so the minor is gathered first)."""
    for dim, e in enumerate(tuple(spec)):
        for a in reversed(_entry_axes(e)):
            if mesh.shape[a] > 1:
                t = all_gather(t, a, dim=dim)
    return t


def _sum_grads(grads: Dict[str, torch.Tensor], axes, mesh) -> None:
    """Every gradient summed over ``axes`` in place of itself: one
    all-reduce per axis of all of them, flattened by dtype."""
    if not axes:
        return
    by_dtype: Dict[torch.dtype, List[str]] = {}
    for k, g in grads.items():
        by_dtype.setdefault(g.dtype, []).append(k)
    for keys in by_dtype.values():
        flat = torch.cat([grads[k].reshape(-1) for k in keys])
        for a in axes:
            if mesh.shape[a] > 1:
                flat = all_reduce(flat, a)
        off = 0
        for k in keys:
            n = grads[k].numel()
            grads[k] = flat[off:off + n].view_as(grads[k])
            off += n


def _mesh_grads_of(plan: MeshPlan, grads_of):
    """``grads_of(params, batch)`` on a mesh: the forward leaves gathered
    (no gradient), DBB-projected at ``nnz``, the loss differentiated at
    them under the layout, each gradient summed over the batch axes and
    cut back to the rank's block."""
    mesh, cfg = plan.mesh, plan.cfg

    def run(params, batch, nnz):
        with torch.no_grad():
            fwd = map_with_path(
                lambda p, t: (_gather_leaf(t, plan.gather[p], mesh)
                              if isinstance(t, torch.Tensor) else t), params)
        fwd = apply_dbb_to_tree(fwd, cfg.dbb, nnz=nnz,
                                straight_through=False)
        with use_train_layout(plan.layout):
            grads, metrics = grads_of(fwd, batch)
        del fwd
        with torch.no_grad():
            flat = {}
            map_with_path(lambda p, g: flat.__setitem__(p, g), grads)
            _sum_grads(flat, plan.batch_axes, mesh)
            grads = map_with_path(
                lambda p, g: shd.shard_tree(flat[p], plan.gather[p], mesh),
                grads)
        return grads, metrics

    return run


def make_train_step(run_cfg: RunConfig, nnz: Optional[int] = None,
                    plan: Optional[MeshPlan] = None
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """``train_step(state, batch) -> (new state, metrics)`` at density
    bound ``nnz`` (None: the config's). Metrics are device scalars: the
    loss terms, ``grad_norm`` (before clipping) and ``lr``. With ``plan``
    (`plan_mesh`) the step runs on the rank's shards of ``state`` and its
    rows of the batch (`rank_batch`), and its metrics are the global
    batch's, equal on every rank."""
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

    mesh_grads = None if plan is None else _mesh_grads_of(plan, grads_of)

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        if plan is None:
            p_eff = apply_dbb_to_tree(state.params, cfg.dbb, nnz=nnz,
                                      straight_through=False)
            grads, metrics = grads_of(p_eff, batch)
            del p_eff
        else:
            grads, metrics = mesh_grads(state.params, batch, nnz)
        # a mesh step's reductions read the specs (one device: no kwarg)
        kw = {} if plan is None else {"specs": plan.specs}
        with torch.no_grad():
            grads, gnorm = opt_mod.clip_by_global_norm(
                grads, tcfg.grad_clip, **kw)
            grads, new_ef = compress_grads(grads, state.ef,
                                           tcfg.grad_compress, **kw)
            updates, new_opt = update_fn(grads, state.opt_state,
                                         state.params, state.step, **kw)
            del grads
            new_params = tree_map(
                lambda p, u: (p.float() + u.float()).to(p.dtype),
                state.params, updates)
        metrics = dict(metrics, grad_norm=gnorm, lr=sched(state.step))
        return TrainState(params=new_params, opt_state=new_opt, ef=new_ef,
                          step=state.step + 1), metrics

    if plan is None:
        return train_step

    def mesh_step(state, batch):
        with use_mesh(plan.mesh):
            return train_step(state, batch)
    return mesh_step


def shard_state(full: TrainState, plan: MeshPlan, device) -> TrainState:
    """This rank's `TrainState` from a whole one (params, optimizer state
    and error feedback cut by the plan's specs, moved to ``device``)."""
    mesh = plan.mesh

    def cut(tree, specs):
        if tree is None:
            return None
        return tree_map(lambda t: t.to(device), shd.shard_tree(
            tree, specs, mesh))
    return TrainState(params=cut(full.params, plan.specs),
                      opt_state=cut(full.opt_state, plan.opt_specs),
                      ef=cut(full.ef, plan.specs), step=full.step)


def _gather_leaf_host(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """`_gather_leaf` on the CPU: gloo's all-gather of host copies moves
    each rank's block once (the device path's zero-filled all-reduce, a
    whole leaf a rank through the host, is what gloo offers CUDA
    tensors)."""
    import torch.distributed as dist
    t = t.detach().cpu()
    for dim, e in enumerate(tuple(spec)):
        for a in reversed(_entry_axes(e)):
            if mesh.shape[a] > 1:
                parts = [torch.empty_like(t) for _ in range(mesh.shape[a])]
                dist.all_gather(parts, t.contiguous(), group=mesh.groups[a])
                t = torch.cat(parts, dim=dim)
    return t


def gather_state(state: TrainState, plan: MeshPlan,
                 params_only: bool = False) -> TrainState:
    """The whole `TrainState` from the ranks' shards, on the CPU (every rank
    takes part; every rank gets it), leaf by leaf; with ``params_only`` the
    params alone (no optimizer state or error feedback). Under gloo the
    blocks meet on the host; under NCCL on the device, one whole leaf at a
    time."""
    mesh = plan.mesh

    def leaf(t, sp):
        if mesh.backend == "gloo":
            return _gather_leaf_host(t, sp, mesh)
        return _gather_leaf(t, sp, mesh).cpu()

    def whole(tree, specs):
        if tree is None:
            return None
        return tree_map(leaf, tree, specs)
    with torch.no_grad(), use_mesh(mesh):
        if params_only:
            return TrainState(params=whole(state.params, plan.specs),
                              opt_state=None, ef=None, step=state.step)
        return TrainState(params=whole(state.params, plan.specs),
                          opt_state=whole(state.opt_state, plan.opt_specs),
                          ef=whole(state.ef, plan.specs), step=state.step)


def make_eval_step(run_cfg: RunConfig, nnz: Optional[int] = None):
    """``eval_step(params, batch) -> metrics`` without gradients, on the
    params projected at ``nnz`` (the plain route)."""
    loss_fn = make_loss_fn(run_cfg.model, nnz=nnz)

    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = loss_fn(params, batch)
        return metrics

    return eval_step
