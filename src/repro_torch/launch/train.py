"""Training CLI: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port's counterpart of ``repro.launch.train``, with its flags, names
and defaults: config → synthetic data pipeline → (optional) mesh →
DBB-annealed train loop → checkpoints → fault tolerance, logging one JSON
metric line every ``log_every`` steps (and on every straggler) and, for a
DBB model, the sparsity report at the end.

``--mesh dxm`` trains on a ``data × model`` mesh of d·m ranks, one process
each (`train.loop`: TP and sequence parallelism over "model", ZeRO and
data parallelism over "data"). Under ``torchrun`` (the ``env://``
variables set) the process is one rank of the world torchrun made;
otherwise it spawns its d·m ranks itself (the ``spawn`` start method, a
``file://`` store in a temporary directory) and waits for them. The
backend is NCCL where every rank has its own card, gloo otherwise (the
CPU, or ranks sharing one card: NCCL refuses two ranks on one device).
The first line logged names the mesh and the backend. A rank that raises
fails the world and the run; nothing falls back to one device. Every rank
reads the same global batch and keeps its rows; the metrics are the
global batch's, logged by rank 0, and a checkpoint holds the whole state
(gathered, rank 0 writing), so it restores on any mesh or on one device.

A checkpoint is named by the number of steps it holds (``state.step``),
so resuming from any of them, periodic, final or emergency, continues
with the next unseen batch. (The reference names a periodic or emergency
save by the index of the step just run, one less, so a resume from one
repeats that step's batch.)

``dt`` in the metric lines is the step's wall time up to a device
synchronise: the batch's copy, the projection, forward, backward and the
update, not only their enqueueing.

Runs on the card; ``main(argv, device="cpu")`` runs on the CPU, as the
tests do. With no card and no ``device``, it fails.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional

import torch

from repro_torch.config import DbbConfig, RunConfig, ShapeSpec, TrainConfig
from repro_torch.configs import get_config
from repro_torch.core.sparsity import dbb_schedule_nnz, tree_sparsity_report
from repro_torch.data.pipeline import make_pipeline
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import FSDP_MIN_SHARD_ELEMS
from repro_torch.models import registry
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import (PreemptionGuard,
                                               StragglerMonitor, retry_step)
from repro_torch.train.loop import (gather_state,
                                    init_train_state, make_train_step,
                                    plan_mesh, rank_batch, shard_state)
from repro_torch.train.tree import tree_map

__all__ = ["train_loop", "main", "build_parser"]


def train_loop(run_cfg: RunConfig, shape: ShapeSpec, log=print,
               host_index: int = 0, host_count: int = 1, *,
               device="cuda", params: Optional[Dict] = None, mesh=None,
               fsdp_min_shard_elems: Optional[int] = FSDP_MIN_SHARD_ELEMS,
               gather: bool = False):
    """(final `TrainState`, list of logged metric dicts). ``params``: the
    initial weights (default: `init_params` from ``train.seed``); a
    checkpoint under ``train.checkpoint_dir`` takes precedence.

    With ``mesh`` (`dist.mesh_ctx.make_mesh`) every rank of the mesh runs
    this with the same arguments: the state returned is this rank's
    shards, or with ``gather`` the whole params alone on the CPU
    (`train.loop.gather_state`), the history the global batch's.
    ``fsdp_min_shard_elems``: the ZeRO threshold of the param specs."""
    dev = resolve_device(device)
    cfg = run_cfg.model
    tcfg = run_cfg.train
    pipe = make_pipeline(cfg, shape, seed=tcfg.seed, host_index=host_index,
                         host_count=host_count)
    mgr = (ckpt.CheckpointManager(tcfg.checkpoint_dir, tcfg.checkpoint_every)
           if tcfg.checkpoint_dir else None)
    monitor = StragglerMonitor()
    history = []

    plan = None
    if mesh is None:
        state = init_train_state(run_cfg, device=dev, params=params)
    else:
        if params is None:
            params = registry.init_params(cfg, seed=tcfg.seed, device=dev)
        plan = plan_mesh(params, run_cfg, mesh, fsdp_min_shard_elems)
        state = init_train_state(run_cfg, device=dev, params=params,
                                 plan=plan)
    if mgr is not None and ckpt.latest_step(tcfg.checkpoint_dir) is not None:
        if plan is None:
            state, meta = ckpt.restore(tcfg.checkpoint_dir, state)
        else:
            # the whole state, on the CPU, then this rank's shards
            template = init_train_state(
                run_cfg, device="cpu",
                params=tree_map(lambda t: t.cpu(), params))
            full, meta = ckpt.restore(tcfg.checkpoint_dir, template)
            state = shard_state(full, plan, dev)
            del template, full
        log(f"resumed from step {meta['step']}")
    params = None

    def save(step: int, extra: dict, force: bool = False) -> None:
        if mgr is None or not mgr.due(step, force):
            return
        whole = state if plan is None else gather_state(state, plan)
        mgr.maybe_save(step, whole, extra, force=force)

    step_fns = {}

    def step_fn_for(nnz: Optional[int]):
        if nnz not in step_fns:
            step_fns[nnz] = make_train_step(run_cfg, nnz=nnz, plan=plan)
        return step_fns[nnz]

    def stop_now(flag: bool) -> bool:
        """The preemption flag of any rank (every rank stops together)."""
        if plan is None:
            return flag
        from repro_torch.dist.collectives import reduce_max
        from repro_torch.dist.mesh_ctx import use_mesh
        with use_mesh(mesh):
            return bool(reduce_max(torch.tensor([float(flag)], device=dev),
                                   mesh.axis_names).item())

    with PreemptionGuard() as guard:
        for step in range(state.step, tcfg.steps):
            t0 = time.perf_counter()
            nnz = dbb_schedule_nnz(cfg.dbb, step, tcfg.dbb_prune_start,
                                   tcfg.dbb_prune_ramp)
            host = pipe.batch_at(step)
            if plan is not None:
                host = rank_batch(host, plan, tcfg.microbatches)
            batch = {k: torch.as_tensor(v).to(dev) for k, v in host.items()}
            fn = step_fn_for(nnz if cfg.dbb.enabled else None)
            if plan is None:
                state, metrics = retry_step(lambda: fn(state, batch))
            else:       # a retry on one rank would desert the others
                state, metrics = fn(state, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            straggler = monitor.update(step, dt)
            if step % max(tcfg.log_every, 1) == 0 or straggler:
                # the reference's jitted step returns its dict keys sorted
                m = {k: float(metrics[k]) for k in sorted(metrics)}
                m.update(step=step, dt=round(dt, 3), nnz=nnz,
                         straggler=straggler)
                history.append(m)
                log(json.dumps(m))
            if state.step < tcfg.steps:
                save(state.step, {"dt": dt})
            if stop_now(guard.should_stop):
                log("preemption signal: emergency checkpoint")
                save(state.step, {"preempted": True}, force=True)
                break
    if state.step == tcfg.steps:
        save(state.step, {}, force=True)
    if monitor.straggler_steps:
        log(f"stragglers flagged: {monitor.straggler_steps} "
            f"(mean step {monitor.mean_step_time:.3f}s)")
    if plan is not None and gather:
        state = gather_state(state, plan, params_only=True)
    return state, history


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="DBB-annealed training of a registered arch on "
                    "synthetic data")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", default="none")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--dense", action="store_true", help="disable DBB")
    ap.add_argument("--dbb-ramp", type=int, default=0)
    ap.add_argument("--mesh", default="none",
                    help="none | dxm (e.g. 2x4) virtual mesh")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _run_cfg(args) -> RunConfig:
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.dense:
        cfg = cfg.replace(dbb=DbbConfig(enabled=False))
    return RunConfig(model=cfg, train=TrainConfig(
        steps=args.steps, learning_rate=args.lr, optimizer=args.optimizer,
        microbatches=args.microbatches, grad_compress=args.grad_compress,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, seed=args.seed,
        dbb_prune_ramp=args.dbb_ramp))


def _sparsity_line(cfg, params) -> str:
    rep = tree_sparsity_report(params, cfg.dbb)
    nz = {k: round(v, 3) for k, v in list(rep.items())[:5]}
    return "sparsity (first 5 leaves): " + json.dumps(nz)


def _mesh_shape(spec: str):
    try:
        d, m = (int(x) for x in spec.split("x"))
    except ValueError:
        raise SystemExit(f"--mesh {spec!r}: expected none or DxM, e.g. 2x2")
    if d < 1 or m < 1:
        raise SystemExit(f"--mesh {spec!r}: axis sizes must be positive")
    return d, m


def _backend(dev: torch.device, ranks_here: int) -> str:
    """NCCL when every rank on this host has a card of its own, gloo
    otherwise (the CPU, or ranks that share a card)."""
    if dev.type == "cuda" and torch.cuda.device_count() >= ranks_here:
        return "nccl"
    return "gloo"


def _rank_device(dev: torch.device, backend: str, local_rank: int):
    if dev.type != "cuda":
        return dev
    out = torch.device("cuda", local_rank if backend == "nccl" else
                       (dev.index or 0))
    torch.cuda.set_device(out)
    return out


def _mesh_rank_run(args, dev, backend, log) -> dict:
    """This process's part of a mesh run (its process group initialised):
    train, and make the sparsity report from the gathered masters."""
    from repro_torch.dist.mesh_ctx import make_mesh, use_mesh
    d, m = _mesh_shape(args.mesh)
    mesh = make_mesh(d, m, backend=backend)
    run_cfg = _run_cfg(args)
    cfg = run_cfg.model
    shape = ShapeSpec("cli", args.seq_len, args.batch, "train")
    with use_mesh(mesh):
        state, history = train_loop(run_cfg, shape, log=log, device=dev,
                                    mesh=mesh, gather=cfg.dbb.enabled)
    if cfg.dbb.enabled:
        log(_sparsity_line(cfg, state.params))
    return {"history": history}


def _spawned_rank(rank, world, store, args, dev_str, backend, q):
    """One spawned rank of `main`'s mesh run; its result (rank 0's log
    lines and history) or its traceback goes to ``q``."""
    import traceback
    lines = []
    try:
        import torch.distributed as dist
        dev = torch.device(dev_str)
        if dev.type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dev = _rank_device(dev, backend, rank)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world)
        out = _mesh_rank_run(args, dev, backend,
                             lines.append if rank == 0 else (lambda _: None))
        dist.barrier()
        dist.destroy_process_group()
        q.put(dict(out, rank=rank, lines=lines))
    except BaseException:                               # noqa: BLE001
        q.put({"rank": rank, "lines": lines,
               "error": traceback.format_exc()})


def _spawn_mesh(args, dev: torch.device, log) -> dict:
    """Start the d·m ranks of ``--mesh`` as spawned processes and wait
    for them; a rank's error (or one gone without a result) terminates
    the others and raises."""
    import queue as queue_mod
    import tempfile
    d, m = _mesh_shape(args.mesh)
    world = d * m
    backend = _backend(dev, world)
    where = (f"{world} ranks sharing {dev}" if backend == "gloo"
             else "one card per rank")
    log(f"mesh {d}x{m} (data x model): {where}, backend {backend}")
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_spawned_rank, daemon=True,
                             args=(r, world, store, args, str(dev), backend,
                                   q)) for r in range(world)]
        for p in procs:
            p.start()
        got = []
        try:
            while len(got) < world:
                try:
                    got.append(q.get(timeout=2))
                    if "error" in got[-1]:
                        break
                    continue
                except queue_mod.Empty:
                    pass
                dead = [p.exitcode for p in procs
                        if not p.is_alive() and p.exitcode]
                if dead:
                    got.append({"rank": -1, "lines": [], "error":
                                f"a rank exited with code {dead[0]} and no "
                                "result"})
                    break
        finally:
            errs = [g for g in got if "error" in g]
            for p in procs:        # a failed world's others may be stuck
                p.join(timeout=0 if errs or len(got) < world else 60)
                if p.is_alive():
                    p.terminate()
                    p.join()
    if errs:
        raise RuntimeError(f"rank {errs[0]['rank']} of the {d}x{m} mesh "
                           f"failed:\n{errs[0]['error']}")
    first = next(g for g in got if g["rank"] == 0)
    for line in first["lines"]:
        log(line)
    return dict(first, backend=backend)


def _torchrun_mesh(args, dev: torch.device, log) -> dict:
    """This process as one rank of the world ``torchrun`` set up (the
    ``env://`` variables)."""
    import torch.distributed as dist
    d, m = _mesh_shape(args.mesh)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    backend = _backend(dev, local_world)
    dev = _rank_device(dev, backend, int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend, init_method="env://")
    rank = dist.get_rank()
    if rank:
        log = lambda _: None                            # noqa: E731
    log(f"mesh {d}x{m} (data x model): torchrun world of "
        f"{dist.get_world_size()}, backend {backend}")
    try:
        out = _mesh_rank_run(args, dev, backend, log)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return dict(out, backend=backend)


def main(argv=None, *, device=None, log=print,
         report: Optional[dict] = None) -> int:
    """Run the CLI on ``argv``, on ``device`` (default ``"cuda"``), logging
    through ``log``. ``report``, when given, receives the run's config and
    metric history, and the final state of a run on one device."""
    args = build_parser().parse_args(argv)
    dev = resolve_device("cuda" if device is None else device)
    run_cfg = _run_cfg(args)
    cfg = run_cfg.model
    if args.mesh != "none":
        _mesh_shape(args.mesh)
        torchrun = all(k in os.environ for k in
                       ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))
        out = (_torchrun_mesh if torchrun else _spawn_mesh)(args, dev, log)
        if report is not None:
            report.update(cfg=cfg, run_cfg=run_cfg, state=None,
                          history=out["history"], backend=out["backend"])
        return 0
    shape = ShapeSpec("cli", args.seq_len, args.batch, "train")
    state, history = train_loop(run_cfg, shape, log=log, device=dev)
    if cfg.dbb.enabled:
        log(_sparsity_line(cfg, state.params))
    if report is not None:
        report.update(cfg=cfg, run_cfg=run_cfg, state=state,
                      history=history)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
