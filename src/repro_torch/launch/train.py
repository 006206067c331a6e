"""Training CLI: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port's counterpart of ``repro.launch.train``, with its flags, names
and defaults: config → synthetic data pipeline → DBB-annealed train loop →
checkpoints → fault tolerance, logging one JSON metric line every
``log_every`` steps (and on every straggler) and, for a DBB model, the
sparsity report at the end. ``--mesh`` other than ``none`` exits:
training with tensor parallelism is not ported (serving is:
`serve.engine`).

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
import time
from typing import Dict, Optional

import torch

from repro_torch.config import DbbConfig, RunConfig, ShapeSpec, TrainConfig
from repro_torch.configs import get_config
from repro_torch.core.sparsity import dbb_schedule_nnz, tree_sparsity_report
from repro_torch.data.pipeline import make_pipeline
from repro_torch.device import resolve_device
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import (PreemptionGuard,
                                               StragglerMonitor, retry_step)
from repro_torch.train.loop import init_train_state, make_train_step

__all__ = ["train_loop", "main", "build_parser"]


def train_loop(run_cfg: RunConfig, shape: ShapeSpec, log=print,
               host_index: int = 0, host_count: int = 1, *,
               device="cuda", params: Optional[Dict] = None):
    """(final `TrainState`, list of logged metric dicts). ``params``: the
    initial weights (default: `init_params` from ``train.seed``); a
    checkpoint under ``train.checkpoint_dir`` takes precedence."""
    dev = resolve_device(device)
    cfg = run_cfg.model
    tcfg = run_cfg.train
    pipe = make_pipeline(cfg, shape, seed=tcfg.seed, host_index=host_index,
                         host_count=host_count)
    mgr = (ckpt.CheckpointManager(tcfg.checkpoint_dir, tcfg.checkpoint_every)
           if tcfg.checkpoint_dir else None)
    monitor = StragglerMonitor()
    history = []

    state = init_train_state(run_cfg, device=dev, params=params)
    if mgr is not None and ckpt.latest_step(tcfg.checkpoint_dir) is not None:
        state, meta = ckpt.restore(tcfg.checkpoint_dir, state)
        log(f"resumed from step {meta['step']}")

    step_fns = {}

    def step_fn_for(nnz: Optional[int]):
        if nnz not in step_fns:
            step_fns[nnz] = make_train_step(run_cfg, nnz=nnz)
        return step_fns[nnz]

    with PreemptionGuard() as guard:
        for step in range(state.step, tcfg.steps):
            t0 = time.perf_counter()
            nnz = dbb_schedule_nnz(cfg.dbb, step, tcfg.dbb_prune_start,
                                   tcfg.dbb_prune_ramp)
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipe.batch_at(step).items()}
            fn = step_fn_for(nnz if cfg.dbb.enabled else None)
            state, metrics = retry_step(lambda: fn(state, batch))
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
            if mgr is not None and state.step < tcfg.steps:
                mgr.maybe_save(state.step, state, {"dt": dt})
            if guard.should_stop:
                log("preemption signal: emergency checkpoint")
                if mgr is not None:
                    mgr.maybe_save(state.step, state, {"preempted": True},
                                   force=True)
                break
    if mgr is not None and state.step == tcfg.steps:
        mgr.maybe_save(state.step, state, force=True)
    if monitor.straggler_steps:
        log(f"stragglers flagged: {monitor.straggler_steps} "
            f"(mean step {monitor.mean_step_time:.3f}s)")
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


def main(argv=None, *, device=None, log=print,
         report: Optional[dict] = None) -> int:
    """Run the CLI on ``argv``, on ``device`` (default ``"cuda"``), logging
    through ``log``. ``report``, when given, receives the run's config,
    final state and metric history."""
    args = build_parser().parse_args(argv)
    if args.mesh != "none":
        raise SystemExit(f"--mesh {args.mesh}: training with tensor "
                         "parallelism is not ported yet (ROADMAP.md, Queue "
                         "1, item 3); the port trains on one device "
                         "(--mesh none)")
    dev = resolve_device("cuda" if device is None else device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.dense:
        cfg = cfg.replace(dbb=DbbConfig(enabled=False))
    run_cfg = RunConfig(model=cfg, train=TrainConfig(
        steps=args.steps, learning_rate=args.lr, optimizer=args.optimizer,
        microbatches=args.microbatches, grad_compress=args.grad_compress,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, seed=args.seed,
        dbb_prune_ramp=args.dbb_ramp))
    shape = ShapeSpec("cli", args.seq_len, args.batch, "train")
    state, history = train_loop(run_cfg, shape, log=log, device=dev)
    if cfg.dbb.enabled:
        rep = tree_sparsity_report(state.params, cfg.dbb)
        nz = {k: round(v, 3) for k, v in list(rep.items())[:5]}
        log("sparsity (first 5 leaves): " + json.dumps(nz))
    if report is not None:
        report.update(cfg=cfg, run_cfg=run_cfg, state=state,
                      history=history)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
