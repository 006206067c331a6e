#!/usr/bin/env python3
"""olmo-1b training on a mesh of gloo ranks that share one CUDA card: two
questions that chip_smoke.py's ``tp_train`` phase raises.

    python scripts/torch_mesh_train_probe.py [first] [pinned] [cold] \
        [cli[:DTYPE]]

``first``: where a process's first full-width train step spends its time.
olmo-1b at full width cut to 2 layers, f32, B8 S256, AdamW, DBB 8 -> 4
over 3 steps (the phase's config). On one device in this process and on
a 1 x 2 mesh of two spawned ranks, each first warmed up as the phase
warms its ranks (one smoke-width step): the init's seconds, each step's
ms (the ranks meet at a barrier before each step, whose wait is printed
apart) and the top events by self CPU time of steps 0 and 1
(torch.profiler, CPU and CUDA). Then a second 1 x 2 world warmed up at
the phase's own shapes (1 layer at full width, B8 S256, a step at each
bound of the ramp): its steps' ms.

``pinned``: what a first transfer of a size costs. In this process,
``torch.empty(..., pin_memory=True)`` of 16, 64 and 256 MiB: a fresh
allocation (another block of that size still held), then one from the
freed cache. On two spawned gloo ranks: three all-reduces of a CUDA
tensor of each size (gloo stages a CUDA tensor through pinned host
memory), and of a CPU tensor of 64 MiB, each between barriers, in ms.

``cold``: the first step's cost on one device, each case in a fresh
process: as it is (CUDA's lazy module loading, the default), with
``CUDA_MODULE_LOADING=EAGER`` (every module loaded with the context), and
lazy after a sweep of ``torch.mm`` at the step's f32 GEMM shapes (the
forward's and both backward products of each projection and the tied
head, M = 2048 tokens), each product timed at its first and second call,
and lazy after ``import torch._dynamo`` (which the first call of
``torch.utils.checkpoint.checkpoint``, the layers' activation
checkpointing at d_model >= 1024, makes): the context's seconds, the
sweep's or the import's, and steps 0-2 in ms. ``cold:CASE`` runs one.

``cli``: the training CLI on a 2 x 2 mesh (4 torchrun-style ranks, each
running ``launch.train.main`` in its own process; gloo) against
``--mesh none``, olmo-1b cut to 2 layers, B8 S256, 2 steps of the CLI's
AdamW (lr 3e-4, 10 warm-up steps) with a checkpoint after each and a
metric line every step, once at the config's bf16 activations and once
at f32 (``cli:bfloat16`` or ``cli:float32`` runs one): per step both
losses, grad norms and step times (``dt``), and for the params after
each step max |diff|, the update's relative error ``||Δmesh - Δone|| /
||Δone||`` (Δ from the initial tree) and the count of elements whose two
updates differ by more than that step's lr (an AdamW step moves an
element by about lr, so such an element moved the other way on the
mesh).

Prints the card's name and power limit first. Builds no kernel: training
launches none.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

LAYERS, SEQ, BATCH, STEPS = 2, 256, 8, 3
CLI_STEPS = 2


def say(msg: str) -> None:
    print(msg, flush=True)


def _setup(torch):
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.zeros(1, device=dev)
    return dev


def _warm_shapes(torch, dev, mesh):
    """A step at each bound of the ramp on olmo-1b at full width, 1 layer,
    B8 S256 (the phase's shapes), discarded."""
    import chip_smoke as cs
    from repro_torch.models import registry
    from repro_torch.train.loop import (init_train_state, make_train_step,
                                        plan_mesh, rank_batch)
    cfg, rc, pipe, nnz = cs._tp_train_job("olmo-1b", STEPS)
    cfg = cfg.replace(num_layers=1)
    rc = cs._tp_train_runcfg(cfg)
    params = registry.init_params(cfg, seed=1, device=dev)
    plan = plan_mesh(params, rc, mesh) if mesh is not None else None
    state = init_train_state(rc, device=dev, params=params, plan=plan)
    del params
    for s in range(STEPS):
        host = pipe.batch_at(s)
        if plan is not None:
            host = rank_batch(host, plan)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in host.items()}
        state, _ = make_train_step(rc, nnz=nnz[s], plan=plan)(state, batch)
    torch.cuda.synchronize(dev)


def _steps(torch, dev, mesh, profiled):
    """The phase's olmo-1b run: (init s, [(step, barrier ms, step ms)],
    {step: profile table})."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.models import registry
    from repro_torch.train.loop import (init_train_state, make_train_step,
                                        plan_mesh, rank_batch)
    cfg, rc, pipe, nnz = cs._tp_train_job("olmo-1b", STEPS)
    t0 = time.perf_counter()
    params = registry.init_params(cfg, seed=0, device=dev)
    plan = plan_mesh(params, rc, mesh) if mesh is not None else None
    state = init_train_state(rc, device=dev, params=params, plan=plan)
    del params
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    rows, tables = [], {}
    for s in range(STEPS):
        fn = make_train_step(rc, nnz=nnz[s], plan=plan)
        host = pipe.batch_at(s)
        if plan is not None:
            host = rank_batch(host, plan)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in host.items()}
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if mesh is not None:
            dist.barrier()
        wait = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        if profiled and s < 2:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                state, _ = fn(state, batch)
                torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) * 1e3
            tables[s] = prof.key_averages().table(
                sort_by="self_cpu_time_total", row_limit=14,
                max_name_column_width=48)
        else:
            state, _ = fn(state, batch)
            torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) * 1e3
        rows.append((s, wait, ms))
    return init_s, rows, tables


def _first_rank(rank, world, store, warm, q):
    import traceback
    try:
        import torch
        import torch.distributed as dist
        dev = _setup(torch)
        from repro_torch.dist.mesh_ctx import make_mesh
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        mesh = make_mesh(1, world, backend="gloo")
        t0 = time.perf_counter()
        if warm == "smoke":
            import chip_smoke as cs
            cs._tp_train_warm(torch, mesh, dev)
        else:
            _warm_shapes(torch, dev, mesh)
        warm_s = time.perf_counter() - t0
        init_s, rows, tables = _steps(torch, dev, mesh,
                                      profiled=(rank == 0 and warm == "smoke"))
        dist.barrier()
        dist.destroy_process_group()
        q.put(dict(rank=rank, warm_s=warm_s, init_s=init_s, rows=rows,
                   tables=tables))
    except Exception:                                   # noqa: BLE001
        q.put(dict(rank=rank, error=traceback.format_exc()))


def _world(torch, target, world, *args, timeout=600):
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=target, daemon=True,
                             args=(r, world, os.path.join(tmp, "store"))
                             + args + (q,)) for r in range(world)]
        for p in procs:
            p.start()
        got = [q.get(timeout=timeout) for _ in procs]
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
    for g in got:
        if "error" in g:
            raise RuntimeError(f"rank {g['rank']}:\n{g['error']}")
    return sorted(got, key=lambda g: g["rank"])


def _say_rows(name, init_s, rows):
    say(f"{name}: init {init_s:.2f} s; " + "; ".join(
        f"step {s}: barrier wait {w:.1f} ms, step {ms:.1f} ms"
        for s, w, ms in rows))


def _pinned_rank(rank, world, store, q):
    import traceback
    try:
        import torch
        import torch.distributed as dist
        dev = _setup(torch)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        out = {}
        for where, mib in (("cuda", 16), ("cuda", 64), ("cuda", 256),
                           ("cpu", 64)):
            x = torch.ones(mib << 18, device=dev if where == "cuda" else "cpu")
            times = []
            for _ in range(3):
                dist.barrier()
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                dist.all_reduce(x)
                torch.cuda.synchronize(dev)
                times.append((time.perf_counter() - t0) * 1e3)
            out[f"{where} {mib} MiB"] = times
        dist.barrier()
        dist.destroy_process_group()
        q.put(dict(rank=rank, times=out))
    except Exception:                                   # noqa: BLE001
        q.put(dict(rank=rank, error=traceback.format_exc()))


def pinned(torch) -> None:
    _setup(torch)
    for mib in (16, 64, 256):
        n = mib << 18
        t0 = time.perf_counter()
        a = torch.empty(n, pin_memory=True)
        t1 = time.perf_counter()
        b = torch.empty(n, pin_memory=True)
        t2 = time.perf_counter()
        del a, b
        t3 = time.perf_counter()
        c = torch.empty(n, pin_memory=True)
        t4 = time.perf_counter()
        del c
        say(f"pinned {mib} MiB: first {(t1 - t0) * 1e3:.1f} ms, a second "
            f"while the first is held {(t2 - t1) * 1e3:.1f} ms, from the "
            f"cache {(t4 - t3) * 1e3:.3f} ms")
    for r in _world(torch, _pinned_rank, 2):
        say(f"gloo all-reduce, rank {r['rank']}: " + "; ".join(
            f"{k}: " + ", ".join(f"{t:.1f}" for t in v) + " ms"
            for k, v in r["times"].items()))


# (M, K, N) of the step's projections on one device: q/k/v/o, wi/wg, wo,
# the tied head
GEMMS = ((2048, 2048, 2048), (2048, 2048, 8192), (2048, 8192, 2048),
         (2048, 2048, 50304))


def _gemm_sweep(torch, dev):
    """(first calls' ms, second calls' ms, products) over GEMMS: y = x w,
    dx = dy w^T, dw = x^T dy."""
    firsts, seconds, n = 0.0, 0.0, 0
    for m, k, nn in GEMMS:
        x = torch.randn(m, k, device=dev)
        w = torch.randn(k, nn, device=dev)
        dy = torch.randn(m, nn, device=dev)
        for fn in (lambda: x @ w, lambda: dy @ w.t(), lambda: x.t() @ dy):
            for i in range(2):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize(dev)
                ms = (time.perf_counter() - t0) * 1e3
                if i == 0:
                    firsts += ms
                else:
                    seconds += ms
            n += 1
    return firsts, seconds, n


def _cold_case(torch, case) -> None:
    t0 = time.perf_counter()
    dev = _setup(torch)
    ctx_s = time.perf_counter() - t0
    sweep = ""
    if case == "sweep":
        f, sec, n = _gemm_sweep(torch, dev)
        sweep = (f"; {n} products: first calls {f:.1f} ms, second calls "
                 f"{sec:.1f} ms")
    elif case == "dynamo":
        t0 = time.perf_counter()
        import torch._dynamo  # noqa: F401
        sweep = f"; import torch._dynamo {time.perf_counter() - t0:.2f} s"
    init_s, rows, _ = _steps(torch, dev, None, profiled=False)
    print(f"cold {case}: context {ctx_s:.2f} s{sweep}; init {init_s:.2f} s; "
          + "; ".join(f"step {s}: {ms:.1f} ms" for s, _, ms in rows),
          flush=True)


def cold(torch, cases=("lazy", "eager", "sweep", "dynamo")) -> None:
    for case in cases:
        loading = "EAGER" if case == "eager" else "LAZY"
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "_cold", case],
            env=dict(os.environ, CUDA_MODULE_LOADING=loading),
            capture_output=True, text=True, timeout=300)
        say(out.stdout.strip() or out.stderr[-2000:])


def first(torch) -> None:
    dev = _setup(torch)
    torch.set_num_threads(os.cpu_count() or 1)
    init_s, rows, tables = _steps(torch, dev, None, profiled=True)
    _say_rows("one device, cold process (no warm-up)", init_s, rows)
    for s, t in tables.items():
        say(f"one device, step {s} profile:\n{t}")
    for warm in ("smoke", "shapes"):
        ranks = _world(torch, _first_rank, 2, warm)
        for r in ranks:
            say(f"1x2 rank {r['rank']}, warm-up at {warm} "
                f"({r['warm_s']:.2f} s)")
            _say_rows(f"1x2 rank {r['rank']} ({warm})", r["init_s"],
                      r["rows"])
        for s, t in ranks[0]["tables"].items():
            say(f"1x2 rank 0 (smoke warm-up), step {s} profile:\n{t}")


def _cut_config(dtype):
    def get_config(arch, smoke=False):
        from repro_torch.configs import get_config as real
        return real(arch, smoke=smoke).replace(num_layers=LAYERS,
                                               dtype=dtype)
    return get_config


def _patch_cli(ttrain, dtype):
    import dataclasses
    ttrain.get_config = _cut_config(dtype)
    run_cfg = ttrain._run_cfg

    def every_step(args):
        rc = run_cfg(args)
        return dataclasses.replace(rc, train=dataclasses.replace(
            rc.train, log_every=1))
    ttrain._run_cfg = every_step


def _argv(ck, mesh):
    return ["--arch", "olmo-1b", "--full", "--steps", str(CLI_STEPS),
            "--seq-len", str(SEQ), "--batch", str(BATCH),
            "--dbb-ramp", "2", "--checkpoint-every", "1",
            "--checkpoint-dir", ck, "--mesh", mesh]


def _cli_rank(rank, world, store, dtype, ck, port, q):
    import traceback
    try:
        import torch
        _setup(torch)
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                          MASTER_ADDR="localhost", MASTER_PORT=str(port))
        from repro_torch.launch import train as ttrain
        _patch_cli(ttrain, dtype)
        lines, rep = [], {}
        t0 = time.perf_counter()
        ttrain.main(_argv(ck, "2x2"), device="cuda", log=lines.append,
                    report=rep)
        q.put(dict(rank=rank, lines=lines, history=rep.get("history"),
                   wall=time.perf_counter() - t0))
    except Exception:                                   # noqa: BLE001
        q.put(dict(rank=rank, error=traceback.format_exc()))


def cli(torch, dtypes=("bfloat16", "float32")) -> None:
    import socket

    from repro_torch.launch import train as ttrain
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.loop import init_train_state
    from repro_torch.train.tree import tree_leaves
    dev = _setup(torch)
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    for dtype in dtypes:
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            ck_mesh, ck_one = (os.path.join(tmp, n) for n in ("mesh", "one"))
            with socket.socket() as s:
                s.bind(("localhost", 0))
                port = s.getsockname()[1]
            t0 = time.perf_counter()
            ranks = _world(torch, _cli_rank, 4, dtype, ck_mesh, port)
            mesh_s = time.perf_counter() - t0
            _patch_cli(ttrain, dtype)
            rep = {}
            t0 = time.perf_counter()
            ttrain.main(_argv(ck_one, "none"), device="cuda",
                        log=lambda _: None, report=rep)
            one_s = time.perf_counter() - t0
            hm, h1 = ranks[0]["history"], rep["history"]
            say(f"cli {dtype}: 2x2 {mesh_s:.1f} s (main() on the ranks "
                f"{[round(r['wall'], 1) for r in ranks]} s), none "
                f"{one_s:.1f} s; "
                f"first line {ranks[0]['lines'][0]!r}")
            for a, b in zip(hm, h1):
                say(f"cli {dtype}: step {a['step']}: loss {a['loss']!r} vs "
                    f"{b['loss']!r} (rel {abs(a['loss'] - b['loss']) / abs(b['loss']):.3e}); "
                    f"grad_norm {a['grad_norm']!r} vs {b['grad_norm']!r} "
                    f"(rel {abs(a['grad_norm'] - b['grad_norm']) / abs(b['grad_norm']):.3e}); "
                    f"lr {a['lr']!r}; dt {a['dt']} s vs {b['dt']} s")
            rc = ttrain._run_cfg(ttrain.build_parser().parse_args(
                _argv(ck_one, "none")))
            init = init_train_state(rc, device=dev)
            p0 = tree_leaves(init.params)
            for s, h in zip(range(1, CLI_STEPS + 1), h1):
                pm = tree_leaves(ckpt.restore(ck_mesh, init, step=s)[0]
                                 .params)
                po = tree_leaves(ckpt.restore(ck_one, init, step=s)[0]
                                 .params)
                num = sum(float(((a - b).double() ** 2).sum())
                          for a, b in zip(pm, po))
                den = sum(float(((b - c).double() ** 2).sum())
                          for b, c in zip(po, p0))
                worst = max(float((a - b).abs().max())
                            for a, b in zip(pm, po))
                flips = sum(int(((a - b).abs() > h["lr"]).sum())
                            for a, b in zip(pm, po))
                n = sum(t.numel() for t in po)
                say(f"cli {dtype}: params after step {s}: max |diff| "
                    f"{worst:.3e}; update rel err {(num / den) ** 0.5:.3e}; "
                    f"elements apart by > lr {h['lr']:.1e}: {flips} of {n}")
                del pm, po


def main() -> int:
    import torch
    if sys.argv[1:2] == ["_cold"]:          # one case of ``cold``
        _cold_case(torch, sys.argv[2])
        return 0
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    say(card)
    parts = sys.argv[1:] or ["first", "pinned", "cold", "cli"]
    for part in parts:
        t0 = time.perf_counter()
        name, _, dtype = part.partition(":")
        fn = {"first": first, "pinned": pinned, "cold": cold,
              "cli": cli}[name]
        fn(torch, (dtype,)) if dtype else fn(torch)
        say(f"{part}: {time.perf_counter() - t0:.1f} s ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
