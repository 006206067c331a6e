"""Per-step costs of every assigned arch × shape × production mesh, without
a card: the port's counterpart of the reference's dry run
(`repro.launch.dryrun`).

    python -m repro_torch.launch.dryrun --arch olmo-1b --shape decode_32k \\
        --mesh pod --packed                 # one cell, in this process
    python -m repro_torch.launch.dryrun --all --mesh both --jobs 4

The reference lowers a jitted step for 256 or 512 virtual CPU devices and
reads XLA's per-device HLO. Here a cell is one rank's view: the process
initialises a fake world of 256 (pod) or 512 (two pods) ranks
(``torch.distributed``'s "fake" backend: every collective returns at once),
builds the production mesh as rank 0 (`launch.mesh`), cuts this rank's
shard of the state on the ``meta`` device (tensors with shapes and no
storage) and runs one step under `roofline.counts.count_step`:

  * train: `train.loop.make_train_step` on a `plan_mesh` plan, the mesh
    step with its ZeRO gathers and gradient sums;
  * prefill / decode: `serve.engine.make_prefill_step` /
    `make_decode_step` inside the engine's TP wrap (a `ServeEngine` built
    on meta: its own shard of the weights, its head), on the kernel route
    family (``gemm_impl="pallas"``; the kernel wrappers' meta branches
    give their outputs' shapes), with the cache cut by
    `dist.sharding.cache_specs` and, under the wrap, `serve_cache_specs`.

The wrap holds the weights' TP shards only: the port serves no
FSDP-sharded weights, so ``--fsdp`` reads on train cells.

Each cell's record (``<out>/<cell>.json``) keeps the reference's keys:
``memory`` (``argument_size_in_bytes``: the rank's params, optimizer
state, cache and batch; ``output_size_in_bytes`` / ``alias_size_in_bytes``:
what the step returns in new storage / in its inputs' storage;
``temp_size_in_bytes``: the counter's peak of storages the step
created, its new outputs among them), ``hlo_stats`` (the `StepStats`
fields), ``roofline`` (`roofline.analysis.roofline_terms` on
``HW_H100``, the data sheet's figures), ``tokens_per_step``,
``status`` / ``reason`` and ``head_pad``. The step runs on the meta device
by design, as the reference's runs on virtual devices: nothing moves to
the CPU, and a cell that fails is ``status: "error"`` with exit code 1.
With no cell selected, ``--all`` runs every one, a subprocess each.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import SHAPES, shape_applicable
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.dist import sharding as shd
from repro_torch.dist.mesh_ctx import use_mesh
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import (MULTI_POD_SHAPE, POD_SHAPE,
                                     make_production_mesh)
from repro_torch.roofline.analysis import (HW_H100, model_flops_per_step,
                                           roofline_terms)
from repro_torch.roofline.counts import count_step
from repro_torch.train.tree import tree_leaves

__all__ = ["run_cell", "main", "ART_DIR", "step_terms"]

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
ART_DIR = os.path.join(_SRC, "..", "artifacts", "dryrun_torch")
_BACKEND = "fake"


def _cell_id(arch: str, shape: str, mesh: str, packed: bool,
             int8: bool = False) -> str:
    sfx = ("__dbb_int8" if int8 else "__dbb") if packed else ""
    return f"{arch}__{shape}__{mesh}{sfx}"


def _tree_bytes(tree: Any) -> int:
    """Bytes of every tensor of ``tree`` (packed planes too), each counted
    at its own size."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _storages(tree: Any) -> Dict[int, int]:
    return {id(t.untyped_storage()): t.numel() * t.element_size()
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)}


def _init_world(n: int) -> None:
    """This process as rank 0 of a world of ``n`` ranks whose collectives
    return at once (the "fake" backend, which importing ``fake_pg``
    registers)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group(_BACKEND, store=FakeStore(), rank=0,
                            world_size=n)


def step_terms(stats, args: Any, out: Any, *, kind: str, seq_len: int,
               model_flops: float) -> Tuple[Dict[str, int], Any]:
    """(the reference's memory keys, `RooflineTerms` on ``HW_H100``) of one
    rank's step that took ``args`` and returned ``out``, with the
    counter's `StepStats` (module doc). ``model_flops``: the rank's share
    of the published arch's 6·N·D (train) or 2·N·D."""
    ins = _storages(args)
    outs = _storages(out)
    alias = sum(b for k, b in outs.items() if k in ins)
    mem = {"argument_size_in_bytes": _tree_bytes(args),
           "output_size_in_bytes": sum(b for k, b in outs.items()
                                       if k not in ins),
           "temp_size_in_bytes": int(stats.peak_bytes),
           "alias_size_in_bytes": alias}
    mem["total_per_device"] = (mem["argument_size_in_bytes"]
                               + mem["temp_size_in_bytes"])
    # HBM lower bound: read every argument once, write the new outputs,
    # and rewrite the in-place (aliased) ones: wholly on a train or
    # prefill step (the cache fill), one token slice of the cache a decode
    # step
    alias_write = alias / max(seq_len, 1) if kind == "decode" else alias
    io_bytes = (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
                + alias_write)
    return mem, roofline_terms(stats, HW_H100,
                               model_flops_per_device=model_flops,
                               io_bytes_per_device=io_bytes)


def _train_step(cfg, shape, mesh, data_shards: int, fsdp: int):
    """(step, (state, batch), {}) of one rank's train step."""
    from repro_torch.train.loop import make_train_step, plan_mesh, \
        rank_batch, shard_state
    rc = sp.run_config_for(cfg, shape, data_shards=data_shards,
                           model_shards=mesh.shape.get("model", 1))
    whole, spec = sp.train_state_specs(rc, mesh, fsdp=fsdp)
    plan = plan_mesh(whole.params, rc, mesh, fsdp_min_shard_elems=fsdp)
    plan.opt_specs = spec.opt_state
    state = shard_state(whole, plan, sp.META)
    del whole
    batch = rank_batch(sp.train_input_specs(rc.model, shape), plan,
                       rc.train.microbatches)
    return make_train_step(rc, plan=plan), (state, batch), {}


def _serve_step(cfg, shape, mesh, packed: bool, int8: bool):
    """(step, args, kwargs, the engine's TP reason) of one rank's prefill or
    decode
    step: the engine's own shard of the weights and head, the cache cut by
    `cache_specs` (rows) and, under the wrap, `serve_cache_specs` (KV
    heads)."""
    from repro_torch.serve.engine import ServeEngine
    cfg = cfg.replace(gemm_impl="pallas")
    params = sp.serve_params(cfg, packed=packed, int8=int8)
    eng = ServeEngine(cfg=cfg, params=params, device=sp.META)
    del params
    cell = sp.input_specs(cfg, shape, mesh)
    specs = cell["specs"]
    cache = shd.shard_tree(cell["cache"], specs["cache"], mesh)
    if not eng.tp_reason:
        cache = shd.shard_tree(cache, shd.serve_cache_specs(cache, mesh),
                               mesh)
    tokens = shd.shard_tree(cell["tokens"], specs["tokens"], mesh)
    if shape.kind == "decode":
        return eng._decode, (eng.params, eng.head, cache, tokens), {}, \
            eng.tp_reason
    inputs = dict(tokens)                # embeds / prefix_embeds, if any
    return (eng._prefill, (eng.params, eng.head, cache,
                           inputs.pop("tokens", None)), inputs,
            eng.tp_reason)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             packed: bool = False, int8: bool = False,
             fsdp: Optional[int] = None, headpad: bool = True,
             verbose: bool = True) -> Dict[str, Any]:
    """One cell's record (module doc). Initialises, and at the end
    destroys, the fake world of the production mesh."""
    import torch.distributed as dist
    mesh_name = "multipod" if multi_pod else "pod"
    cfg = get_config(arch)
    orig_cfg = cfg          # model flops count the *published* arch only
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "packed": packed, "int8": int8,
        "cell": _cell_id(arch, shape_name, mesh_name, packed, int8),
    }
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec

    mesh_shape = MULTI_POD_SHAPE if multi_pod else POD_SHAPE
    n_dev = 1
    for s in mesh_shape:
        n_dev *= s
    _init_world(n_dev)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, backend=_BACKEND)
        fsdp_elems = fsdp if fsdp is not None else shd.FSDP_MIN_SHARD_ELEMS
        if headpad:
            cfg = sp.pad_attention_heads(cfg, mesh.shape["model"])
            rec["head_pad"] = cfg.num_heads != orig_cfg.num_heads
        data_shards = 1
        for a in ("pod", "data"):
            if a in mesh.axis_names:
                data_shards *= mesh.shape[a]
        t0 = time.time()
        with use_mesh(mesh):
            if shape.kind == "train":
                step, args, kwargs = _train_step(cfg, shape, mesh,
                                                 data_shards, fsdp_elems)
                tokens_per_step = shape.global_batch * shape.seq_len
            else:
                step, args, kwargs, tp_reason = _serve_step(
                    cfg, shape, mesh, packed and cfg.dbb.enabled, int8)
                rec["tp_wrap"] = tp_reason or "on"
                tokens_per_step = (shape.global_batch if shape.kind == "decode"
                                   else shape.global_batch * shape.seq_len)
            t_build = time.time() - t0
            t0 = time.time()
            out, stats = count_step(step, *args, peak_device="meta",
                                    **kwargs)
            t_count = time.time() - t0
            mf_total = model_flops_per_step(orig_cfg.active_param_count(),
                                            tokens_per_step,
                                            shape.kind == "train")
            mem, terms = step_terms(stats, (args, kwargs), out,
                                    kind=shape.kind, seq_len=shape.seq_len,
                                    model_flops=mf_total / n_dev)
    finally:
        dist.destroy_process_group()
    rec.update({
        "status": "ok",
        "devices": n_dev,
        "mesh_shape": list(mesh_shape),
        "build_s": round(t_build, 2),
        "count_s": round(t_count, 2),
        "memory": mem,
        "hlo_stats": {
            "flops": stats.flops,
            "hbm_bytes": stats.hbm_bytes,
            "collective_bytes": stats.collective_bytes,
            "collective_counts": stats.collective_counts,
            "top_collectives": stats.top_collectives(12),
            "routes": stats.routes,
            "top_aten": stats.top_aten(12),
        },
        "roofline": terms.as_dict(),
        "tokens_per_step": tokens_per_step,
    })
    if verbose:
        print(f"== {rec['cell']} ==")
        print("memory:", json.dumps(mem))
        print("roofline:", json.dumps(terms.as_dict()))
    return rec


def _artifact_path(out_dir: str, cell: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, f"{cell}.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Per-rank step costs of the production cells, on the "
                    "meta device over a fake world (module doc).")
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES),
                    help="one shape (default: all four)")
    ap.add_argument("--mesh", default="both",
                    choices=("pod", "multipod", "both"))
    ap.add_argument("--all", action="store_true",
                    help="every assigned arch and shape (the default when "
                         "neither --arch nor --shape is given)")
    ap.add_argument("--packed", action="store_true",
                    help="serve cells with DBB-packed weights")
    ap.add_argument("--int8", action="store_true",
                    help="with --packed: INT8 values + per-channel scales")
    ap.add_argument("--fsdp", type=int, default=None,
                    help="ZeRO min-shard-elems override (train cells)")
    ap.add_argument("--no-headpad", dest="headpad", action="store_false",
                    help="disable TP attention-head padding (baseline mode)")
    ap.add_argument("--jobs", type=int, default=2,
                    help="parallel subprocesses in --all mode")
    ap.add_argument("--timeout", type=int, default=3600,
                    help="seconds a cell's subprocess may take")
    ap.add_argument("--force", action="store_true",
                    help="recompute cells that already have artifacts")
    ap.add_argument("--inline", action="store_true",
                    help="run the cells in this process, one after another")
    ap.add_argument("--out", default=ART_DIR,
                    help="directory of the cells' JSON records")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch and not args.all else list(ASSIGNED)
    shapes = [args.shape] if args.shape and not args.all else list(SHAPES)
    meshes = (["pod", "multipod"] if args.mesh == "both" else [args.mesh])
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]

    if len(cells) == 1 or args.inline:
        code = 0
        for a, s, m in cells:
            try:
                rec = run_cell(a, s, m == "multipod", packed=args.packed,
                               int8=args.int8, fsdp=args.fsdp,
                               headpad=args.headpad)
            except Exception:
                rec = {"arch": a, "shape": s, "mesh": m, "status": "error",
                       "cell": _cell_id(a, s, m, args.packed, args.int8),
                       "error": traceback.format_exc()}
                print(rec["error"], file=sys.stderr)
                code = 1
            with open(_artifact_path(args.out, rec["cell"]), "w") as f:
                json.dump(rec, f, indent=1)
        return code
    return _orchestrate(cells, args)


def _orchestrate(cells, args) -> int:
    """One subprocess a cell (isolation: each initialises its own world),
    ``--jobs`` at a time; a cell whose record exists is reused unless
    ``--force``."""
    procs: Dict[str, Any] = {}
    pending = list(cells)
    failures = []
    done = 0
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")

    def launch(a, s, m):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", a, "--shape", s, "--mesh", m, "--out", args.out]
        if args.packed:
            cmd.append("--packed")
        if args.int8:
            cmd.append("--int8")
        if args.fsdp is not None:
            cmd += ["--fsdp", str(args.fsdp)]
        if not args.headpad:
            cmd.append("--no-headpad")
        return (subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                                 stderr=subprocess.PIPE), time.time())

    t_start = time.time()
    while pending or procs:
        while pending and len(procs) < args.jobs:
            a, s, m = pending.pop(0)
            cell = _cell_id(a, s, m, args.packed, args.int8)
            if not args.force and os.path.exists(
                    _artifact_path(args.out, cell)):
                done += 1
                print(f"[cached] {cell}")
                continue
            procs[cell] = launch(a, s, m)
        for cell, (p, t0) in list(procs.items()):
            if p.poll() is None:
                if time.time() - t0 > args.timeout:
                    p.kill()
                continue
            _, err = p.communicate()
            del procs[cell]
            done += 1
            path = _artifact_path(args.out, cell)
            status = "?"
            if os.path.exists(path):
                with open(path) as f:
                    status = json.load(f).get("status", "?")
            if p.returncode != 0 or status in ("error", "?"):
                failures.append(cell)
                print(f"[FAIL {done}/{len(cells)}] {cell}\n"
                      f"{err.decode()[-2000:]}")
            else:
                print(f"[ok {done}/{len(cells)}] {cell} ({status})")
        time.sleep(0.2)
    print(f"\n{done} cells in {time.time() - t_start:.1f} s, "
          f"{len(failures)} failures: {failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
