"""The rank side of tests/test_torch_tp_train.py: what each of the 4
spawned gloo ranks runs. It imports torch and the port only (a rank never
loads JAX); the parent builds every input and every reference answer.

One world of 4 ranks makes three meshes: 2 x 2 (data x model), 1 x 4 and
pod 4 (the pipeline's axis). `start_world` starts the ranks (the ``spawn``
start method, a ``file://`` store), `torch_tp_ranks.collect_world` returns
their result dicts in rank order."""
import os
import pickle
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch

WORLD = 4


def start_world(payload):
    """Start the 4 ranks of `rank_main` without waiting for them: the
    handle for `torch_tp_ranks.collect_world`."""
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    tmp = tempfile.TemporaryDirectory()
    store = os.path.join(tmp.name, "store")
    # the payload goes through a file (a Process's arguments reach the
    # child only after its imports)
    path = os.path.join(tmp.name, "payload.pkl")
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    procs = [ctx.Process(target=rank_main, args=(r, WORLD, store, path, q))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    return WORLD, procs, q, tmp, time.monotonic()


def rank_main(rank, world, store, path, q):
    try:
        torch.set_num_threads(1)
        with open(path, "rb") as f:
            payload = pickle.load(f)
        import torch.distributed as dist
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        from repro_torch.dist.mesh_ctx import make_mesh
        meshes = {"2x2": make_mesh(2, 2, backend="gloo"),
                  "1x4": make_mesh(1, 4, backend="gloo"),
                  "pod4": make_mesh(1, 1, backend="gloo", pod=4)}
        out = {"rank": rank,
               "coords": {k: dict(m.index) for k, m in meshes.items()}}
        out.update(_collectives(meshes, payload))
        out["moe"] = _moe_layer(meshes["2x2"], payload["moe"])
        out["chunks"] = _moe_layer(meshes["1x4"], payload["chunks"])
        out["pipeline"] = _pipeline(meshes["pod4"], payload["pipeline"])
        out["steps"] = {name: _steps(meshes[c["mesh"]], c)
                        for name, c in payload["steps"].items()}
        out["resume"] = _resume(meshes["2x2"], payload["resume"])
        dist.barrier()
        dist.destroy_process_group()
        q.put(out)
    except Exception:                                   # noqa: BLE001
        q.put({"rank": rank, "error": traceback.format_exc()})


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _collectives(meshes, payload):
    """The vocab-parallel CE (value and gradient) and embedding on the
    2 x 2 mesh (rows over data, vocab over model); the greedy heads on
    1 x 4."""
    from repro_torch.dist import collectives as col
    from repro_torch.dist.mesh_ctx import use_mesh
    mesh = meshes["2x2"]
    di, mi = mesh.index["data"], mesh.index["model"]
    c = payload["ce"]
    rows = slice(di * 2, di * 2 + 2)
    v_loc = c["w"].shape[1] // 2
    e = payload["embed"]
    t_loc = e["table"].shape[0] // 2
    with use_mesh(mesh):
        h = _t(c["h"][rows]).requires_grad_(True)
        loss = col.vocab_parallel_ce(
            col.copy_to(h, "model"), _t(c["w"][:, mi * v_loc:][:, :v_loc]),
            _t(c["labels"][rows]), _t(c["mask"][rows]),
            batch_axes=("data",))
        grad, = torch.autograd.grad(loss, [h])
        emb = col.vocab_parallel_embed(
            _t(e["table"][mi * t_loc:(mi + 1) * t_loc]),
            _t(e["tokens"][rows]), torch.float32)
    g = payload["greedy"]
    with use_mesh(meshes["1x4"]):
        vp = col.greedy_vocab_parallel(_t(g["h"]), _t(g["w"]))
        sc = col.greedy_scatter(_t(g["h"]), _t(g["w"]))
    return {"ce": loss.item(), "ce_grad": grad.numpy(), "rows": (di * 2,
            di * 2 + 2), "embed": emb.numpy(), "greedy_vp": vp.numpy(),
            "greedy_sc": sc.numpy()}


def _moe_cfg(case):
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config("arctic-480b", smoke=True)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **case["moe"]))


def _moe_layer(mesh, case):
    """`moe_apply` under a training layout that splits the experts over
    "model" (rows over "data" where the mesh has a data axis): this
    rank's rows of y, and the aux loss."""
    from repro_torch.dist.mesh_ctx import TrainLayout, use_mesh, \
        use_train_layout
    from repro_torch.interop import params_from_numpy
    from repro_torch.models.moe import moe_apply
    cfg = _moe_cfg(case)
    tp, dp = mesh.shape["model"], mesh.shape["data"]
    p = params_from_numpy(case["layer"])
    e_loc = cfg.moe.num_experts // tp
    e0 = mesh.index["model"] * e_loc
    p["experts"] = {k: v[e0:e0 + e_loc] for k, v in p["experts"].items()}
    x = case["x"]
    b = x.shape[0] // dp
    rows = slice(mesh.index["data"] * b, (mesh.index["data"] + 1) * b)
    lay = TrainLayout(tp=tp, split=frozenset({"experts"}),
                      batch_axes=("data",) if dp > 1 else ())
    with torch.no_grad(), use_mesh(mesh), use_train_layout(lay):
        y, aux = moe_apply(p, cfg, _t(x[rows]))
    keep = mesh.index["model"] == 0
    return {"rows": (rows.start, rows.stop), "aux": float(aux),
            "y": y.numpy() if keep else None}


def _pipeline(mesh, case):
    """`pipeline_forward` over the pod axis: this rank holds stage
    ``pod`` of `stack_stages` of the layer stack."""
    from repro_torch.dist.mesh_ctx import use_mesh
    from repro_torch.dist.pipeline import pipeline_forward, stack_stages
    stages = stack_stages({"w": _t(case["ws"])}, mesh.shape["pod"])
    pi = mesh.index["pod"]
    local = {"w": stages["w"][pi:pi + 1]}

    def stage_fn(sw, xx):
        for w in sw["w"]:
            xx = torch.tanh(xx @ w)
        return xx
    with use_mesh(mesh):
        y = pipeline_forward(local, _t(case["x"]), stage_fn, axis="pod")
    return y.numpy()


def _run_cfg(case):
    import dataclasses

    from repro_torch.config import RunConfig, TrainConfig
    from repro_torch.configs import get_config
    cfg = get_config(case["arch"], smoke=True).replace(**case["model"])
    if case.get("moe"):
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **case["moe"]))
    return RunConfig(model=cfg, train=TrainConfig(**case["train"]))


def _steps(mesh, case):
    """``len(case["batches"])`` mesh steps from the case's tree: each
    step's metrics, the layout's split kinds, whether ZeRO split a leaf,
    and (rank 0) the gathered params' leaves."""
    from repro_torch.interop import params_from_numpy
    from repro_torch.train.loop import (gather_state, init_train_state,
                                        make_train_step, plan_mesh,
                                        rank_batch)
    from repro_torch.train.tree import tree_leaves
    rc = _run_cfg(case)
    params = params_from_numpy(case["params"])
    plan = plan_mesh(params, rc, mesh, case["fsdp"])
    state = init_train_state(rc, device="cpu", params=params, plan=plan)
    step = make_train_step(rc, nnz=case["nnz"], plan=plan)
    mets = []
    for b in case["batches"]:
        loc = rank_batch({k: _t(v) for k, v in b.items()}, plan,
                         rc.train.microbatches)
        state, m = step(state, loc)
        mets.append({k: float(v) for k, v in m.items()})
    zero = any(a in ("data", "pod") for sp in plan.gather.values()
               for e in sp for a in ((e,) if isinstance(e, str) else e or ()))
    whole = gather_state(state, plan)
    leaves = ([t.numpy() for t in tree_leaves(whole.params)]
              if mesh.index.get("data", 0) == 0 and mesh.index.get(
                  "model", 0) == 0 and mesh.index.get("pod", 0) == 0
              else None)
    return {"metrics": mets, "split": sorted(plan.layout.split),
            "sp_zero": zero, "params": leaves}


def _resume(mesh, case):
    """`launch.train.train_loop` on the mesh with checkpoints every 2
    steps: a straight run, then (the last checkpoint removed) a run that
    resumes from the one before; both histories."""
    import torch.distributed as dist

    from repro_torch.config import ShapeSpec
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.train import train_loop
    rc = _run_cfg(case)
    shape = ShapeSpec("t", *case["shape"], "train")
    hist = {}
    for name in ("straight", "resumed"):
        _, hist[name] = train_loop(
            rc, shape, log=lambda *_: None, device="cpu", mesh=mesh,
            params=params_from_numpy(case["params"]),
            fsdp_min_shard_elems=case["fsdp"])
        if name == "straight" and dist.get_rank() == 0:
            last = max(int(n[5:]) for n in os.listdir(case["train"][
                "checkpoint_dir"]) if n.startswith("step_"))
            shutil.rmtree(os.path.join(case["train"]["checkpoint_dir"],
                                       f"step_{last:09d}"))
        dist.barrier()
    return hist
