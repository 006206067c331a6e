"""The rank side of tests/test_torch_tp_serve.py: what each spawned gloo
rank runs. It imports torch and the port only (a rank never loads JAX);
the parent builds every reference input and answer.

`start_world` starts ``world`` ranks with the ``spawn`` start method and
a ``file://`` store, each running `rank_main`; `collect_world` returns
their result dicts in rank order (a rank's exception fails the world).
The parent may work between the two."""
import os
import pickle
import queue
import tempfile
import time
import traceback

import numpy as np
import torch

PARITY = dict(family="dense_lm", d_model=64, d_ff=256, num_layers=2,
              num_heads=8, num_kv_heads=4, vocab_size=128, dtype="float32",
              gemm_impl="pallas", kv_page_size=8)
MOE = dict(family="moe_lm", d_model=32, d_ff=48, num_layers=1,
           num_heads=4, num_kv_heads=4, vocab_size=64, dtype="float32")
SPLIT_TOL = 1e-5          # f32 split GEMMs vs the whole GEMM, of max |y|


def start_world(world, payload):
    """Start ``world`` ranks of `rank_main` without waiting for them: the
    handle for `collect_world`."""
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    tmp = tempfile.TemporaryDirectory()
    store = os.path.join(tmp.name, "store")
    # the payload goes through a file: a Process's arguments go down a
    # pipe the child reads only after its imports, which would start the
    # ranks one after another
    path = os.path.join(tmp.name, "payload.pkl")
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    procs = [ctx.Process(target=rank_main, args=(r, world, store, path, q))
             for r in range(world)]
    for p in procs:
        p.start()
    return world, procs, q, tmp, time.monotonic()


def collect_world(handle, timeout=300):
    """The started world's result dicts in rank order; every rank is
    joined, or terminated, before this returns."""
    world, procs, q, tmp, t0 = handle
    got = []
    try:
        # drain the queue before joining; a rank that died without a
        # result, or a world past ``timeout``, fails at once
        while len(got) < world:
            try:
                got.append(q.get(timeout=2))
                continue
            except queue.Empty:
                pass
            dead = [p.exitcode for p in procs
                    if not p.is_alive() and p.exitcode != 0]
            if dead or time.monotonic() - t0 > timeout:
                got.append({"rank": -1, "error": f"exit codes {dead}, "
                            f"{time.monotonic() - t0:.0f} s"})
                break
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
        tmp.cleanup()
    errs = [g for g in got if "error" in g]
    if errs:
        raise AssertionError(errs[0]["error"])
    assert not any(p.is_alive() for p in procs)
    return sorted(got, key=lambda g: g["rank"])


def rank_main(rank, world, store, path, q):
    try:
        torch.set_num_threads(1)
        with open(path, "rb") as f:
            payload = pickle.load(f)
        import torch.distributed as dist
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        from repro_torch.dist.mesh_ctx import make_smoke_mesh, use_mesh
        mesh = make_smoke_mesh(data=1, model=world, backend="gloo")
        out = {"rank": rank}
        if world == 4:
            out.update(_grid(rank))
        with use_mesh(mesh):
            out.update(_collectives(mesh, payload))
            out.update(_splits(mesh, payload))
            out.update(_streams(payload))
            out.update(_ep(payload))
        dist.barrier()
        dist.destroy_process_group()
        q.put(out)
    except Exception:                                   # noqa: BLE001
        q.put({"rank": rank, "error": traceback.format_exc()})


def _grid(rank):
    """A 2 x 2 mesh: each rank's coordinates and its sums over each axis
    (the model axis is the fastest)."""
    from repro_torch.dist.collectives import all_reduce
    from repro_torch.dist.mesh_ctx import make_mesh, use_mesh
    mesh = make_mesh(2, 2, backend="gloo")
    x = torch.tensor([float(rank)])
    with use_mesh(mesh):
        return {"grid": (mesh.index["data"], mesh.index["model"],
                         all_reduce(x, "data").item(),
                         all_reduce(x, "model").item())}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _collectives(mesh, p):
    from repro_torch.dist import collectives as C
    from repro_torch.dist.mesh_ctx import shard_tp_ctx
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.sample.ref import sample_argmax, sample_logits
    tp, i = mesh.shape["model"], mesh.index["model"]
    out = {}
    # embedding: the row-sharded gather against the whole table's
    table, toks = _t(p["table"]), _t(p["tokens"])
    v_loc = table.shape[0] // tp
    got = C.vocab_parallel_embed(table[i * v_loc:(i + 1) * v_loc], toks,
                                 torch.float32)
    out["embed_equal"] = torch.equal(got, table[toks.long()])
    # greedy combine on logits with ties planted across the slices
    lg = _t(p["tie_logits"])
    v_loc = lg.shape[1] // tp
    out["greedy_tie"] = C._greedy_combine(
        lg[:, i * v_loc:(i + 1) * v_loc]).tolist()
    # greedy and sampling heads on the head's column slice
    h, w, counts = _t(p["h"]), _t(p["w"]), _t(p["counts"])
    knobs = [_t(p[k]) for k in ("temp", "rep", "pres", "freq", "seed",
                                "step")]
    v_loc = w.shape[1] // tp
    wl = w[:, i * v_loc:(i + 1) * v_loc].contiguous()
    with shard_tp_ctx(tp):
        out["greedy_shard"] = C.shard_greedy(h, wl).tolist()
        out["sample_tok"] = C.shard_sample(h, wl, counts, *knobs).tolist()
        out["sample_tt_tok"] = C.shard_sample(
            h, wl, counts, *knobs, top_k=_t(p["top_k"]),
            top_p=_t(p["top_p"]), use_tt=True).tolist()
    score, _ = dispatch.head_sample(
        h, wl, counts[:, i * v_loc:(i + 1) * v_loc].contiguous(), *knobs,
        base=i * v_loc, return_score=True)
    out["sample_best_score"] = C.all_gather(score).max(dim=0).values.numpy()
    full_score, full_tok = sample_argmax(h @ w, counts, *knobs)
    out["sample_single"] = (full_tok.tolist(), full_score.numpy())
    out["sample_tt_single"] = sample_logits(
        h @ w, counts, knobs[0], _t(p["top_k"]), _t(p["top_p"]),
        *knobs[1:], use_tt=True).tolist()
    # all_reduce and all_gather on rank-seeded rows
    y = torch.randn((5, 12), generator=torch.Generator().manual_seed(i))
    out["psum"] = C.all_reduce(y).numpy()
    out["gather"] = C.all_gather(y).numpy()
    out["gather_cat"] = C.all_gather(y, dim=-1).numpy()
    out["psum_input_kept"] = torch.equal(
        y, torch.randn((5, 12), generator=torch.Generator().manual_seed(i)))
    return out


def _splits(mesh, p):
    """Column and row splits of `dispatch.matmul` (the kernel route, which
    runs the plain versions on CPU tensors) on dense, packed and INT8
    leaves, each cut by `shard_tree` under the serving specs."""
    from repro_torch.config import DbbConfig, ModelConfig
    from repro_torch.core.dbb_linear import pack_tree
    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import param_specs, shard_tree
    from repro_torch.kernels import dispatch
    cfg = ModelConfig(**PARITY, dbb=DbbConfig(enabled=True, block=8, nnz=4))
    x, w = _t(p["x"]), _t(p["w_split"])
    x8, w8 = _t(p["x8"]), _t(p["w8"])
    k_loc = x.shape[1] // mesh.shape["model"]
    ks = slice(mesh.index["model"] * k_loc, (mesh.index["model"] + 1) * k_loc)
    xl, x8l = x[:, ks].contiguous(), x8[:, ks].contiguous()
    leaves = {"dense": w,
              "packed": pack_tree({"mlp": {"wi": {"w": w}}}, cfg.dbb)[
                  "mlp"]["wi"]["w"],
              "int8_packed": pack_tree({"mlp": {"wi": {"w": w}}}, cfg.dbb,
                                       quantize=True)["mlp"]["wi"]["w"],
              "int8_dense": w8}
    out = {}

    def shard(leaf, proj):
        tree = {"layers": {proj: {"w": leaf}}}
        return shard_tree(tree, param_specs(tree, mesh, cfg,
                                            fsdp_min_shard_elems=None),
                          mesh)["layers"][proj]["w"]

    for name, leaf in leaves.items():
        xx, xxl = (x8, x8l) if name.startswith("int8") else (x, xl)
        full = dispatch.matmul(xx, leaf, pallas=True)
        col = C.all_gather(dispatch.matmul(xx, shard(leaf, "wi"),
                                           pallas=True), dim=-1)
        out[f"split_{name}_col"] = (col.numpy(), full.numpy())
        if name != "int8_packed":       # its [N] scale would scale partials
            row = C.all_reduce(dispatch.matmul(xxl, shard(leaf, "wo"),
                                               pallas=True))
            out[f"split_{name}_row"] = (row.numpy(), full.numpy())
    return out


def _engine_cfg():
    from repro_torch.config import DbbConfig, ModelConfig
    return ModelConfig(**PARITY, dbb=DbbConfig(enabled=True, block=8, nnz=4))


def streams(trees, prompts, sampling_kw, device="cpu"):
    """The parity config's streams: greedy serve on the paged pool and
    with 3-token prefill chunks for each tree; on the packed tree also
    greedy serve on the contiguous cache, greedy generate, sampled serve
    (paged) and draft_k=2 serve (contiguous). Run by every rank under the
    mesh, and by the parent alone for the port's single-device
    streams."""
    from repro_torch.interop import params_from_numpy
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sampling import SamplingParams
    cfg = _engine_cfg()
    sp = [SamplingParams(**k) for k in sampling_kw]
    out = {}
    for label, tree in trees.items():
        params = params_from_numpy(tree)

        def eng(**kw):
            return ServeEngine(cfg, params, max_batch=4, device=device, **kw)
        e = eng()
        out[label, "tp_reason"] = e.tp_reason
        if not e.tp_reason:
            # `shard_from_numpy` cuts the rank's layer planes as the engine
            # does (the engine then drops the indices plane)
            from repro_torch.dist.mesh_ctx import current_mesh
            from repro_torch.interop import shard_from_numpy
            from repro_torch.dist.sharding import _flatten
            mine = dict(_flatten(shard_from_numpy(tree, cfg,
                                                  current_mesh())["layers"]))
            held = _flatten(e.params["layers"])
            out[label, "shard_equal"] = all(
                torch.equal(mine[n], t) for n, t in held) and len(held) > 0
        out[label, "paged"] = e.serve(prompts, max_new_tokens=6)
        out[label, "chunked"] = eng(prefill_chunk=3).serve(
            prompts, max_new_tokens=6)
    out["packed", "contig"] = eng(paged=False).serve(prompts,
                                                     max_new_tokens=6)
    out["packed", "generate"] = e.generate(prompts, max_new_tokens=6)
    out["packed", "sampled"] = e.serve(prompts, max_new_tokens=6,
                                       sampling=sp)
    out["packed", "spec"] = eng(paged=False).serve(
        prompts, max_new_tokens=6, sampling=sp, draft_k=2)
    return out


def _streams(p):
    return {"streams": streams(p["trees"], p["prompts"], p["sampling"])}


def _ep(p):
    """moe_apply under the mesh: "auto" and "ep" both take expert
    parallelism here (the experts divide the model axis); "ep" also on
    planes already cut to this rank's expert window."""
    from repro_torch.config import ModelConfig, MoeConfig
    from repro_torch.dist.mesh_ctx import current_mesh
    from repro_torch.interop import params_from_numpy
    from repro_torch.models.moe import moe_apply
    mesh = current_mesh()
    lp = params_from_numpy(p["moe_layer"])
    x = _t(p["moe_x"])
    out = {}
    for impl in ("auto", "ep"):
        cfg = ModelConfig(**MOE, moe=MoeConfig(**dict(p["moe_cfg"],
                                                      impl=impl)))
        out[f"ep_{impl}"] = moe_apply(lp, cfg, x)[0].numpy()
    e_loc = p["moe_cfg"]["num_experts"] // mesh.shape["model"]
    e0 = mesh.index["model"] * e_loc
    cut = dict(lp, experts={k: v[e0:e0 + e_loc]
                            for k, v in lp["experts"].items()})
    out["ep_cut"] = moe_apply(cut, cfg, x)[0].numpy()
    return out
