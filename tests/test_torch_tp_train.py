"""Training on a mesh on the CPU: one gloo world of 4 spawned ranks (the
rank side is tests/torch_tp_train_ranks.py, which imports no JAX) making a
2 x 2 (data x model), a 1 x 4 and a pod-4 mesh, held against the
reference's single-device answers, which the parent computes while the
ranks run. A ``--mesh 2x2`` run of the training CLI (its own 4 spawned
ranks) runs beside them in a thread.

The bounds are the reference's own (tests/test_dist_multidevice.py):
vocab-parallel CE within rel 1e-5 of ``dense_ce`` with its gradient
within 1e-5; the embedding gather within 1e-5; a train step's loss within
rel 1e-4 of the single-device step's and its params within 5e-4 at lr
1e-3; the EP MoE output within 1e-3 of the local path and its aux within
rel 1e-4; the pipeline within 1e-5 of the sequential run.

The train steps start from the reference's ``init_params`` (carried over
through numpy) and are held against the port's own single-device step;
olmo-1b (the reference's test config: AdamW, lr 1e-3, B 8 x S 32),
arctic-480b under EP (capacity 8x the even share: no drops, so the
per-shard capacity of EP and the global one agree) and convnet-dbb also
against the reference's jitted single-device ``make_train_step`` (the
other cases' single-device arithmetic is held to the reference by
test_torch_train_loop, test_torch_optimizer and the zamba2 train tests;
each reference jit costs 5-9 s of this file's budget).
"""
import dataclasses
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_ranks
import torch_tp_train_ranks as R
from repro.config import RunConfig as JRun
from repro.config import TrainConfig as JTrain
from repro.configs import get_config as jget
from repro.dist.collectives import dense_ce as j_dense_ce
from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro.train.grad_compress import init_ef_state as j_init_ef
from repro_torch.config import RunConfig, ShapeSpec, TrainConfig
from repro_torch.configs import get_config as tget
from repro_torch.interop import params_from_numpy
from repro_torch.launch import train as ttrain
from repro_torch.train.loop import init_train_state, make_train_step
from repro_torch.train.tree import tree_leaves

ZERO = 1 << 12          # the reference dry run's ZeRO threshold
SHAPE = (32, 8)         # seq, batch of the LM steps
LR = 1e-3
# the CLI runs: olmo-1b smoke, 3 steps of the CLI's AdamW (lr 3e-4, warmup
# 10), a checkpoint after each
CLI_ARGV = ["--arch", "olmo-1b", "--steps", "3", "--seq-len", "32",
            "--batch", "8", "--checkpoint-every", "1"]
# the CLI's params after each step against ``--mesh none``'s, as the
# update's relative error ||Δmesh - Δnone|| / ||Δnone|| (Δ from the initial
# tree; `_update_err`): measured 4.1e-6 to 1.1e-5 on this CPU (f32 sums in
# another order). A mesh that skips its gradient sum over "data" reads
# 0.81-0.97, one whose state is left as it was reads 1. A max |diff| bound
# would not see either: the CLI's AdamW warms up from lr 3e-5, so 3 steps
# move a param by at most 2.5e-4.
CLI_UPDATE_RTOL = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _lm_batch(cfg, rng, ragged=False):
    mask = (rng.random((8, 32)) > (0.2 if ragged else -1)).astype(np.float32)
    if ragged:
        mask[:4, 20:] = 0.0                 # microbatch 0 carries fewer
    return {"tokens": rng.integers(0, cfg.vocab_size, (8, 32)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (8, 32)).astype(
                np.int32),
            "loss_mask": mask}


def _step_cases(rng):
    """name -> the rank payload of one train-step case."""
    jcfg = {a: jget(a, smoke=True) for a in ("olmo-1b", "arctic-480b",
                                             "convnet-dbb", "zamba2-1.2b")}
    trees = {a: _np(jreg.init_params(jax.random.PRNGKey(0), c))
             for a, c in jcfg.items()}
    b = {a: [_lm_batch(jcfg[a], rng), _lm_batch(jcfg[a], rng)]
         for a in ("olmo-1b", "arctic-480b", "zamba2-1.2b")}
    from repro_torch.data.pipeline import make_pipeline
    cnn = make_pipeline(tget("convnet-dbb", smoke=True),
                        ShapeSpec("t", 1, 8, "train"), seed=3)

    def case(arch, mesh, batches, fsdp=None, model=None, moe=None, **train):
        return dict(arch=arch, mesh=mesh, batches=batches, fsdp=fsdp,
                    model=model or {}, moe=moe or {}, nnz=None,
                    params=trees[arch],
                    train=dict(dict(learning_rate=LR), **train))
    ol = b["olmo-1b"]
    return {
        "olmo_sp": case("olmo-1b", "1x4", ol[:1]),
        "olmo_zero": case("olmo-1b", "2x2", ol[:1], fsdp=ZERO),
        "adafactor": case("olmo-1b", "2x2", ol, fsdp=ZERO,
                          optimizer="adafactor"),
        "microbatch": case("olmo-1b", "2x2",
                           [_lm_batch(jcfg["olmo-1b"], rng, ragged=True)],
                           fsdp=ZERO, microbatches=2),
        "int8_ef": case("olmo-1b", "2x2", ol, fsdp=ZERO, optimizer="sgd",
                        grad_compress="int8_ef", learning_rate=1e-2),
        "arctic_ep": case("arctic-480b", "2x2", b["arctic-480b"][:1],
                          moe=dict(capacity_factor=8.0)),
        "convnet_dp": case("convnet-dbb", "2x2",
                           [cnn.batch_at(0)], fsdp=1 << 10),
        "zamba2": case("zamba2-1.2b", "2x2", b["zamba2-1.2b"][:1]),
    }


# the cases also held to the reference's jitted single-device step (the
# olmo cases share one compile: the same config, tree and batch)
REF_CASES = ("olmo_sp", "olmo_zero", "arctic_ep", "convnet_dp")


def _jrun(c):
    cfg = jget(c["arch"], smoke=True).replace(**c["model"])
    if c["moe"]:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **c["moe"]))
    return JRun(model=cfg, train=JTrain(**c["train"]))


def _reference_step(c, cache):
    """The reference's single-device state after the case's first step,
    and its metrics."""
    rc = _jrun(c)
    key = (c["arch"], tuple(sorted(c["train"].items())),
           tuple(sorted(c["moe"].items())))
    if key not in cache:
        cache[key] = jax.jit(jloop.make_train_step(rc))
    p = jax.tree_util.tree_map(jnp.asarray, c["params"])
    init_fn, _ = jopt.make_optimizer(rc.train)
    st = jloop.TrainState(params=p, opt_state=init_fn(p),
                          ef=j_init_ef(p, rc.train.grad_compress),
                          step=jnp.zeros((), jnp.int32))
    s, m = cache[key](st, {k: jnp.asarray(v)
                           for k, v in c["batches"][0].items()})
    return ([np.asarray(x) for x in jax.tree_util.tree_leaves(s.params)],
            {k: float(v) for k, v in m.items()})


def _port_steps(c):
    """The port's single-device steps over the case's batches."""
    cfg = tget(c["arch"], smoke=True).replace(**c["model"])
    if c["moe"]:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **c["moe"]))
    rc = RunConfig(model=cfg, train=TrainConfig(**c["train"]))
    st = init_train_state(rc, device="cpu",
                          params=params_from_numpy(c["params"]))
    step = make_train_step(rc)
    mets = []
    for b in c["batches"]:
        st, m = step(st, {k: torch.from_numpy(v) for k, v in b.items()})
        mets.append({k: float(v) for k, v in m.items()})
    return [t.numpy() for t in tree_leaves(st.params)], mets


def _chunk_x(rng, d):
    """Two batch rows of 16,400 tokens; the second shifted along one
    direction, so its routing statistics differ from the first's."""
    x = rng.standard_normal((2, 16_400, d)).astype(np.float32)
    x[1] += 2.0 * rng.standard_normal(d).astype(np.float32)
    return x


def _chunked_moe(layer, cfg, x):
    """The reference's EP semantics on one data shard, on one device:
    equal chunks of at most 16,384 tokens, each routed by the reference's
    `_route` and dispatched to all experts at the chunk's capacity, plus
    the dense residual MLP; the aux averaged over the chunks (and the
    one-chunk aux beside it)."""
    t = x.shape[0] * x.shape[1]
    xt = jnp.asarray(x.reshape(t, -1))
    nc = max(1, t // 16_384)
    while t % nc:
        nc -= 1
    tc = t // nc
    e = cfg.moe.num_experts
    ys, aux = [], 0.0
    for i in range(nc):
        xc = xt[i * tc:(i + 1) * tc]
        idx, p, a = jmoe._route(xc, layer["router"]["w"], cfg)
        ys.append(jmoe._dispatch_compute_combine(
            xc, layer["experts"], idx, p, 0, e, jmoe._capacity(tc, cfg),
            cfg))
        aux += float(a)
    one = float(jmoe._route(xt, layer["router"]["w"], cfg)[2])
    from repro.models.mlp import mlp_apply as j_mlp
    y = jnp.concatenate(ys).reshape(x.shape) + j_mlp(
        layer["dense_mlp"], cfg.replace(d_ff=cfg.moe.dense_residual_ff),
        jnp.asarray(x))
    return np.asarray(y), aux / nc, one


def _cli(argv, out):
    """A training CLI run in this process's thread (its ranks are
    processes of their own); its log lines and report into ``out``."""
    try:
        lines, rep = [], {}
        ttrain.main(argv, device="cpu", log=lines.append, report=rep)
        out.update(lines=lines, report=rep)
    except BaseException as e:                           # noqa: BLE001
        out["error"] = repr(e)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train")
    rng = np.random.default_rng(0)
    acfg = jget("arctic-480b", smoke=True)
    mcfg = acfg.replace(moe=dataclasses.replace(acfg.moe,
                                                capacity_factor=8.0))
    layer = _np(jmoe.moe_init(jax.random.PRNGKey(0), acfg, jnp.float32))
    d = acfg.d_model
    steps = _step_cases(rng)
    resume = dict(steps["olmo_zero"], shape=SHAPE, train=dict(
        learning_rate=LR, steps=4, checkpoint_every=2, log_every=1, seed=0,
        checkpoint_dir=str(tmp / "mesh_ckpt")))
    payload = {
        "ce": {"h": rng.standard_normal((4, 8, 32)).astype(np.float32),
               "w": rng.standard_normal((32, 64)).astype(np.float32),
               "labels": rng.integers(0, 64, (4, 8)).astype(np.int32),
               "mask": (rng.random((4, 8)) > 0.3).astype(np.float32)},
        "embed": {"table": rng.standard_normal((64, 16)).astype(np.float32),
                  "tokens": rng.integers(0, 64, (4, 8)).astype(np.int32)},
        "greedy": {"h": rng.standard_normal((6, 32)).astype(np.float32),
                   "w": (rng.standard_normal((32, 128)) / 8).astype(
                       np.float32)},
        "moe": {"layer": layer, "moe": dict(capacity_factor=8.0),
                "x": rng.standard_normal((4, 16, d)).astype(np.float32)},
        # > 16,384 tokens a rank: two chunks, at the config's capacity
        "chunks": {"layer": layer, "moe": {}, "x": _chunk_x(rng, d)},
        "pipeline": {"ws": (rng.standard_normal((8, 32, 32))
                            / np.sqrt(32)).astype(np.float32),
                     "x": rng.standard_normal((6, 4, 32)).astype(
                         np.float32)},
        "steps": steps, "resume": resume}
    handle = R.start_world(payload)
    cli = {}
    ckpt_cli = str(tmp / "cli_ckpt")
    thread = threading.Thread(target=_cli, args=(
        CLI_ARGV + ["--mesh", "2x2", "--checkpoint-dir", ckpt_cli], cli))
    thread.start()
    try:
        want = {}
        c = payload["ce"]
        h = jnp.asarray(c["h"])
        args = (jnp.asarray(c["w"]), jnp.asarray(c["labels"]),
                jnp.asarray(c["mask"]))
        want["ce"] = float(j_dense_ce(h, *args))
        want["ce_grad"] = np.asarray(jax.grad(
            lambda hh: j_dense_ce(hh, *args))(h))
        e = payload["embed"]
        want["embed"] = e["table"][e["tokens"]]
        g = payload["greedy"]
        want["greedy"] = np.asarray(jnp.argmax(
            jnp.asarray(g["h"]) @ jnp.asarray(g["w"]), axis=-1))
        jl = jax.tree_util.tree_map(jnp.asarray, layer)
        y, aux = jmoe.moe_apply(jl, mcfg.replace(moe=dataclasses.replace(
            mcfg.moe, impl="local")), jnp.asarray(payload["moe"]["x"]))
        want["moe"] = (np.asarray(y), float(aux))
        want["chunks"] = _chunked_moe(jl, acfg, payload["chunks"]["x"])
        pl = payload["pipeline"]

        def layer_fn(cc, w):
            return jnp.tanh(cc @ w), None
        want["pipeline"] = np.asarray(jax.vmap(lambda xx: jax.lax.scan(
            layer_fn, xx, jnp.asarray(pl["ws"]))[0])(jnp.asarray(pl["x"])))
        cache = {}
        want["ref_steps"] = {n: _reference_step(steps[n], cache)
                             for n in REF_CASES}
        want["port_steps"] = {n: _port_steps(cs) for n, cs in steps.items()}
        none_lines, none_rep = [], {}
        ckpt_none = str(tmp / "cli_none")
        ttrain.main(CLI_ARGV + ["--mesh", "none", "--checkpoint-dir",
                                ckpt_none],
                    device="cpu", log=none_lines.append, report=none_rep)
        want["cli_none"] = (none_lines, none_rep["state"], ckpt_none)
    finally:
        ranks = torch_tp_ranks.collect_world(handle, timeout=240)
        thread.join(timeout=240)
    return payload, want, ranks, cli, ckpt_cli


def _rel(a, b):
    return abs(a - b) / abs(b)


def _update_err(got, want, init):
    """||(got - init) - (want - init)|| / ||want - init|| over the leaves."""
    num = sum(float(((a - b).double() ** 2).sum()) for a, b in zip(got, want))
    den = sum(float(((b - c).double() ** 2).sum()) for b, c in zip(want, init))
    return (num / den) ** 0.5


def test_coordinates(world):
    """Row-major ranks, the model axis the fastest; pod 4 puts one rank on
    each stage."""
    _, _, ranks, _, _ = world
    for r, out in enumerate(ranks):
        assert out["coords"]["2x2"] == {"data": r // 2, "model": r % 2}
        assert out["coords"]["1x4"] == {"data": 0, "model": r}
        assert out["coords"]["pod4"] == {"pod": r, "data": 0, "model": 0}


def test_vocab_parallel_ce_and_gradient(world):
    """Rows over "data", the vocab over "model": every rank's loss is the
    global masked mean (rel 1e-5 of ``dense_ce``), and its rows' gradient
    (h entering through `copy_to`) within 1e-5 of jax.grad's."""
    _, want, ranks, _, _ = world
    for out in ranks:
        assert out["ce"] == pytest.approx(want["ce"], rel=1e-5)
        a, b = out["rows"]
        assert np.abs(out["ce_grad"] - want["ce_grad"][a:b]).max() < 1e-5


def test_vocab_parallel_embed(world):
    _, want, ranks, _, _ = world
    for out in ranks:
        a, b = out["rows"]
        assert np.abs(out["embed"] - want["embed"][a:b]).max() < 1e-5


def test_greedy_heads_on_four_ranks(world):
    """`greedy_vocab_parallel` (column slices) and `greedy_scatter` (d
    slices, a reduce-scatter of the partial logits) give the dense
    argmax on every rank, as the reference's
    ``test_tp_greedy_vocab_parallel_heads`` holds them."""
    _, want, ranks, _, _ = world
    for out in ranks:
        np.testing.assert_array_equal(out["greedy_vp"], want["greedy"])
        np.testing.assert_array_equal(out["greedy_sc"], want["greedy"])


def test_moe_ep_layer_matches_local(world):
    """arctic smoke's MoE block, experts split over "model", rows over
    "data", capacity 8x: y within 1e-3 of the reference's local path, aux
    (f_e and P_e averaged over the data shards first) within rel 1e-4."""
    _, want, ranks, _, _ = world
    y, aux = want["moe"]
    for out in ranks:
        got = out["moe"]
        assert got["aux"] == pytest.approx(aux, rel=1e-4)
        if got["y"] is not None:
            a, b = got["rows"]
            assert np.abs(got["y"] - y[a:b]).max() < 1e-3


def test_moe_ep_chunks(world):
    """32,800 tokens on each rank of the 1 x 4 mesh: two chunks of 16,400
    (one batch row each; the second row's tokens shifted, so the chunks
    route differently) with a capacity each, against the reference's
    route and dispatch per chunk (y within 1e-3, aux the chunks' mean
    within rel 1e-4), which differs from one chunk's aux."""
    _, want, ranks, _, _ = world
    y, aux, one = want["chunks"]
    assert abs(aux - one) > 1e-2 * abs(one)
    for out in ranks:
        assert out["chunks"]["aux"] == pytest.approx(aux, rel=1e-4)
    assert np.abs(ranks[0]["chunks"]["y"] - y).max() < 1e-3


def test_pipeline_matches_sequential(world):
    _, want, ranks, _, _ = world
    for out in ranks:
        assert np.abs(out["pipeline"] - want["pipeline"]).max() < 1e-5


# tolerances of the mesh step against the single-device step, as (loss
# rel, params max |diff|): the reference's 1e-4 / 5e-4 at lr 1e-3 for
# every case (measured on this CPU: params within 6e-6 and losses within
# rel 1e-7 everywhere). The cases beyond the reference's own test keep its
# bounds with these reasons: Adafactor (2 steps; measured 1.2e-7) adds its
# factored means and RMS normalisers over the split leaves in another
# order, which moves a relative step by rounding only; microbatches=2 with
# a ragged mask (measured 2.1e-6) divides each microbatch by its global
# mask count on both sides; int8_ef with SGD at lr 1e-2 (2 steps;
# measured 1.7e-7) could round a value on an INT8 edge the other way,
# which moves a param by one quantum (max |g| / 127) times lr, ~4e-5 here,
# under the 1e-4 it is held to.
STEP_TOL = {"int8_ef": (1e-4, 1e-4)}


@pytest.mark.parametrize("name", ["olmo_sp", "olmo_zero", "adafactor",
                                  "microbatch", "int8_ef", "arctic_ep",
                                  "convnet_dp", "zamba2"])
def test_mesh_step_matches_single_device(world, name):
    """The mesh step's metrics on every rank and its gathered params
    against the port's single-device step, and for REF_CASES the
    reference's jitted single-device ``make_train_step``."""
    payload, want, ranks, _, _ = world
    case = payload["steps"][name]
    rel, ptol = STEP_TOL.get(name, (1e-4, 5e-4))
    p1, m1 = want["port_steps"][name]
    for out in ranks:
        got = out["steps"][name]
        for a, b in zip(got["metrics"], m1):
            assert a["loss"] == pytest.approx(b["loss"], rel=rel), (a, b)
            assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=rel)
    got = ranks[0]["steps"][name]
    assert len(got["params"]) == len(p1)
    assert max(np.abs(a - b).max() for a, b in zip(got["params"], p1)) \
        < ptol
    if name in want["ref_steps"]:
        pj, mj = want["ref_steps"][name]
        assert got["metrics"][0]["loss"] == pytest.approx(mj["loss"],
                                                          rel=1e-4)
        if len(case["batches"]) == 1:
            assert max(np.abs(a - b).max()
                       for a, b in zip(got["params"], pj)) < 5e-4
    split = set(got["split"])
    if case["arch"] == "olmo-1b":
        assert split == {"vocab", "head", "attn", "mlp"}
    assert got["sp_zero"] == (case["fsdp"] is not None)
    if case["arch"] == "arctic-480b":
        assert "experts" in split
    if case["arch"] in ("convnet-dbb", "zamba2-1.2b"):
        # no tensor parallelism in a CNN; the hybrid stack's layers whole
        assert split <= {"vocab", "head"}


def test_mesh_checkpoint_resumes_bit_exactly(world):
    """train_loop on the 2 x 2 mesh (ZeRO on) with checkpoints every 2
    steps: resumed from step 2 its losses at steps 2 and 3 equal the
    straight run's bit for bit; the checkpoint (whole leaves) restores on
    one device, whose run from it tracks the mesh run within rel 1e-4,
    and the JAX package reads it."""
    payload, _, ranks, _, _ = world
    hist = ranks[0]["resume"]
    straight = {h["step"]: h for h in hist["straight"]}
    resumed = {h["step"]: h for h in hist["resumed"]}
    assert sorted(resumed) == [2, 3] and sorted(straight) == [0, 1, 2, 3]
    for s in (2, 3):
        for k in ("loss", "grad_norm", "aux"):
            assert resumed[s][k] == straight[s][k]
    def no_dt(h):
        return {k: [dict(x, dt=None) for x in v] for k, v in h.items()}
    for out in ranks[1:]:
        assert no_dt(out["resume"]) == no_dt(hist)
    case = payload["resume"]
    root = case["train"]["checkpoint_dir"]
    shutil.rmtree(os.path.join(root, "step_000000004"))
    cfg = tget(case["arch"], smoke=True)
    rc = RunConfig(model=cfg, train=TrainConfig(**case["train"]))
    from repro_torch.launch.train import train_loop
    lines = []
    state, one = train_loop(rc, ShapeSpec("t", *SHAPE, "train"),
                            log=lines.append, device="cpu")
    assert lines[0] == "resumed from step 2"
    for h in one:
        assert h["loss"] == pytest.approx(straight[h["step"]]["loss"],
                                          rel=1e-4)
    jrc = JRun(model=jget("olmo-1b", smoke=True),
               train=JTrain(**case["train"]))
    jst = jloop.init_train_state(jax.random.PRNGKey(0), jrc)
    got, meta = jckpt.restore(root, jst, step=2)
    assert meta["step"] == 2
    from repro_torch.train import checkpoint as tckpt
    mine, _ = tckpt.restore(root, init_train_state(
        rc, device="cpu", params=params_from_numpy(case["params"])), step=2)
    for a, b in zip(jax.tree_util.tree_leaves(got.params),
                    tree_leaves(mine.params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_cli_mesh_trains(world):
    """``python -m repro_torch.launch.train --mesh 2x2`` (4 spawned gloo
    ranks): its first line names the mesh and the backend, its metric
    lines (step 0's: the CLI logs every 10th step, as the reference's)
    track ``--mesh none`` within rel 1e-4, its checkpoints hold whole
    leaves: after every step its update is within CLI_UPDATE_RTOL of the
    ``--mesh none`` run's, and the last restores on one device. The
    sparsity report is the last line."""
    _, want, _, cli, ckpt_cli = world
    assert "error" not in cli, cli.get("error")
    lines = cli["lines"]
    assert lines[0].startswith("mesh 2x2 (data x model): 4 ranks sharing "
                               "cpu, backend gloo")
    import json
    none_lines, none_state, ckpt_none = want["cli_none"]
    got = [json.loads(x) for x in lines[1:] if x.startswith("{")]
    ref = [json.loads(x) for x in none_lines if x.startswith("{")]
    assert [h["step"] for h in got] == [h["step"] for h in ref] == [0]
    for a, b in zip(got, ref):
        for k in ("loss", "grad_norm", "lr"):
            assert a[k] == pytest.approx(b[k], rel=1e-4)
    assert lines[-1].startswith("sparsity (first 5 leaves): ")
    assert cli["report"]["backend"] == "gloo"
    from repro_torch.train import checkpoint as tckpt
    assert tckpt.available_steps(ckpt_cli) == [1, 2, 3]
    init = init_train_state(ttrain._run_cfg(
        ttrain.build_parser().parse_args(CLI_ARGV)), device="cpu")
    p0 = tree_leaves(init.params)
    for s in (1, 2, 3):
        pm, pn = (tree_leaves(tckpt.restore(d, init, step=s)[0].params)
                  for d in (ckpt_cli, ckpt_none))
        assert _update_err(pm, pn, p0) < CLI_UPDATE_RTOL, s
    restored, meta = tckpt.restore(ckpt_cli, none_state)
    assert meta["step"] == restored.step == 3
