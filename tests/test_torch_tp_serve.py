"""Tensor-parallel serving on the CPU: gloo worlds of 2 and 4 spawned
ranks (one spawn each; the rank side is tests/torch_tp_ranks.py, which
imports no JAX), held against the reference's single-device answers,
which the parent computes while the ranks run.

* The reference's TP parity config (tests/test_dist_multidevice.py's
  ``test_tp_serve_parity_matrix``: d 64, d_ff 256, 2 layers, heads 8 / 4,
  vocab 128, f32, ``gemm_impl="pallas"``, page 8, DBB 8 / 4), weights from
  ``repro.models.registry.init_params`` (dense, and packed by
  ``pack_tree``) through `params_from_numpy` and the engine's own
  `shard_tree` (the port runs the config as given, on its kernel route's
  plain versions): greedy serve on the paged pool and in 3-token prefill
  chunks (dense and packed), and on the packed tree greedy serve on the
  contiguous cache, greedy generate, sampled serve and draft_k=2 serve. Every rank's
  streams equal the reference's single-device engine's (the reference's
  own TP oracle fails under jax 0.9.0, so its contract — TP streams equal
  single-device streams — is held against the single-device engine), and
  so do the port's single-device streams. The reference runs `generate`
  on its XLA route: each of its rows decodes as it would alone, so its
  static batch gives the streams its ``serve`` gives, and on this config
  its XLA route's streams equal its Pallas route's (its parity test
  asserts that for greedy serve; the sampled and draft_k=2 streams agree
  too), at a third of the CPU time.
* The collectives: the row-sharded embedding gather against the table's
  (exact), the greedy combine against ``argmax`` with ties across the
  slices, `shard_sample`'s tokens and best scores bit-equal to the
  single-device sampler over the whole row (top-k / top-p rows too),
  `all_reduce` and `all_gather` against the sum and the stack of the
  ranks' rows.
* Column and row splits of `dispatch.matmul` on dense, packed (f32
  values) and INT8 leaves: the integer outputs bit-exact, f32 within
  ``SPLIT_TOL`` (1e-5) of max |y| (a row split sums its partials in
  another order).
* Expert-parallel `moe_apply` (``impl`` "auto" and "ep", whole and
  pre-cut expert planes) against the reference's ``impl="local"`` at
  no-drop capacity, within 1e-5 of max |y| (the combine's sum crosses
  ranks in another order).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import torch_tp_ranks as R
from repro.config import DbbConfig as JDbbConfig
from repro.config import ModelConfig as JModelConfig
from repro.config import MoeConfig as JMoeConfig
from repro.core.dbb_linear import pack_tree as jpack
from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.sampling import SamplingParams as JSamplingParams

PROMPTS = [[5, 6, 7, 8], [9, 10, 11], [3, 4], [12, 13, 14, 15, 16]]
SAMPLING = [dict(temperature=0.8, seed=11),
            dict(temperature=1.2, seed=-5, repetition_penalty=1.3),
            dict(),
            dict(temperature=0.5, seed=7, presence_penalty=0.4,
                 frequency_penalty=0.2)]
MOE_CFG = dict(num_experts=8, top_k=2, capacity_factor=16.0)
MOE_TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def reference():
    """The rank payload, the reference's single-device answers and the
    ranks' results: the worlds of 2 and 4 ranks start as soon as the
    payload is built and run while the parent computes the answers."""
    rng = np.random.default_rng(0)
    jcfg = JModelConfig(**dict(R.PARITY, gemm_impl="xla"),
                        dbb=JDbbConfig(enabled=True, block=8, nnz=4))
    # jitted: the same values as the eager calls, one compile each
    params = jax.jit(lambda k: jreg.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    trees = {"dense": params,
             "packed": jax.jit(lambda p: jpack(p, jcfg.dbb))(params)}
    # a tiny MoE layer, no drops (capacity 16x the even share)
    d, f, e = R.MOE["d_model"], R.MOE["d_ff"], MOE_CFG["num_experts"]
    layer = {"router": {"w": rng.standard_normal((d, e), np.float32)},
             "experts": {
                 "wi": rng.standard_normal((e, d, f), np.float32) / 6,
                 "wg": rng.standard_normal((e, d, f), np.float32) / 6,
                 "wo": rng.standard_normal((e, f, d), np.float32) / 7}}
    moe_x = rng.standard_normal((2, 7, d), np.float32)
    tie = rng.standard_normal((3, 64)).astype(np.float32)
    tie[0, [5, 40]] = 9.0           # ties across slices: the lower id
    tie[1, [33, 63]] = 9.0
    tie[2, [20, 21]] = 9.0          # a tie inside one slice
    b, k, v = 4, 32, 256
    payload = {
        "trees": {k_: _np(t) for k_, t in trees.items()},
        "prompts": PROMPTS, "sampling": SAMPLING,
        "table": rng.standard_normal((64, 16)).astype(np.float32),
        "tokens": rng.integers(0, 64, (3, 5)).astype(np.int32),
        "tie_logits": tie,
        "h": rng.standard_normal((b, k)).astype(np.float32),
        "w": (rng.standard_normal((k, v)) / 4).astype(np.float32),
        "counts": rng.integers(0, 3, (b, v)).astype(np.int32),
        "temp": np.array([0.0, 0.7, 1.3, 0.9], np.float32),
        "rep": np.array([1.0, 1.2, 1.0, 0.9], np.float32),
        "pres": np.array([0.0, 0.3, 0.0, 0.1], np.float32),
        "freq": np.array([0.0, 0.0, 0.2, 0.1], np.float32),
        "seed": np.array([1, -7, 1 << 30, 99], np.int32),
        "step": np.array([0, 3, 8, 1], np.int32),
        "top_k": np.array([0, 5, 0, 40], np.int32),
        "top_p": np.array([1.0, 1.0, 0.9, 0.8], np.float32),
        "x": rng.standard_normal((8, 64)).astype(np.float32),
        "w_split": rng.standard_normal((64, 96)).astype(np.float32),
        "x8": rng.integers(-127, 128, (8, 64)).astype(np.int8),
        "w8": rng.integers(-127, 128, (64, 96)).astype(np.int8),
        "moe_layer": layer, "moe_x": moe_x, "moe_cfg": MOE_CFG}
    started = {tp: R.start_world(tp, payload) for tp in (2, 4)}
    try:
        jsp = [JSamplingParams(**k) for k in SAMPLING]
        want = {}
        for label, tree in trees.items():
            eng = JEngine(jcfg, tree, max_batch=4)
            want[label, "greedy"] = eng.generate(PROMPTS, max_new_tokens=6)
        want["packed", "sampled"] = eng.generate(PROMPTS, max_new_tokens=6,
                                                 sampling=jsp)
        want["packed", "spec"] = eng.generate(PROMPTS, max_new_tokens=6,
                                              sampling=jsp, draft_k=2)
        mcfg = JModelConfig(**R.MOE, moe=JMoeConfig(**MOE_CFG,
                                                    impl="local"))
        want["moe"] = np.asarray(jmoe.moe_apply(
            jax.tree_util.tree_map(jnp.asarray, layer), mcfg,
            jnp.asarray(moe_x))[0])
    finally:
        ranks = {tp: R.collect_world(h) for tp, h in started.items()}
    return payload, want, ranks


@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def world(request, reference):
    payload, want, ranks = reference
    return request.param, ranks[request.param], payload, want


_KINDS = {"paged": "greedy", "contig": "greedy", "chunked": "greedy",
          "generate": "greedy", "sampled": "sampled", "spec": "spec"}


def _check_streams(got, want, tag):
    streams = {k: v for k, v in got.items() if k[1] in _KINDS}
    for (label, kind), stream in streams.items():
        assert stream == want[label, _KINDS[kind]], (tag, label, kind)
    assert len(streams) == 2 * 2 + 4        # every stream was compared


def test_every_rank_streams_equal_the_reference(world):
    tp, ranks, _, want = world
    assert len(ranks) == tp
    for r in ranks:
        for label in ("dense", "packed"):
            assert r["streams"][label, "tp_reason"] == ""
            # interop.shard_from_numpy gives the planes the engine holds
            assert r["streams"][label, "shard_equal"]
        _check_streams(r["streams"], want, (tp, r["rank"]))


def test_port_single_device_streams_equal_the_reference(reference):
    payload, want, _ = reference
    got = R.streams(payload["trees"], PROMPTS, SAMPLING)
    assert got["packed", "tp_reason"] == "no live mesh with a model axis > 1"
    _check_streams(got, want, "single device")


def test_mesh_axes_and_their_groups(world):
    """make_mesh(2, 2): rank r at (r // 2, r % 2), its data group the
    ranks of its column and its model group those of its row."""
    tp, ranks, _, _ = world
    if tp != 4:
        assert all("grid" not in r for r in ranks)
        return
    assert [r["grid"] for r in ranks] == [
        (0, 0, 2.0, 1.0), (0, 1, 4.0, 1.0), (1, 0, 2.0, 5.0),
        (1, 1, 4.0, 5.0)]


def test_embedding_gather(world):
    _, ranks, _, _ = world
    assert all(r["embed_equal"] for r in ranks)


def test_greedy_combine_and_ties(world):
    _, ranks, p, _ = world
    assert np.argmax(p["tie_logits"], axis=-1).tolist() == [5, 33, 20]
    argmax = np.argmax(p["h"] @ p["w"], axis=-1).tolist()
    for r in ranks:
        assert r["greedy_tie"] == [5, 33, 20]
        assert r["greedy_shard"] == argmax


def test_shard_sample_bit_equal_to_the_whole_row(world):
    _, ranks, _, _ = world
    for r in ranks:
        tok, score = r["sample_single"]
        assert r["sample_tok"] == tok
        np.testing.assert_array_equal(r["sample_best_score"], score)
        assert r["sample_tt_tok"] == r["sample_tt_single"]


def test_all_reduce_and_all_gather(world):
    """The sum and the stack of the ranks' rows, the same bits on every
    rank, the input left as it was."""
    tp, ranks, _, _ = world
    rows = [torch.randn((5, 12), generator=torch.Generator().manual_seed(i))
            .numpy() for i in range(tp)]
    total = sum(r.astype(np.float64) for r in rows)
    for r in ranks:
        assert r["psum_input_kept"]
        np.testing.assert_allclose(r["psum"], total, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(r["psum"], ranks[0]["psum"])
        # x + 0 = x: the gather is exact
        np.testing.assert_array_equal(r["gather"], np.stack(rows))
        np.testing.assert_array_equal(r["gather_cat"],
                                      np.concatenate(rows, axis=-1))


@pytest.mark.parametrize("leaf", ["dense", "packed", "int8_dense",
                                  "int8_packed"])
def test_matmul_column_and_row_splits(world, leaf):
    _, ranks, _, _ = world
    for r in ranks:
        for layout in ("col", "row"):
            key = f"split_{leaf}_{layout}"
            if key not in r:
                continue
            got, full = r[key]
            assert got.shape == full.shape
            if not np.issubdtype(got.dtype, np.floating) or (
                    leaf == "int8_packed" and layout == "col"):
                np.testing.assert_array_equal(got, full)
            else:
                err = np.abs(got - full).max()
                assert err <= R.SPLIT_TOL * np.abs(full).max(), (key, err)
    assert "split_int8_dense_row" in ranks[0]


def test_expert_parallel_moe_equals_local(world):
    _, ranks, _, want = world
    scale = np.abs(want["moe"]).max()
    for r in ranks:
        for impl in ("auto", "ep"):
            err = np.abs(r[f"ep_{impl}"] - want["moe"]).max()
            assert err <= MOE_TOL * scale, (impl, err)
        np.testing.assert_array_equal(r["ep_cut"], r["ep_ep"])
        np.testing.assert_array_equal(r["ep_auto"], ranks[0]["ep_auto"])
