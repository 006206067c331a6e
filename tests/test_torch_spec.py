"""Self-speculative decode in the port against the reference's: the
acceptance rule on fixed p / q / draft inputs, the verify pass on both KV
caches, and ``draft_k=2`` streams of the JAX engine (smoke width, f32, the
reference's Pallas kernels in interpret mode against the port's plain
versions).

Tolerances: probabilities and hidden states within 1e-5 relative
(softmax, log and GEMV sums round in another order); acceptance
decisions and tokens equal — no decision at these seeds lies within that
tolerance of its threshold, so streams are compared whole. The paged and
contiguous caches are held bit-identical: the draft decodes through the
same paged kernel and verify gathers the same keys in the same order.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fixtures import configs, packed_params, prompts
from repro.models import registry as jreg
from repro.serve import sampling as jsampling
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.sample import ref as tref
from repro_torch.models import registry as treg
from repro_torch.serve import sampling as tsampling
from repro_torch.serve.engine import ServeEngine

torch.set_num_threads(1)

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _j(a):
    return jnp.asarray(a)


# ---------------------------------------------------------------------------
# the acceptance rule
# ---------------------------------------------------------------------------

def _probs(rng, b, t, v, temp0_rows=()):
    p = rng.gamma(0.5, size=(b, t, v)).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    for r in temp0_rows:                       # temperature 0: one-hot
        p[r] = np.eye(v, dtype=np.float32)[rng.integers(0, v, t)]
    return p


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_accept_speculative_equals_reference(seed):
    """Random p / q with drafts drawn from q, one temperature-0 (one-hot)
    row, and a row whose p equals q (every draft accepted: the bonus token
    comes from p_k)."""
    b, k, v = 5, 3, 40
    rng = np.random.default_rng(seed)
    q = _probs(rng, b, k, v, temp0_rows=(1,))
    p = _probs(rng, b, k + 1, v, temp0_rows=(1,))
    p[3, :k] = q[3]                             # all-accept row
    draft = np.stack([[rng.choice(v, p=q[r, i] / q[r, i].sum())
                       for i in range(k)] for r in range(b)]).astype(np.int32)
    p[1, :k] = q[1]                             # temp-0 row agrees ...
    p[1, 1] = np.roll(q[1, 1], 1)               # ... until position 1
    sd = np.array([7, -1, 0x7FFFFFFF, 12, 5], np.int32) + seed
    step = np.array([0, 3, 9, 1, 100], np.int32)
    je, jn = jsampling.accept_speculative(_j(draft), _j(p), _j(q), _j(sd),
                                          _j(step))
    te, tn = tsampling.accept_speculative(_t(draft), _t(p), _t(q), _t(sd),
                                          _t(step))
    jn, je = np.asarray(jn), np.asarray(je)
    np.testing.assert_array_equal(tn.numpy(), jn)
    for r in range(b):
        np.testing.assert_array_equal(te.numpy()[r, :jn[r]], je[r, :jn[r]])
    assert jn[3] == k + 1                       # bonus
    assert jn[1] == 2                           # temp 0: first mismatch at 1
    assert te[1, 1] == int(np.argmax(p[1, 1]))  # ... resampled greedily
    assert te.dtype == torch.int32 and tn.dtype == torch.int32


def test_speculative_accept_state_equals_reference():
    """From raw logits under mixed temperatures (0 included) and
    penalties with a non-empty history."""
    b, k, v = 4, 2, 48
    rng = np.random.default_rng(9)
    dl = (rng.standard_normal((b, k, v)) * 2).astype(np.float32)
    vl = (rng.standard_normal((b, k + 1, v)) * 2).astype(np.float32)
    vl[:, :k] += dl                             # related models
    draft = np.argmax(dl, -1).astype(np.int32)
    st = {"temp": np.array([0.0, 0.8, 1.1, 0.6], np.float32),
          "top_k": np.zeros(b, np.int32), "top_p": np.ones(b, np.float32),
          "rep": np.array([1.0, 1.2, 1.0, 0.9], np.float32),
          "pres": np.array([0.0, 0.0, 0.3, 0.1], np.float32),
          "freq": np.array([0.0, 0.1, 0.0, 0.2], np.float32),
          "seed": np.array([1, 2, 3, -4], np.int32),
          "step": np.array([1, 5, 2, 8], np.int32),
          "counts": rng.integers(0, 2, (b, v)).astype(np.int32)}
    je, jn = jsampling.speculative_accept_state(
        _j(draft), _j(dl), _j(vl), {kk: _j(a) for kk, a in st.items()})
    te, tn = tsampling.speculative_accept_state(
        _t(draft), _t(dl), _t(vl), {kk: _t(a) for kk, a in st.items()})
    jn = np.asarray(jn)
    np.testing.assert_array_equal(tn.numpy(), jn)
    for r in range(b):
        np.testing.assert_array_equal(te.numpy()[r, :jn[r]],
                                      np.asarray(je)[r, :jn[r]])


# ---------------------------------------------------------------------------
# the verify pass
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    return packed_params(seed=1)


@pytest.mark.parametrize("paged", [False, True])
def test_verify_step_equals_reference(params, paged):
    """Three candidates per row on a ragged (left-padded) cache: hidden
    states within 1e-5 of the reference's; the cache keeps its length and
    holds the candidates' K/V at slots length .. length+2."""
    jp, tp = params
    jcfg, tcfg = configs()
    ps = prompts([5, 2, 4], seed=3)
    toks = np.zeros((3, 5), np.int32)
    start = np.array([0, 3, 1], np.int32)
    for i, p in enumerate(ps):
        toks[i, 5 - len(p):] = p
    cand = np.array([[7, 8, 9], [10, 11, 12], [13, 14, 15]], np.int32)
    jc = jreg.init_cache(jcfg, 3, 16)
    _, jc = jreg.prefill(jax.tree_util.tree_map(jnp.asarray, jp), jcfg,
                         tokens=_j(toks), cache=jc, start=_j(start))
    want, jc2 = jreg.verify_step(jax.tree_util.tree_map(jnp.asarray, jp),
                                 jcfg, _j(cand), jc)
    tc = treg.init_cache(tcfg, 3, 16, device="cpu")
    _, tc = treg.prefill(tp, tcfg, _t(toks), tc, start=_t(start))
    if paged:                 # the same rows as two 8-slot pages each
        page = 8
        kp = tc["k"].reshape(tcfg.num_layers, 6, page, *tc["k"].shape[3:])
        vp = tc["v"].reshape(tcfg.num_layers, 6, page, *tc["v"].shape[3:])
        perm = torch.tensor([4, 0, 5, 2, 1, 3])   # shuffled physical pages
        inv = torch.argsort(perm)
        tc = {"k_pages": kp[:, inv].contiguous(),
              "v_pages": vp[:, inv].contiguous(),
              "block_table": perm.reshape(3, 2).to(torch.int32),
              "length": tc["length"], "start": tc["start"]}
    got, tc2 = treg.verify_step(tp, tcfg, _t(cand), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=RTOL)
    assert tc2["length"].tolist() == [5, 5, 5]
    if not paged:
        np.testing.assert_allclose(tc2["k"][:, :, 5:8].numpy(),
                                   np.asarray(jc2["k"])[:, :, 5:8],
                                   rtol=RTOL, atol=RTOL)


# ---------------------------------------------------------------------------
# the engine: draft_k=2 streams
# ---------------------------------------------------------------------------

PROMPTS = [[5, 17, 3], [9, 9, 9], [42, 7], [4, 8, 15, 16], [23, 42],
           [7, 7, 7]]
LONG_PROMPTS = prompts([19, 5, 12, 11, 3, 9], seed=4)
BUDGETS = [4, 8, 2, 6, 3, 5]
SP_KW = [dict(temperature=0.8, seed=11),
         dict(temperature=1.2, seed=-5, repetition_penalty=1.3),
         dict(),
         dict(temperature=0.5, seed=1 << 31, presence_penalty=0.4,
              frequency_penalty=0.2),
         dict(temperature=0.9, seed=7, repetition_penalty=0.9),
         dict(temperature=0.0, seed=3, frequency_penalty=0.5)]
CASES = {"packed": {}, "chunked": dict(prefill_chunk=2),
         "padded": dict(prefill_mode="padded")}


def _jsp(kws):
    return [jsampling.SamplingParams(**k) for k in kws]


def _tsp(kws):
    return [tsampling.SamplingParams(**k) for k in kws]


def _stats(eng):
    return {k: v for k, v in eng.serve_stats.items() if k != "ttft_s"}


@pytest.fixture(scope="module")
def reference(params):
    """The JAX engine's draft_k=2 streams on the contiguous cache: serve
    in the three prefill modes (one engine, sharing its compiled
    speculative chunk) and a static-batch generate."""
    jp, _ = params
    jcfg, _ = configs(kv_page_size=8)
    eng = JEngine(jcfg, jp, max_batch=4, paged=False)
    out = {}
    for case, kw in CASES.items():
        ps = LONG_PROMPTS if case == "chunked" else PROMPTS
        out[case] = (eng.serve(ps, max_new_tokens=BUDGETS,
                               sampling=_jsp(SP_KW), draft_k=2, **kw),
                     _stats(eng))
    out["generate"] = eng.generate(LONG_PROMPTS[:4], max_new_tokens=9,
                                   sampling=_jsp(SP_KW[:4]), draft_k=2)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_spec_serve_equals_reference_and_paged_equals_contiguous(
        params, reference, case):
    """serve(..., draft_k=2) on the contiguous cache equals the JAX
    engine's streams and serve_stats (spec_steps / spec_emitted included);
    the paged pool gives bit-identical streams. Spec decode
    runs no fused head (the draft and verify heads take the skinny GEMM
    and the plain sampler), and on the CPU nothing launches."""
    _, tp = params
    _, tcfg = configs(kv_page_size=8)
    kw = CASES[case]
    ps = LONG_PROMPTS if case == "chunked" else PROMPTS
    before = dict(LAUNCHES)
    outs, stats = {}, {}
    for paged in (False, True):
        eng = ServeEngine(tcfg, tp, max_batch=4, paged=paged, device="cpu",
                          **kw)
        outs[paged] = eng.serve(ps, max_new_tokens=BUDGETS,
                                sampling=_tsp(SP_KW), draft_k=2)
        stats[paged] = _stats(eng)
    want, wstats = reference[case]
    assert outs[False] == want
    assert stats[False] == wstats
    assert outs[True] == outs[False]
    # the same schedule; spec_emitted may differ, as in the reference: it
    # also counts steps past a row's budget, whose cache writes clamp
    # differently in the two layouts (none of those tokens is kept)
    assert stats[True]["spec_steps"] == stats[False]["spec_steps"]
    assert LAUNCHES == before
    assert stats[False]["spec_steps"] < stats[False]["spec_emitted"] \
        < 3 * stats[False]["spec_steps"]


def test_spec_generate_equals_reference(params, reference):
    _, tp = params
    _, tcfg = configs(kv_page_size=8)
    eng = ServeEngine(tcfg, tp, max_batch=4, device="cpu")
    got = eng.generate(LONG_PROMPTS[:4], max_new_tokens=9,
                       sampling=_tsp(SP_KW[:4]), draft_k=2)
    assert got == reference["generate"]
    # the engine-level default draft_k applies to sampled calls only
    eng2 = ServeEngine(tcfg, tp, max_batch=4, device="cpu", draft_k=2)
    assert eng2.generate(LONG_PROMPTS[:4], max_new_tokens=9,
                         sampling=_tsp(SP_KW[:4])) == got


@pytest.mark.parametrize("paged", [False, True])
def test_spec_at_temperature_zero_equals_greedy(params, paged):
    """Default SamplingParams (temperature 0) with draft_k=2 reproduce the
    greedy streams exactly, in serve on both caches and in generate."""
    _, tp = params
    _, tcfg = configs(kv_page_size=8)
    eng = ServeEngine(tcfg, tp, max_batch=4, paged=paged, device="cpu")
    greedy = eng.serve(LONG_PROMPTS, max_new_tokens=BUDGETS)
    spec = eng.serve(LONG_PROMPTS, max_new_tokens=BUDGETS,
                     sampling=_tsp([{}] * 6), draft_k=2)
    assert spec == greedy
    assert eng.serve_stats["spec_emitted"] > eng.serve_stats["spec_steps"]
    if not paged:
        g = eng.generate(LONG_PROMPTS[:4], max_new_tokens=9)
        s = eng.generate(LONG_PROMPTS[:4], max_new_tokens=9,
                         sampling=_tsp([{}] * 4), draft_k=2)
        assert s == g


def test_top_k_batch_gates_speculation_off_with_a_warning(params):
    """A top-k request turns speculation off (warning) and the call serves
    plain sampling on the plain sampler route: equal to the same call
    without draft_k, and to the JAX engine's."""
    jp, tp = params
    jcfg, tcfg = configs()
    kws = [dict(temperature=0.9, top_k=4, seed=i) for i in range(3)] + [
        dict(temperature=0.7, top_p=0.8, seed=9)]
    ps = LONG_PROMPTS[:4]
    eng = ServeEngine(tcfg, tp, max_batch=4, device="cpu")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        spec = eng.generate(ps, max_new_tokens=6, sampling=_tsp(kws),
                            draft_k=2)
    assert any("speculative decode disabled" in str(x.message) for x in w)
    assert spec == eng.generate(ps, max_new_tokens=6, sampling=_tsp(kws))
    want = JEngine(jcfg, jp, max_batch=4).generate(
        ps, max_new_tokens=6, sampling=_jsp(kws))
    assert spec == want


def test_spec_gates_and_arguments():
    """One-layer models cannot truncate a draft (warning, plain
    sampling); a draft as deep as the model is refused."""
    from repro_torch.serve.engine import make_spec_decode_step
    _, tcfg = configs()
    with pytest.raises(ValueError, match="draft_layers"):
        make_spec_decode_step(tcfg, 2, tcfg.num_layers)
    one = tcfg.replace(num_layers=1)
    params = treg.init_params(one, seed=0, device="cpu")
    eng = ServeEngine(one, params, max_batch=2, device="cpu")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = eng.generate([[3, 4], [5]], max_new_tokens=3,
                           sampling=_tsp([dict(temperature=0.5)] * 2),
                           draft_k=2)
    assert any("num_layers >= 2" in str(x.message) for x in w)
    assert [len(r) for r in out] == [3, 3]
    assert tref.NEG_INF == -1e30
