"""The port's sampling against the reference's (`repro.kernels.sample`,
`repro.serve.sampling`, the JAX engine), on the same numpy inputs.

The rule the tests hold: hashes and uniforms are bit-exact (the hash runs
on int64 holding uint32 values in the port); counts, RNG ordinals, the
penalties and the temperature scale are exact; anything through ``log``,
a softmax or a GEMV (the Gumbel noise, scores, probabilities) agrees
within 1e-5 relative (CPU ``torch.log`` and XLA's ``log`` may differ by an
ulp, GEMV sums in another order); and sampled indices are equal on every
row whose top-2 score margin exceeds the score tolerance. At the engine
level (smoke width, f32, the reference's Pallas kernels in interpret mode
against the port's plain versions) no sampled step fell within that
margin at these seeds, so the streams are compared whole — they must be
equal, and so must ``serve_stats``.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fixtures import configs, packed_params, prompts
from repro.kernels.sample import kernel as jkernel
from repro.kernels.sample import ref as jref
from repro.serve import sampling as jsampling
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.sample import ops as tops
from repro_torch.kernels.sample import ref as tref
from repro_torch.serve import sampling as tsampling
from repro_torch.serve.engine import ServeEngine

torch.set_num_threads(1)

RTOL = 1e-5          # anything through log / softmax / a GEMV

EDGE_SEEDS = np.array([0, 1, 0x7FFFFFFF, -1, -(1 << 31), 12345, -777],
                      np.int32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _j(a):
    return jnp.asarray(a)


# ---------------------------------------------------------------------------
# (1) the sampling math, function by function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("salt", [tref.SALT_TOKEN, tref.SALT_ACCEPT,
                                  tref.SALT_RESAMPLE])
def test_hash_and_uniforms_bit_exact(salt):
    """Edge seeds (0, 2^31-1, -1 and -2^31 as i32 bit patterns), steps
    and vocab ids up to 2^31-1 broadcast against each other."""
    assert (tref.SALT_TOKEN, tref.SALT_ACCEPT, tref.SALT_RESAMPLE) == (
        jref.SALT_TOKEN, jref.SALT_ACCEPT, jref.SALT_RESAMPLE)
    seed = EDGE_SEEDS[:, None, None]
    step = np.array([0, 1, 7, 1 << 20, 0x7FFFFFFF], np.int32)[None, :, None]
    idx = np.concatenate([np.arange(64), [50303, 1 << 24, 0x7FFFFFFF]]
                         ).astype(np.int32)[None, None, :]
    want_h = np.asarray(jref.hash_u32(_j(seed), _j(step), _j(idx), salt))
    got_h = tref.hash_u32(_t(seed), _t(step), _t(idx), salt).numpy()
    np.testing.assert_array_equal(got_h, want_h.astype(np.int64))
    want_u = np.asarray(jref.uniform_noise(_j(seed), _j(step), _j(idx), salt))
    got_u = tref.uniform_noise(_t(seed), _t(step), _t(idx), salt).numpy()
    assert got_u.dtype == np.float32
    np.testing.assert_array_equal(got_u.view(np.int32), want_u.view(np.int32))
    assert (got_u > 0).all() and (got_u < 1).all()
    want_g = np.asarray(jref.gumbel_noise(_j(seed), _j(step), _j(idx), salt))
    got_g = tref.gumbel_noise(_t(seed), _t(step), _t(idx), salt).numpy()
    np.testing.assert_allclose(got_g, want_g, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("seed", [0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF,
                                  (1 << 32) + 5, -1, 123456789])
def test_pack_params_wraps_seeds_like_the_reference(seed):
    kw = dict(temperature=0.7, top_k=5, top_p=0.9, repetition_penalty=1.3,
              presence_penalty=0.2, frequency_penalty=0.1, seed=seed)
    jf, ji = jsampling.pack_params(jsampling.SamplingParams(**kw))
    tf, ti = tsampling.pack_params(tsampling.SamplingParams(**kw))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32
    # the wrapped seed draws the reference's noise
    u = tref.uniform_noise(ti[1], 3, torch.arange(8), tref.SALT_TOKEN)
    ju = jref.uniform_noise(ji[1], jnp.int32(3), jnp.arange(8),
                            jref.SALT_TOKEN)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))


def _rows(b, v, seed):
    """Logits, counts (some rows above zero, repeats) and ragged knobs."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, v)) * 2).astype(np.float32)
    counts = rng.integers(0, 3, (b, v)).astype(np.int32)
    counts[::2] = 0                                # fresh rows
    counts[1, v // 2] = 4
    temp = np.array(([0.0, 0.7, 1.3, 0.05] * b)[:b], np.float32)
    rep = np.array(([1.0, 1.3, 0.8, 1.0] * b)[:b], np.float32)
    pres = np.array(([0.0, 0.25, 0.0, 0.5] * b)[:b], np.float32)
    freq = np.array(([0.0, 0.1, 0.3, 0.0] * b)[:b], np.float32)
    seed_ = EDGE_SEEDS[np.arange(b) % len(EDGE_SEEDS)]
    step = np.arange(b, dtype=np.int32) * 3
    return logits, counts, temp, rep, pres, freq, seed_, step


def test_penalties_and_temperature_exact():
    logits, counts, temp, rep, pres, freq, _, _ = _rows(6, 40, 1)
    c = lambda a: a[:, None]                      # noqa: E731
    want = jref.apply_penalties(_j(logits), _j(counts), _j(c(rep)),
                                _j(c(pres)), _j(c(freq)))
    got = tref.apply_penalties(_t(logits), _t(counts), _t(c(rep)),
                               _t(c(pres)), _t(c(freq)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # defaults are exact identities
    same = tref.apply_penalties(_t(logits), _t(counts),
                                torch.ones(6, 1), torch.zeros(6, 1),
                                torch.zeros(6, 1))
    np.testing.assert_array_equal(same.numpy(), logits)
    np.testing.assert_array_equal(
        tref.inv_temperature(_t(temp)).numpy(),
        np.asarray(jref.inv_temperature(_j(temp))))


def test_top_k_and_top_p_masks_equal_reference():
    logits, *_ = _rows(5, 48, 2)
    logits[3, 10:14] = logits[3, 9]               # a tie at the k-th value
    top_k = np.array([0, 1, 5, 10, 48], np.int32)
    top_p = np.array([1.0, 0.5, 0.9, 0.3, 0.99], np.float32)
    np.testing.assert_array_equal(
        tref.mask_top_k(_t(logits), _t(top_k)).numpy(),
        np.asarray(jref.mask_top_k(_j(logits), _j(top_k))))
    np.testing.assert_array_equal(
        tref.mask_top_p(_t(logits), _t(top_p)).numpy(),
        np.asarray(jref.mask_top_p(_j(logits), _j(top_p))))


def _decided(scores):
    """Rows whose top-2 score margin exceeds the score tolerance (RTOL of
    the row's best, on each side)."""
    top2 = np.sort(scores, axis=-1)[:, -2:]
    tol = 2 * RTOL * np.maximum(np.abs(top2[:, 1]), 1.0)
    return (top2[:, 1] - top2[:, 0]) > tol


@pytest.mark.parametrize("use_tt", [False, True])
@pytest.mark.parametrize("base", [0, 384])
def test_sample_scores_argmax_and_logits(use_tt, base):
    b, v = 8, 96
    logits, counts, temp, rep, pres, freq, seed, step = _rows(b, v, 3 + base)
    c = lambda a: a[:, None]                      # noqa: E731
    col = (base + np.arange(v, dtype=np.int32))[None, :]
    want_s = np.asarray(jref.sample_scores(
        _j(logits), _j(counts), _j(c(temp)), _j(c(rep)), _j(c(pres)),
        _j(c(freq)), _j(c(seed)), _j(c(step)), _j(col)))
    got_s = tref.sample_scores(
        _t(logits), _t(counts), _t(c(temp)), _t(c(rep)), _t(c(pres)),
        _t(c(freq)), _t(c(seed)), _t(c(step)), _t(col)).numpy()
    np.testing.assert_allclose(got_s, want_s, rtol=RTOL, atol=RTOL)
    top_k = np.array([0, 3, 0, 10, 1, 0, 7, 0], np.int32)
    top_p = np.array([1.0, 1.0, 0.8, 0.95, 1.0, 0.5, 1.0, 1.0], np.float32)
    tt = dict(top_k=top_k, top_p=top_p) if use_tt else {}
    ws, wi = jref.sample_argmax(
        _j(logits), _j(counts), _j(temp), _j(rep), _j(pres), _j(freq),
        _j(seed), _j(step), base=base, use_tt=use_tt,
        **{k: _j(a) for k, a in tt.items()})
    gs, gi = tref.sample_argmax(
        _t(logits), _t(counts), _t(temp), _t(rep), _t(pres), _t(freq),
        _t(seed), _t(step), base=base, use_tt=use_tt,
        **{k: _t(a) for k, a in tt.items()})
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=RTOL,
                               atol=RTOL)
    if use_tt:      # the scores sample_argmax takes its max over
        pen = tref.mask_top_p(tref.mask_top_k(tref.apply_penalties(
            _t(logits), _t(counts), _t(c(rep)), _t(c(pres)), _t(c(freq))),
            _t(top_k)), _t(top_p))
        g = tref.gumbel_noise(_t(c(seed)), _t(c(step)), _t(col), 0)
        t = _t(c(temp))
        got_s = torch.where(t > 0, pen * tref.inv_temperature(t) + g,
                            pen).numpy()
    ok = _decided(got_s)
    assert ok.sum() >= b - 1
    np.testing.assert_array_equal(gi.numpy()[ok], np.asarray(wi)[ok])
    assert gi.dtype == torch.int32
    got_tok = tref.sample_logits(
        _t(logits), _t(counts), _t(temp), _t(top_k), _t(top_p), _t(rep),
        _t(pres), _t(freq), _t(seed), _t(step), use_tt=use_tt)
    if base == 0:
        np.testing.assert_array_equal(got_tok.numpy()[ok],
                                      np.asarray(wi)[ok])
    # temperature-0 rows at default penalties are the plain argmax
    greedy = (temp == 0) & (rep == 1) & (pres == 0) & (freq == 0)
    if not use_tt:
        np.testing.assert_array_equal(gi.numpy()[greedy],
                                      logits.argmax(-1)[greedy])


def test_probs_from_logits_equal_reference():
    b, k, v = 4, 3, 32
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((b, k, v)) * 3).astype(np.float32)
    counts = rng.integers(0, 2, (b, 1, v)).astype(np.int32)
    temp = np.array([0.0, 0.8, 1.5, 0.0], np.float32).reshape(b, 1, 1)
    rep = np.array([1.0, 1.2, 0.9, 1.4], np.float32).reshape(b, 1, 1)
    pres = np.array([0.0, 0.1, 0.0, 0.3], np.float32).reshape(b, 1, 1)
    freq = np.array([0.0, 0.0, 0.2, 0.1], np.float32).reshape(b, 1, 1)
    args = (logits, counts, temp, rep, pres, freq)
    want = np.asarray(jref.probs_from_logits(*map(_j, args)))
    got = tref.probs_from_logits(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)
    np.testing.assert_array_equal(got[0], want[0])          # one-hot rows
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


# ---------------------------------------------------------------------------
# (2) the fused head's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

def _head_inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    counts = rng.integers(0, 2, (m, n)).astype(np.int32)
    counts[0] = 0
    knobs = _rows(m, 4, seed)[2:]
    return (h, w, counts) + tuple(knobs)


@pytest.mark.parametrize("m,k,n,base", [(8, 256, 384, 0), (3, 128, 256, 512),
                                        (8, 128, 512, 0)])
def test_plain_head_sample_equals_pallas_kernel(m, k, n, base):
    """`head_sample_fused` on CPU tensors (its plain version) and the
    dispatch's fused route against `head_sample_fused_pallas` in interpret
    mode: scores within 1e-5, indices equal where the top-2 margin
    exceeds the tolerance."""
    h, w, counts, temp, rep, pres, freq, seed, step = _head_inputs(
        m, k, n, 10 + m + base)
    mp = 8
    pad = mp - m

    def col(a, fill, dt):
        return np.pad(a.astype(dt), (0, pad),
                      constant_values=fill).reshape(mp, 1)
    ws, wi = jkernel.head_sample_fused_pallas(
        _j(np.pad(h, ((0, pad), (0, 0)))), _j(w),
        _j(np.pad(counts, ((0, pad), (0, 0)))),
        _j(col(temp, 0, np.float32)), _j(col(rep, 1, np.float32)),
        _j(col(pres, 0, np.float32)), _j(col(freq, 0, np.float32)),
        _j(col(seed, 0, np.int32)), _j(col(step, 0, np.int32)),
        _j(np.full((mp, 1), base, np.int32)), interpret=True)
    ws, wi = np.asarray(ws)[:m, 0], np.asarray(wi)[:m, 0]
    before = dict(LAUNCHES)
    gs, gi = tops.head_sample_fused(
        _t(h), _t(w), _t(counts), _t(temp), _t(rep), _t(pres), _t(freq),
        _t(seed), _t(step), base=base)
    ds, di = tdispatch.head_sample(
        _t(h), _t(w), _t(counts), _t(temp), _t(rep), _t(pres), _t(freq),
        _t(seed), _t(step), base=base, pallas=True, return_score=True)
    assert LAUNCHES == before                      # plain version on CPU
    np.testing.assert_array_equal(ds.numpy(), gs.numpy())
    np.testing.assert_array_equal(di.numpy(), gi.numpy())
    np.testing.assert_allclose(gs.numpy(), ws, rtol=RTOL, atol=RTOL)
    scores = tref.sample_scores(
        torch.matmul(_t(h), _t(w)), _t(counts), _t(temp[:, None]),
        _t(rep[:, None]), _t(pres[:, None]), _t(freq[:, None]),
        _t(seed[:, None]), _t(step[:, None]),
        torch.arange(n)[None, :] + base).numpy()
    ok = _decided(scores)
    assert ok.sum() >= m - 1
    np.testing.assert_array_equal(gi.numpy()[ok], wi[ok])


def test_head_sample_wrapper_refuses_what_the_kernel_does_not_take():
    h, w, counts, *rows = _head_inputs(8, 128, 256, 0)
    args = [_t(a) for a in rows]
    with pytest.raises(ValueError, match="M in"):
        tops.head_sample_fused(torch.zeros(33, 128), _t(w),
                               torch.zeros(33, 256, dtype=torch.int32),
                               *[torch.zeros(33, dtype=a.dtype)
                                 for a in args])
    with pytest.raises(ValueError, match="multiples of 128"):
        tops.head_sample_fused(_t(h), _t(w)[:, :200],
                               _t(counts)[:, :200].contiguous(), *args)
    with pytest.raises(TypeError, match="dtype"):
        tops.head_sample_fused(_t(h).double(), _t(w), _t(counts), *args)
    with pytest.raises(ValueError, match="temp"):
        tops.head_sample_fused(_t(h), _t(w), _t(counts), args[0][:4],
                               *args[1:])


# ---------------------------------------------------------------------------
# (3) the sampling state
# ---------------------------------------------------------------------------

SP_KW = [dict(temperature=0.8, seed=11),
         dict(temperature=1.2, seed=-5, repetition_penalty=1.3),
         dict(),
         dict(temperature=0.5, seed=1 << 31, presence_penalty=0.4,
              frequency_penalty=0.2),
         dict(temperature=0.9, seed=7, repetition_penalty=0.9),
         dict(temperature=0.0, seed=3, frequency_penalty=0.5)]


def test_state_helpers_equal_reference():
    jps = [jsampling.SamplingParams(**k) for k in SP_KW[:4]]
    tps = [tsampling.SamplingParams(**k) for k in SP_KW[:4]]
    js = jsampling.state_from_params(jps, 6, 64)
    ts = tsampling.state_from_params(tps, 6, 64)
    assert set(js) == set(ts)
    for key in js:
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))
        assert ts[key].dtype == {np.dtype("float32"): torch.float32,
                                 np.dtype("int32"): torch.int32}[
            np.asarray(js[key]).dtype]
    tok = np.array([3, 3, 9, 0, 63, 3], np.int32)
    jr = jsampling.record_tokens(js, _j(tok))
    tr = tsampling.record_tokens(ts, _t(tok))
    for key in ("counts", "step"):
        np.testing.assert_array_equal(tr[key].numpy(), np.asarray(jr[key]))
    # emit repeats a token within a row: the scatter accumulates
    emit = np.array([[5, 5, 5], [1, 2, 1], [0, 0, 0], [7, 8, 9],
                     [4, 4, 2], [6, 6, 6]], np.int32)
    n_emit = np.array([3, 2, 1, 3, 2, 1], np.int32)
    je = jsampling.record_emitted(jr, _j(emit), _j(n_emit))
    te = tsampling.record_emitted(tr, _t(emit), _t(n_emit))
    for key in ("counts", "step"):
        np.testing.assert_array_equal(te[key].numpy(), np.asarray(je[key]))
    fv, iv = zip(*(jsampling.pack_params(p) for p in jps))
    jf = jsampling.fresh_state(jnp.stack(fv), jnp.stack(iv), 64)
    tf = tsampling.fresh_state(_t(np.stack(fv)), _t(np.stack(iv)), 64)
    for key in jf:
        np.testing.assert_array_equal(tf[key].numpy(), np.asarray(jf[key]))
    js2 = jsampling.state_install(je, 1, fv[2], iv[2])
    ts2 = tsampling.state_install(te, 1, _t(fv[2]), _t(iv[2]))
    for key in js2:
        np.testing.assert_array_equal(ts2[key].numpy(), np.asarray(js2[key]))
    assert tsampling.any_uses_tt(tps) is False
    assert tsampling.any_uses_tt(tps + [tsampling.SamplingParams(top_p=0.5)])


def test_sampling_params_fields_match_reference():
    import dataclasses
    assert ([f.name for f in dataclasses.fields(tsampling.SamplingParams)]
            == [f.name for f in dataclasses.fields(jsampling.SamplingParams)])
    for kw in SP_KW + [dict(top_k=3), dict(top_p=0.7)]:
        jp, tp = (jsampling.SamplingParams(**kw),
                  tsampling.SamplingParams(**kw))
        assert (tp.uses_tt, tp.greedy) == (jp.uses_tt, jp.greedy)


# ---------------------------------------------------------------------------
# (4) sampled generate / serve against the JAX engine
# ---------------------------------------------------------------------------

PROMPTS = [[5, 17, 3], [9, 9, 9], [42, 7], [4, 8, 15, 16], [23, 42],
           [7, 7, 7]]
BUDGETS = [4, 8, 2, 6, 3, 5]
LONG_PROMPTS = prompts([19, 5, 12, 11, 3, 9], seed=4)


@pytest.fixture(scope="module")
def params():
    return packed_params(seed=1)


def _jsp(kws):
    return [jsampling.SamplingParams(**k) for k in kws]


def _tsp(kws):
    return [tsampling.SamplingParams(**k) for k in kws]


def _stats(eng):
    return {k: v for k, v in eng.serve_stats.items() if k != "ttft_s"}


@pytest.fixture(scope="module")
def reference(params):
    """The JAX engine's sampled streams, one contiguous engine for the
    packed / chunked / padded serves (sharing its compiled decode chunk)
    and one paged engine: {case: (tokens, serve_stats)}."""
    jp, _ = params
    jcfg, _ = configs(kv_page_size=8)
    out = {}
    cont = JEngine(jcfg, jp, max_batch=4, paged=False)
    sp = _jsp(SP_KW)
    for case, kw in (("packed", {}), ("chunked", dict(prefill_chunk=2)),
                     ("padded", dict(prefill_mode="padded"))):
        ps = LONG_PROMPTS if case == "chunked" else PROMPTS
        out[case] = (cont.serve(ps, max_new_tokens=BUDGETS, sampling=sp,
                                **kw), _stats(cont))
    paged = JEngine(jcfg, jp, max_batch=4)
    out["paged"] = (paged.serve(PROMPTS, max_new_tokens=BUDGETS,
                                sampling=sp), _stats(paged))
    return out


@pytest.mark.parametrize("case", ["packed", "chunked", "padded", "paged"])
def test_sampled_serve_equals_reference(params, reference, case,
                                       monkeypatch):
    """Ragged temperatures (0 to 1.2), seeds (one ≥ 2^31) and penalties,
    6 requests through 4 slots: the port's streams and serve_stats equal
    the JAX engine's; the sampled head took the fused route (its plain
    version: no kernel launch on the CPU)."""
    _, tp = params
    _, tcfg = configs(kv_page_size=8)
    kw = {"chunked": dict(prefill_chunk=2),
          "padded": dict(prefill_mode="padded")}.get(case, {})
    eng = ServeEngine(tcfg, tp, max_batch=4, paged=case == "paged",
                      device="cpu", **kw)
    routes = []
    real = tdispatch.select

    def spy(spec, cfg_routes=None):
        name, reasons = real(spec, cfg_routes)
        if spec.domain == "head_sample":
            routes.append(name)
        return name, reasons
    before = dict(LAUNCHES)
    monkeypatch.setattr(tdispatch, "select", spy)
    got = eng.serve(LONG_PROMPTS if case == "chunked" else PROMPTS,
                    max_new_tokens=BUDGETS, sampling=_tsp(SP_KW), **kw)
    want, stats = reference[case]
    assert got == want
    assert _stats(eng) == stats
    assert LAUNCHES == before
    assert set(routes) == {"head_sample_fused"}
    # the decode steps plus one head per prefill call
    n_prefill = stats.get("prefill_calls", sum(len(o) > 0 for o in got))
    assert len(routes) == eng.last_decode_steps + n_prefill


def test_sampled_generate_equals_reference_and_is_greedy_at_t0(params):
    """Static-batch sampled generate (ragged left-padded prompts) against
    the JAX engine; default SamplingParams give the greedy stream
    exactly."""
    jp, tp = params
    jcfg, tcfg = configs()
    ps = prompts([6, 3, 6, 2, 5, 1], seed=7)
    want = JEngine(jcfg, jp, max_batch=8).generate(
        ps, max_new_tokens=9, sampling=_jsp(SP_KW))
    eng = ServeEngine(tcfg, tp, max_batch=8, device="cpu")
    assert eng.generate(ps, max_new_tokens=9, sampling=_tsp(SP_KW)) == want
    greedy = eng.generate(ps, max_new_tokens=9)
    assert eng.generate(ps, max_new_tokens=9,
                        sampling=_tsp([{}] * len(ps))) == greedy
    # temperature makes a difference at these weights
    assert want != greedy


def test_top_k_row_takes_the_plain_sampler(params, monkeypatch):
    """A batch with a top-k request sends every sampled head (prefill and
    decode) to ``head_sample_xla``, the reference's route choice; its
    streams against the JAX engine's are in test_torch_spec.py."""
    _, tp = params
    _, tcfg = configs()
    kws = [dict(temperature=0.9, top_k=3, seed=1), dict(temperature=0.7,
                                                          seed=2)]
    routes = []
    real = tdispatch.select

    def spy(spec, cfg_routes=None):
        name, reasons = real(spec, cfg_routes)
        if spec.domain == "head_sample":
            routes.append(name)
        return name, reasons
    monkeypatch.setattr(tdispatch, "select", spy)
    eng = ServeEngine(tcfg, tp, max_batch=2, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")            # no spec: no warning
        out = eng.generate(PROMPTS[:2], max_new_tokens=6,
                           sampling=_tsp(kws))
    assert set(routes) == {"head_sample_xla"}
    assert all(len(r) == 6 for r in out)
