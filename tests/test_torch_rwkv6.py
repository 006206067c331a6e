"""The rwkv6 family's layer (`repro_torch.models.rwkv6`) against the
reference's (`repro.models.rwkv6`), function by function, on the CPU in
f32, plus the shared set-up of the rwkv6 test files (`rcfgs`, `rtrees`).

* the WKV core: the reference's own chunked-equals-recurrent test, ported;
  both forms against the reference's with a carried state, over a chunk
  boundary, with decays near the clip (log decays -exp(4) and -exp(-8));
* `_token_shift`, `_ddlerp` (mixes clipped to [0, 1] at both ends),
  `_decay` (clipped at both ends), `_time_mix` (recurrent and chunked),
  `_channel_mix`, `init_rwkv_state`, `rwkv6_layer_apply` (chunked, a T
  the chunk does not divide — the recurrence —, a state carried across
  two calls equal to one call) and `rwkv6_decode_step`;
* the layer's parameter layout against the reference's init;
* the port's configs: the reference's 12 archs, rwkv6-1.6b / paligemma-3b
  / musicgen-medium field for field, `param_count` equal on every config.

Weights (`rtrees`): the reference's `init_params` with seeded values where
the init's constants would leave a parameter untested: norm scales 1 +
0.2 N(0, 1) and biases 0.2 N(0, 1), the lerp bases ``mu`` uniform in [0,
1], the two LoRA B matrices 40 x the init's (so the mixes reach the clip),
``w0`` uniform in [-9, 5] (so the decays reach both ends of the clip), the
embedding 0.1 x.

Tolerance: 1e-5 of max |value| for the core functions, 1e-4 for a layer
and for the WKV with decays at the clip (the two packages sum in
different orders, and at the clip the chunk's terms span many orders of
magnitude); the ported chunked-vs-recurrent test at its own 2e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget
from repro.core.dbb_linear import pack_tree as jpack
from repro.core.sparsity import apply_dbb_to_tree as japply
from repro.models import registry as jreg
from repro.models import rwkv6 as jrw
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import get_config as tget
from repro_torch.interop import params_from_numpy
from repro_torch.models import registry as treg
from repro_torch.models import rwkv6 as trw

torch.set_num_threads(1)
ARCH = "rwkv6-1.6b"
CORE_TOL, LAYER_TOL = 1e-5, 1e-4
_TREES = {}


def rcfgs(gemm_impl: str = "xla", **kw):
    """(reference config, port config) of rwkv6-1.6b smoke (2 layers, d
    128, two WKV heads of 64, chunk 16), f32."""
    kw = dict(kw, remat=kw.get("remat", "none"), gemm_impl=gemm_impl)
    return (jget(ARCH, smoke=True).replace(**kw),
            tget(ARCH, smoke=True).replace(**kw))


def _seeded(p, seed: int):
    """The module docstring's seeded values, from numpy seeded with
    ``seed``."""
    rng = np.random.default_rng(seed + 1000)

    def visit(path, a):
        key = str(getattr(path[-1], "key", path[-1]))
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if key == "scale":
            return np.float32(1.0) + np.float32(0.2) * noise
        if key == "bias":
            return np.float32(0.2) * noise
        if key == "mu":
            return rng.uniform(0.0, 1.0, a.shape).astype(np.float32)
        if key in ("lora_b", "w_lora_b"):
            return a * np.float32(40.0)
        if key == "w0":
            return rng.uniform(-9.0, 5.0, a.shape).astype(np.float32)
        if key == "table":
            return a * np.float32(0.1)
        return a
    return jax.tree_util.tree_map_with_path(visit, p)


def rtrees(weights: str = "dense", seed: int = 0):
    """(reference tree, the same tree in the port): seeded (`_seeded`),
    dense, or DBB-projected and packed by the reference (``weights=
    "packed"``)."""
    key = (weights, seed)
    if key not in _TREES:
        jcfg, _ = rcfgs()
        p = _seeded(jax.tree_util.tree_map(
            np.asarray, jreg.init_params(jax.random.PRNGKey(seed), jcfg)),
            seed)
        if weights == "packed":
            p = jax.tree_util.tree_map(np.asarray, jpack(
                japply(p, jcfg.dbb, straight_through=False), jcfg.dbb))
        _TREES[key] = (p, params_from_numpy(p))
    return _TREES[key]


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max() / scale)


def _layer(seed=0, l=0):
    """Layer ``l`` of the seeded dense tree: (reference dict, port dict)."""
    jp, tp = rtrees(seed=seed)
    pick = jax.tree_util.tree_map(lambda a: a[l], jp["layers"])
    return pick, params_from_numpy(pick)


# ---------------------------------------------------------------------------
# the WKV core
# ---------------------------------------------------------------------------

def _wkv_inputs(seed, b=2, t=64, h=2, d=16, state=False, clip=False):
    r, k, v = (_np(seed + i, b, t, h, d) for i in range(3))
    if clip:           # log decays at both ends of the clip
        lw = np.where(_np(seed + 3, b, t, h, d) > 0, -np.exp(4.0),
                      -np.exp(-8.0)).astype(np.float32)
    else:
        lw = -np.exp(_np(seed + 3, b, t, h, d, scale=0.5))
    u = _np(seed + 4, h, d)
    s0 = (_np(seed + 5, b, h, d, d) if state
          else np.zeros((b, h, d, d), np.float32))
    return r, k, v, lw.astype(np.float32), u, s0


def test_chunked_equals_recurrent():
    """The reference's test_rwkv_chunked_equals_recurrent, on the port."""
    r, k, v, lw, u, s0 = (torch.from_numpy(a) for a in _wkv_inputs(0))
    y1, st1 = trw.wkv_recurrent(r, k, v, lw, u, s0)
    y2, st2 = trw.wkv_chunked(r, k, v, lw, u, s0, chunk=16)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(st1.numpy(), st2.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("form", ["recurrent", "chunked"])
@pytest.mark.parametrize("state,clip", [(False, False), (True, False),
                                        (True, True)])
def test_wkv_matches_reference(form, state, clip):
    """T 48 over chunks of 16 (two chunk boundaries), from zeros or a
    carried state, decays in range or at both ends of the clip."""
    a = _wkv_inputs(7, t=48, state=state, clip=clip)
    jfn, tfn = ((jrw.wkv_recurrent, trw.wkv_recurrent) if form == "recurrent"
                else (lambda *x: jrw.wkv_chunked(*x, chunk=16),
                      lambda *x: trw.wkv_chunked(*x, chunk=16)))
    jy, js = jfn(*map(jnp.asarray, a))
    ty, ts = tfn(*map(torch.from_numpy, a))
    tol = LAYER_TOL if clip else CORE_TOL
    _close(ty.numpy(), jy, tol)
    _close(ts.numpy(), js, tol)


def test_wkv_chunked_refuses_a_ragged_t():
    a = [torch.from_numpy(x) for x in _wkv_inputs(1, t=20)]
    with pytest.raises(ValueError, match="multiple of chunk"):
        trw.wkv_chunked(*a, chunk=16)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("last", [False, True])
def test_token_shift_matches_reference(last):
    x = _np(2, 2, 9, 128)
    prev = _np(3, 2, 128) if last else None
    want = jrw._token_shift(jnp.asarray(x),
                            None if prev is None else jnp.asarray(prev))
    got = trw._token_shift(torch.from_numpy(x),
                           None if prev is None else torch.from_numpy(prev))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ddlerp_and_decay_match_reference_and_reach_the_clips():
    jl, tl = _layer()
    x, sx = _np(4, 2, 9, 128), _np(5, 2, 9, 128)
    want = jrw._ddlerp(jl["time_mix"], jnp.asarray(x), jnp.asarray(sx))
    got = trw._ddlerp(tl["time_mix"], torch.from_numpy(x),
                      torch.from_numpy(sx))
    for g, w in zip(got, want):
        _close(g.numpy(), w, CORE_TOL)
    # the seeded mixes reach both ends of [0, 1]
    adj = (np.tanh((sx + (x - sx) * 0.5) @ jl["time_mix"]["lora_a"])
           @ jl["time_mix"]["lora_b"]).reshape(2, 9, 5, 128)
    mix = jl["time_mix"]["mu"] + adj
    assert (mix < 0).any() and (mix > 1).any()
    jd = jrw._decay(jl["time_mix"], jnp.asarray(x))
    td = trw._decay(tl["time_mix"], torch.from_numpy(x))
    _close(td.numpy(), jd, CORE_TOL)
    assert td.min() == pytest.approx(-np.exp(4.0))
    assert td.max() == pytest.approx(-np.exp(-8.0))


@pytest.mark.parametrize("t,chunk", [(1, 16), (32, 16), (32, 1)])
def test_time_mix_matches_reference(t, chunk):
    """One token and ``chunk`` 1 take the recurrence, else the chunked
    WKV; from a carried state."""
    jcfg, tcfg = rcfgs()
    jl, tl = _layer()
    x, sx = _np(6, 2, t, 128), _np(7, 2, t, 128)
    s0 = _np(8, 2, 2, 64, 64, scale=0.1)
    jy, js = jrw._time_mix(jl["time_mix"], jcfg, jnp.asarray(x),
                           jnp.asarray(sx), jnp.asarray(s0), chunk=chunk)
    ty, ts = trw._time_mix(tl["time_mix"], tcfg, torch.from_numpy(x),
                           torch.from_numpy(sx), torch.from_numpy(s0),
                           chunk=chunk)
    _close(ty.numpy(), jy, LAYER_TOL)
    _close(ts.numpy(), js, LAYER_TOL)


def test_channel_mix_matches_reference():
    jl, tl = _layer(l=1)
    x, sx = _np(9, 2, 9, 128), _np(10, 2, 9, 128)
    want = jrw._channel_mix(jl["channel_mix"], jnp.asarray(x),
                            jnp.asarray(sx))
    got = trw._channel_mix(tl["channel_mix"], torch.from_numpy(x),
                           torch.from_numpy(sx))
    _close(got.numpy(), want, CORE_TOL)


def test_init_rwkv_state_matches_reference():
    jcfg, tcfg = rcfgs()
    want = jrw.init_rwkv_state(jcfg, 3, jnp.bfloat16)
    got = trw.init_rwkv_state(tcfg, 3, torch.bfloat16)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert not got[k].any()


def _state_np(seed, b=2):
    return {"wkv": _np(seed, b, 2, 64, 64, scale=0.1),
            "shift_tm": _np(seed + 1, b, 128),
            "shift_cm": _np(seed + 2, b, 128)}


@pytest.mark.parametrize("t,state", [(32, False), (20, False), (32, True),
                                     (20, True)])
def test_layer_apply_matches_reference(t, state):
    """T 32 takes the chunked WKV (chunk 16), T 20 the recurrence (16 does
    not divide it); from zeros or a given state; every state leaf."""
    jcfg, tcfg = rcfgs()
    jl, tl = _layer()
    x = _np(11, 2, t, 128)
    st = _state_np(12) if state else None
    jy, js = jrw.rwkv6_layer_apply(
        jl, jcfg, jnp.asarray(x),
        None if st is None else {k: jnp.asarray(v) for k, v in st.items()})
    ty, ts = trw.rwkv6_layer_apply(
        tl, tcfg, torch.from_numpy(x),
        None if st is None else {k: torch.from_numpy(v)
                                 for k, v in st.items()})
    _close(ty.numpy(), jy, LAYER_TOL)
    assert set(ts) == set(js)
    for k in js:
        _close(ts[k].numpy(), js[k], LAYER_TOL)


def test_state_carried_across_calls_equals_one_call():
    """The first 16 tokens, then the next 16 from the returned state, equal
    one call over all 32 (both chunked), output and state."""
    _, tcfg = rcfgs()
    _, tl = _layer()
    x = torch.from_numpy(_np(13, 2, 32, 128))
    y, st = trw.rwkv6_layer_apply(tl, tcfg, x)
    y1, st1 = trw.rwkv6_layer_apply(tl, tcfg, x[:, :16])
    y2, st2 = trw.rwkv6_layer_apply(tl, tcfg, x[:, 16:], state=st1)
    _close(torch.cat([y1, y2], 1).numpy(), y.numpy(), LAYER_TOL)
    for k in st:
        _close(st2[k].numpy(), st[k].numpy(), LAYER_TOL)


def test_decode_step_matches_reference():
    jcfg, tcfg = rcfgs()
    jl, tl = _layer(l=1)
    x = _np(14, 3, 1, 128)
    st = _state_np(15, b=3)
    jy, js = jrw.rwkv6_decode_step(jl, jcfg, jnp.asarray(x),
                                   {k: jnp.asarray(v) for k, v in st.items()})
    ty, ts = trw.rwkv6_decode_step(tl, tcfg, torch.from_numpy(x),
                                   {k: torch.from_numpy(v)
                                    for k, v in st.items()})
    _close(ty.numpy(), jy, LAYER_TOL)
    for k in js:
        _close(ts[k].numpy(), js[k], LAYER_TOL)


def test_layer_init_matches_reference_layout():
    """The port's init draws every leaf the reference's does, stacked [L,
    ...], same shape and dtype (w0 and u in f32)."""
    jcfg, tcfg = rcfgs()
    jt = jax.eval_shape(lambda k: jreg.init_params(k, jcfg),
                        jax.random.PRNGKey(0))
    tt = treg.init_params(tcfg, seed=0, device="cpu")

    def walk(j, t, path=""):
        assert isinstance(t, dict) == isinstance(j, dict), path
        if isinstance(j, dict):
            assert set(j) == set(t), path
            for k in j:
                walk(j[k], t[k], f"{path}/{k}")
        else:
            assert tuple(t.shape) == tuple(j.shape), path
            assert str(t.dtype).split(".")[-1] == str(j.dtype), path
    walk(jt, tt)
    tm = tt["layers"]["time_mix"]
    assert float(tm["w0"].mean()) == pytest.approx(-4.0, abs=0.3)
    assert torch.equal(tm["mu"], torch.full_like(tm["mu"], 0.5))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_archs_equal_the_reference():
    assert set(TARCHS) == set(JARCHS)
    assert len(TARCHS) == 12


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "paligemma-3b",
                                  "musicgen-medium"])
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_the_reference(arch, smoke):
    """Every field the port's config has equals the reference's, and so
    do param_count and the family properties."""
    j, t = jget(arch, smoke=smoke), tget(arch, smoke=smoke)
    for f in dataclasses.fields(t):
        if f.name in ("moe", "ssm", "dbb"):
            tv, jv = dataclasses.asdict(getattr(t, f.name)), \
                dataclasses.asdict(getattr(j, f.name))
            assert tv == {k: jv[k] for k in tv}, f.name
        elif hasattr(j, f.name):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.param_count() == j.param_count()
    assert t.is_attention_free == j.is_attention_free
    assert t.supports_long_context == j.supports_long_context
