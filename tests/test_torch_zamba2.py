"""The zamba2 family's modules against the reference, on the CPU in f32:
the SSD scan (recurrence and chunked form, each against the reference's
and against each other), the depthwise causal conv with and without a
carried context, the Mamba2 block at T = 1, at T a multiple of the chunk
and at any other T with a carried state and context; the ring-buffer
decode attention and its route; the config, its parameter count and the
initial tree's layout; and DBB packing of a zamba2 tree, leaf for leaf.

Tolerances: the module outputs within 1e-5 of max |value|; the shared
inputs come from numpy seeded per test.

Also here: the set-up the zamba2 model, serving and training tests share
(`zcfgs`, `ztrees`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.dbb_linear import pack_tree as jpack
from repro.core.sparsity import apply_dbb_to_tree as japply
from repro.models import attention as jattn
from repro.models import mamba2 as jm2
from repro.models import registry as jreg
from repro_torch.config import SsmConfig
from repro_torch.configs import get_config as tget
from repro_torch.core.dbb import DbbWeight
from repro_torch.core.dbb_linear import pack_tree as tpack
from repro_torch.core.sparsity import apply_dbb_to_tree as tapply
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.models import attention as tattn
from repro_torch.models import mamba2 as tm2
from repro_torch.models import registry as treg

torch.set_num_threads(1)
ARCH = "zamba2-1.2b"
MOD_TOL = 1e-5          # of max |value|, module level


# ---------------------------------------------------------------------------
# shared set-up
# ---------------------------------------------------------------------------

def zcfgs(gemm_impl: str = "xla", **kw):
    """(reference config, port config) of zamba2-1.2b smoke, f32."""
    kw = dict(kw, remat=kw.get("remat", "none"), gemm_impl=gemm_impl)
    return (jget(ARCH, smoke=True).replace(**kw),
            tget(ARCH, smoke=True).replace(**kw))


def _seeded(p, seed: int):
    """Every norm scale and ``d_skip`` 1 + 0.2 N(0, 1), the conv bias
    0.2 N(0, 1), from numpy seeded with ``seed``: the init's ones and
    zeros would leave those parameters untested. The embedding is scaled
    by 0.1 (zamba2 does not scale it by sqrt(d)), so the layers decide the
    hidden states rather than the token's own embedding."""
    rng = np.random.default_rng(seed + 1000)

    def visit(path, a):
        key = str(getattr(path[-1], "key", path[-1]))
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if key in ("scale", "d_skip"):
            return np.float32(1.0) + np.float32(0.2) * noise
        if key == "conv_b":
            return np.float32(0.2) * noise
        if key == "table":
            return a * np.float32(0.1)
        return a
    return jax.tree_util.tree_map_with_path(visit, p)


_TREES = {}


def ztrees(weights: str = "dense", seed: int = 0):
    """(reference tree, the same tree in the port): the reference's
    `init_params` with seeded norms (`_seeded`), dense, or DBB-projected
    and packed by the reference (``weights="packed"``)."""
    key = (weights, seed)
    if key not in _TREES:
        jcfg, _ = zcfgs()
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


def _close(got, want, tol=MOD_TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max() / scale)


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, b=2, t=64, h=3, p=8, n=16, state=False):
    x = _np(seed, b, t, h, p)
    bm, cm = _np(seed + 1, b, t, n), _np(seed + 2, b, t, n)
    la = -np.log1p(np.exp(_np(seed + 3, b, t, h))).astype(np.float32)
    s0 = _np(seed + 4, b, h, p, n) if state else np.zeros((b, h, p, n),
                                                         np.float32)
    return x, bm, cm, la, s0


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("form", ["recurrent", "chunked"])
def test_ssd_matches_reference(form, state):
    args = _ssd_inputs(1, state=state)
    if form == "recurrent":
        wy, ws = jm2.ssd_recurrent(*map(jnp.asarray, args))
        gy, gs = tm2.ssd_recurrent(*map(torch.from_numpy, args))
    else:
        wy, ws = jm2.ssd_chunked(*map(jnp.asarray, args), chunk=16)
        gy, gs = tm2.ssd_chunked(*map(torch.from_numpy, args), chunk=16)
    assert gy.dtype == gs.dtype == torch.float32
    _close(gy.numpy(), wy)
    _close(gs.numpy(), ws)


def test_ssd_chunked_equals_recurrent():
    """The reference's own case (tests/test_models.py): B2 T64 H3 P8 N16,
    chunk 16, within its tolerance (rtol / atol 2e-4)."""
    args = [torch.from_numpy(a) for a in _ssd_inputs(2)]
    y1, s1 = tm2.ssd_recurrent(*args)
    y2, s2 = tm2.ssd_chunked(*args, chunk=16)
    torch.testing.assert_close(y2, y1, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s2, s1, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tm2.ssd_chunked(*[a[:, :30] if a.ndim > 1 and a.shape[1] == 64
                          else a for a in args], chunk=16)


def test_ssd_chunked_takes_no_positive_exponent(monkeypatch):
    """The chunked form masks the upper triangle to -inf before exp, so
    every exponent it takes is <= 0 (each exp is at most 1)."""
    seen = []
    real = torch.exp

    def spy(a):
        seen.append(a.max().item())
        return real(a)
    monkeypatch.setattr(torch, "exp", spy)
    args = [torch.from_numpy(a) for a in _ssd_inputs(3)]
    tm2.ssd_chunked(*args, chunk=16)
    monkeypatch.undo()
    assert seen and max(seen) <= 0.0


def test_ssd_chunked_gradient_matches_jax_grad():
    """Under autograd each chunk is recomputed in the backward pass; the
    gradients are ``jax.grad``'s of the reference's chunked scan."""
    args = _ssd_inputs(4, t=32, state=True)

    def jloss(*a):
        y, s = jm2.ssd_chunked(*a, chunk=16)
        return jnp.sum(y * y) + jnp.sum(s)
    want = jax.grad(jloss, argnums=tuple(range(5)))(*map(jnp.asarray, args))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, s = tm2.ssd_chunked(*targs, chunk=16)
    got = torch.autograd.grad(y.square().sum() + s.sum(), targs)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


# ---------------------------------------------------------------------------
# the causal conv and the Mamba2 block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [1, 2, 9])
@pytest.mark.parametrize("ctx", [False, True])
def test_causal_conv_matches_reference(t, ctx):
    x, w, b = _np(5, 2, t, 24), _np(6, 4, 24), _np(7, 24)
    c = _np(8, 2, 3, 24) if ctx else None
    wo, wc = jm2._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              None if c is None else jnp.asarray(c))
    go, gc = tm2._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b),
                              None if c is None else torch.from_numpy(c))
    _close(go.numpy(), wo)
    assert np.array_equal(gc.numpy(), np.asarray(wc))


def test_softplus_is_logaddexp():
    x = torch.tensor([-100.0, -3.0, 0.0, 3.0, 19.0, 25.0, 100.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    # atol: XLA on the CPU flushes softplus(-100) = 3.8e-44, a denormal
    np.testing.assert_allclose(tm2._softplus(x).numpy(), want, rtol=1e-7,
                               atol=1e-30)


@pytest.mark.parametrize("t", [1, 32, 13])
@pytest.mark.parametrize("carry", [False, True])
def test_mamba2_apply_matches_reference(t, carry):
    """T 1 (the recurrence), 32 (the chunked scan: chunk 16) and 13 (the
    recurrence), from zero or from a carried state and conv context."""
    jcfg, tcfg = zcfgs()
    jp, tp = ztrees()
    lj = jax.tree_util.tree_map(lambda a: a[1], jp["layers"]["mamba"])
    lt = params_from_numpy(lj)
    d_in, h, p, n = tm2._dims(tcfg)
    x = _np(9, 2, t, tcfg.d_model)
    st = _np(10, 2, h, p, n) if carry else None
    cx = _np(11, 2, 3, d_in + 2 * n) if carry else None
    wy, (ws, wc) = jm2.mamba2_apply(
        lj, jcfg, jnp.asarray(x), state=None if st is None else
        jnp.asarray(st), conv_ctx=None if cx is None else jnp.asarray(cx))
    gy, (gs, gc) = tm2.mamba2_apply(
        lt, tcfg, torch.from_numpy(x),
        state=None if st is None else torch.from_numpy(st),
        conv_ctx=None if cx is None else torch.from_numpy(cx))
    _close(gy.numpy(), wy)
    _close(gs.numpy(), ws)
    _close(gc.numpy(), wc)
    if t == 1:
        dy, (ds, dc) = tm2.mamba2_decode_step(
            lt, tcfg, torch.from_numpy(x), (
                gs.new_zeros(gs.shape) if st is None
                else torch.from_numpy(st),
                gc.new_zeros(gc.shape) if cx is None
                else torch.from_numpy(cx)))
        assert torch.equal(dy, gy) and torch.equal(ds, gs)


def test_mamba2_apply_picks_the_reference_algorithm(monkeypatch):
    """T = 1 and T not a multiple of the chunk take the recurrence; a
    multiple of the chunk the chunked scan."""
    _, tcfg = zcfgs()
    lp = params_from_numpy(jax.tree_util.tree_map(
        lambda a: a[0], ztrees()[0]["layers"]["mamba"]))
    calls = []

    def spy(name):
        real = getattr(tm2, name)

        def run(*a, **k):
            calls.append(name)
            return real(*a, **k)
        return run
    for name in ("ssd_recurrent", "ssd_chunked"):
        monkeypatch.setattr(tm2, name, spy(name))
    for t in (1, 16, 48, 13, 17):
        tm2.mamba2_apply(lp, tcfg, torch.zeros((1, t, tcfg.d_model)))
    assert calls == ["ssd_recurrent", "ssd_chunked", "ssd_chunked",
                     "ssd_recurrent", "ssd_recurrent"]


def test_init_mamba_state_shapes():
    jcfg, tcfg = zcfgs()
    js, jc = jm2.init_mamba_state(jcfg, 3)
    ts, tc = tm2.init_mamba_state(tcfg, 3)
    assert tuple(ts.shape) == js.shape and tuple(tc.shape) == jc.shape
    assert ts.dtype == torch.float32 and not ts.any() and not tc.any()


# ---------------------------------------------------------------------------
# ring-buffer decode attention and its route
# ---------------------------------------------------------------------------

def test_ring_decode_route_is_the_plain_route():
    """A ring cache is refused by the paged kernel's guard with the
    reference's reason, on the kernel route family too."""
    _, tcfg = zcfgs("pallas")
    kw = dict(group=1, head_dim=32, page=16, smax=64)
    assert tdispatch.decode_attention_route(tcfg, **kw) == \
        "attn_decode_flash"
    assert tdispatch.decode_attention_route(tcfg, ring=True, **kw) == \
        "attn_decode_xla"
    rows = tdispatch.explain("attn_decode", m=1, k=32, n=64, page=16,
                             ring=True, cfg=tcfg)
    assert rows[0].name == "attn_decode_xla"
    reason = {r.name: r.reason for r in rows}["attn_decode_flash"]
    from repro.kernels import dispatch as jdispatch
    jspec = jdispatch.OpSpec(domain="attn_decode", m=1, k=32, n=64,
                             itemsize=4, page=16, ring=True,
                             flash_active=True)
    assert reason == jdispatch._guard_decode_flash(jspec) == \
        "ring-buffer (sliding-window) cache layout"


@pytest.mark.parametrize("gemm_impl", ["xla", "pallas"])
def test_ring_decode_attention_matches_reference(gemm_impl):
    """Rows at lengths 5, 63, 64 and 150 in a 64-slot ring: the new K/V
    land at ``length % 64`` (the last two wrap) and every written slot is
    attended."""
    jcfg, tcfg = zcfgs(gemm_impl)
    scj, sct = (c.replace(family="dense_lm") for c in (jcfg, tcfg))
    jp, _ = ztrees()
    sb = jp["shared_block"]["attn"]
    b, smax, hkv, hd = 4, 64, tcfg.num_kv_heads, tcfg.resolved_head_dim
    x = _np(12, b, 1, tcfg.d_model)
    ck, cv = _np(13, b, smax, hkv, hd), _np(14, b, smax, hkv, hd)
    lengths = np.array([5, 63, 64, 150], np.int32)
    wy, wk, wv = jattn.decode_attention_apply(
        sb, scj, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(lengths), ring=True)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    gy = tattn.decode_attention_apply(
        params_from_numpy(sb), sct, torch.from_numpy(x), tk, tv,
        torch.from_numpy(lengths), ring=True)
    _close(gy.numpy(), wy)
    _close(tk.numpy(), wk)
    _close(tv.numpy(), wv)
    # only slot length % 64 of each row is written (a non-ring cache
    # would clamp to slot 63)
    changed = (tk.numpy() != ck).any(axis=(2, 3))
    assert [list(np.flatnonzero(r)) for r in changed] == [[5], [63], [0],
                                                          [22]]


def test_decode_window_override_matches_reference():
    """``window_override`` replaces the config's window on the plain
    decode route."""
    jcfg, tcfg = zcfgs()
    scj, sct = (c.replace(family="dense_lm") for c in (jcfg, tcfg))
    jp, _ = ztrees()
    sb = jp["shared_block"]["attn"]
    x = _np(15, 2, 1, tcfg.d_model)
    ck, cv = _np(16, 2, 32, 4, 32), _np(17, 2, 32, 4, 32)
    lengths = np.array([20, 30], np.int32)
    wy, _, _ = jattn.decode_attention_apply(
        sb, scj, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(lengths), window_override=7)
    gy = tattn.decode_attention_apply(
        params_from_numpy(sb), sct, torch.from_numpy(x),
        torch.from_numpy(ck), torch.from_numpy(cv),
        torch.from_numpy(lengths), window_override=7)
    _close(gy.numpy(), wy)


# ---------------------------------------------------------------------------
# config, parameter count, init layout, packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference(smoke):
    j, t = jget(ARCH, smoke=smoke), tget(ARCH, smoke=smoke)
    assert dataclasses.asdict(t.ssm) == dataclasses.asdict(j.ssm)
    for f in ("family", "num_layers", "d_model", "num_heads", "num_kv_heads",
              "resolved_head_dim", "d_ff", "vocab_size", "norm", "act",
              "mlp_gated", "qkv_bias", "rope", "rope_theta", "dtype",
              "param_dtype", "remat", "tie_embeddings", "sliding_window"):
        assert getattr(t, f) == getattr(j, f), f
    assert dataclasses.asdict(t.dbb) == {
        k: v for k, v in dataclasses.asdict(j.dbb).items()
        if k in dataclasses.asdict(t.dbb)}
    assert t.param_count() == j.param_count()
    assert SsmConfig() == SsmConfig(**dataclasses.asdict(
        jget("olmo-1b").ssm))


def _layout(tree):
    out = {}

    def visit(path, a):
        out["/".join(str(getattr(k, "key", k)) for k in path)] = (
            tuple(a.shape), str(a.dtype))
    jax.tree_util.tree_map_with_path(visit, tree)
    return out


@pytest.mark.parametrize("by_layer", [False, True])
def test_init_tree_matches_reference_layout(by_layer):
    """`init_params` and `init_params_by_layer` give the reference's
    leaves, shapes and dtypes (``a_log``, ``dt_bias``, ``d_skip`` f32 at
    a bf16 ``param_dtype`` too); ``a_log`` is the reference's
    log(linspace(1, 16, H)), ``d_skip`` ones, and ``dt`` = softplus(
    dt_bias) lies in [1e-3, 1e-1]."""
    jcfg, tcfg = zcfgs(param_dtype="bfloat16")
    want = _layout(jax.eval_shape(
        lambda: jreg.init_params(jax.random.PRNGKey(0), jcfg)))
    tree = (treg.init_params_by_layer(tcfg, device="cpu") if by_layer
            else treg.init_params(tcfg, device="cpu"))
    got = _layout(jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(
            tuple(a.shape), str(a.dtype).replace("torch.", "")), tree))
    assert got == want
    m = tree["layers"]["mamba"]
    np.testing.assert_allclose(
        m["a_log"].numpy(), np.log(np.linspace(1.0, 16.0, 8))[None].repeat(
            4, 0), rtol=1e-6)
    assert torch.equal(m["d_skip"], torch.ones_like(m["d_skip"]))
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert (dt >= 1e-3 * 0.999).all() and (dt <= 1e-1 * 1.001).all()


def test_pack_tree_packs_the_reference_leaves():
    """The port's packer on a zamba2 tree packs exactly the leaves the
    reference's packs — the Mamba in/out projections and the shared
    block's projections and MLP, never conv_w, a_log, dt_bias, d_skip or
    a norm — with the same planes."""
    _, tcfg = zcfgs()
    _, tp = ztrees()
    jpacked, _ = ztrees("packed")        # the reference's packer's tree
    tpacked = tpack(tapply(tp, tcfg.dbb, straight_through=False), tcfg.dbb)
    jleaves = jax.tree_util.tree_flatten_with_path(
        jpacked, is_leaf=lambda a: hasattr(a, "bitmask"))[0]
    packed_paths = []
    for path, jl in jleaves:
        keys = [str(getattr(k, "key", k)) for k in path]
        tl = tpacked
        for k in keys:
            tl = tl[k]
        assert isinstance(tl, DbbWeight) == hasattr(jl, "bitmask"), keys
        if hasattr(jl, "bitmask"):
            packed_paths.append("/".join(keys[:-1]))
            assert np.array_equal(tl.values.numpy(), np.asarray(jl.values))
            assert np.array_equal(tl.bitmask.numpy().view(np.uint32),
                                  np.asarray(jl.bitmask))
            assert (tl.k_dim, tl.bits) == (jl.k_dim, jl.bits)
        else:
            assert np.array_equal(tl.numpy(), jl)
    assert sorted(packed_paths) == sorted(
        ["layers/mamba/in_proj", "layers/mamba/out_proj"]
        + [f"shared_block/attn/{k}_proj" for k in "qkvo"]
        + [f"shared_block/mlp/{k}" for k in ("wi", "wg", "wo")])


def test_interop_carries_a_zamba2_tree():
    """`params_from_numpy` carries every leaf of a packed zamba2 tree,
    f32 head vectors included."""
    jp, tp = ztrees("packed")
    assert isinstance(tp["shared_block"]["mlp"]["wi"]["w"], DbbWeight)
    assert tp["layers"]["mamba"]["a_log"].dtype == torch.float32
    assert np.array_equal(tp["layers"]["mamba"]["conv_w"].numpy(),
                          jp["layers"]["mamba"]["conv_w"])
