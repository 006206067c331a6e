"""The w4 (INT4 nibble plane, groupwise scales) and INT8-valued DBB formats
of the port against the JAX reference, on the same numpy-seeded inputs.

Tolerances: none for the formats — packed planes (values, bitmask,
groupwise and per-channel scales), nibbles, decompressed weights,
quantized weights and footprints must be byte-equal (scales compared
bitwise). The GEMMs' plain versions against the Pallas kernels in
interpret mode: f32, rtol = atol = 1e-5 (the two sum in different
orders; the dequantized weights are the same bits). The smoke-width model:
hidden states rtol = atol = 1e-4, as tests/test_torch_model.py; greedy
`generate` and packed `serve` streams equal to the JAX engine's with
``gemm_impl="pallas"``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fixtures import configs, dense_params, prompts
from repro.config import DbbConfig as JDbbConfig
from repro.core import dbb as jdbb
from repro.core import quant as jquant
from repro.core.dbb_linear import decompress_xla
from repro.core.dbb_linear import pack_tree as jpack_tree
from repro.core.dbb_linear import tree_footprint_bytes as jfootprint
from repro.core.sparsity import apply_dbb_to_tree as japply
from repro.kernels import dispatch as jd
from repro.models import registry as jreg
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.config import DbbConfig as TDbbConfig
from repro_torch.core import dbb as tdbb
from repro_torch.core import quant as tquant
from repro_torch.core.dbb_linear import decompress
from repro_torch.core.dbb_linear import pack_tree as tpack_tree
from repro_torch.core.dbb_linear import tree_footprint_bytes as tfootprint
from repro_torch.core.sparsity import apply_dbb_to_tree as tapply
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch as td
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.dbb_gemm import dbb_gemm
from repro_torch.kernels.skinny import dbb_gemm_skinny
from repro_torch.models import registry as treg
from repro_torch.serve.engine import ServeEngine

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _bytes(a) -> bytes:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return np.ascontiguousarray(a).tobytes()


def _tbytes(t: torch.Tensor) -> bytes:
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return np.ascontiguousarray(t.numpy()).tobytes()


def _w4_weights(k: int, n: int, group: int, seed: int) -> np.ndarray:
    """Normal weights with the INT4 grid's hard cases built in: column 0
    has one outlier per group, so its other selected values round to 0
    (dead slots mid-block); column 1's second group is all zero (scale 1);
    column 2 holds exact ties."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32)
    w[:, 0] *= 1e-3
    w[::group, 0] = 50.0
    w[group:2 * group, 1] = 0.0
    w[:, 2] = rng.integers(-2, 3, k).astype(np.float32)
    return w


def _pack_both(w: np.ndarray, nnz: int, group: int):
    return (jdbb.pack_dbb(jnp.asarray(w), 8, nnz, bits=4, group=group),
            tdbb.pack_dbb(torch.from_numpy(w), 8, nnz, bits=4, group=group))


# ---------------------------------------------------------------------------
# the formats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nnz", [1, 3, 4])
@pytest.mark.parametrize("group", [8, 64, 128])
def test_pack_w4_planes_byte_equal(nnz, group):
    w = _w4_weights(256, 24, group, seed=nnz * 100 + group)
    jp, tp = _pack_both(w, nnz, group)
    assert (tp.bits, tp.group, tp.values.dtype) == (4, group, torch.int8)
    for f in ("values", "bitmask", "scale", "indices"):
        assert _bytes(getattr(jp, f)) == _tbytes(getattr(tp, f)), f
    # the built-in cases happened: a dead slot mid-block, a scale of 1
    q = tdbb.unpack_nibbles(tp.values).reshape(-1, nnz, 24)
    if nnz > 1:
        assert bool((q[:, :, 0] == 0).any())
    assert float(tp.scale[1 if group < 256 else 0, 1]) == 1.0
    assert jdbb.validate_dbb(jp) == tdbb.validate_dbb(tp) == (True, "ok")


def test_nibbles_byte_equal_over_the_full_range():
    q = np.tile(np.arange(-8, 8, dtype=np.int8), (2, 3)).reshape(16, 6)
    jpk = jdbb.pack_nibbles(jnp.asarray(q))
    tpk = tdbb.pack_nibbles(torch.from_numpy(q))
    assert tpk.dtype == torch.int8
    assert _bytes(jpk) == _tbytes(tpk)
    assert _tbytes(tdbb.unpack_nibbles(tpk)) == _bytes(
        jdbb.unpack_nibbles(jpk)) == q.tobytes()
    with pytest.raises(ValueError, match="even row count"):
        jdbb.pack_nibbles(jnp.asarray(q[:5]))
    with pytest.raises(ValueError, match="even row count"):
        tdbb.pack_nibbles(torch.from_numpy(q[:5]))


@pytest.mark.parametrize("stripped", [False, True])
def test_unpack_w4_bit_equal(stripped):
    """With indices (scatter path) and stripped (bitmask-rank path)."""
    jp, tp = _pack_both(_w4_weights(128, 40, 64, seed=5), 3, 64)
    if stripped:
        jp = dataclasses.replace(jp, indices=None)
        tp = dataclasses.replace(tp, indices=None)
    got = tdbb.unpack_dbb(tp)
    assert got.dtype == torch.float32
    assert _bytes(jdbb.unpack_dbb(jp)) == _tbytes(got)


@pytest.mark.parametrize("kw,match", [
    (dict(k=120, group=64), "not divisible by group"),
    (dict(k=128, group=12), "positive multiple"),
    (dict(k=24, group=8, nnz=3), "must be even"),
])
def test_w4_refusals_follow_reference(kw, match):
    w = np.ones((kw["k"], 8), np.float32)
    for pack, arr in ((jdbb.pack_dbb, jnp.asarray),
                      (tdbb.pack_dbb, torch.from_numpy)):
        with pytest.raises(ValueError, match=match):
            pack(arr(w), 8, kw.get("nnz", 4), bits=4, group=kw["group"])
        with pytest.raises(ValueError, match="derives groupwise scales"):
            pack(arr(np.ones((64, 8), np.float32)), 8, 4,
                 scale=arr(np.ones(8, np.float32)), bits=4, group=64)


@pytest.mark.parametrize("bits,group,nnz", [(8, 128, 4), (4, 128, 4),
                                            (4, 64, 2), (4, 32, 4)])
def test_footprints_match_reference(bits, group, nnz):
    kw = dict(block=8, nnz=nnz, weight_bits=bits, quant_group=group)
    assert (TDbbConfig(**kw).weight_footprint_ratio
            == JDbbConfig(**kw).weight_footprint_ratio)
    args = (2048, 8192, 8, nnz)
    fkw = dict(itemsize=1, bits=bits, group=group)
    assert (tdbb.dbb_footprint_bytes(*args, **fkw)
            == jdbb.dbb_footprint_bytes(*args, **fkw))
    assert tdbb.dense_footprint_bytes(2048, 8192, 2) == \
        jdbb.dense_footprint_bytes(2048, 8192, 2)


def test_quant_functions_match_reference():
    rng = np.random.default_rng(11)
    w = rng.standard_normal((96, 40)).astype(np.float32)
    w[:, 3] = 0.0                                    # a zero channel
    x = rng.standard_normal((5, 96)).astype(np.float32)
    jq = jquant.quantize_weight(jnp.asarray(w))
    tq = tquant.quantize_weight(torch.from_numpy(w))
    assert _bytes(jq.q) == _tbytes(tq.q) and _bytes(jq.scale) == _tbytes(
        tq.scale)
    assert _bytes(jquant.dequantize_weight(jq)) == _tbytes(
        tquant.dequantize_weight(tq))
    assert _bytes(jquant.act_scale(jnp.asarray(x))) == _tbytes(
        tquant.act_scale(torch.from_numpy(x)))
    np.testing.assert_allclose(
        tquant.int8_matmul(torch.from_numpy(x), tq).numpy(),
        np.asarray(jquant.int8_matmul(jnp.asarray(x), jq)), rtol=1e-6,
        atol=1e-6)
    np.testing.assert_allclose(float(tquant.quant_error(torch.from_numpy(w))),
                               float(jquant.quant_error(jnp.asarray(w))),
                               rtol=1e-5)


def _tree(rng):
    """Leaves on eligible paths: K 256 (w4 at G 128), K 192 (not divisible
    by 128: stays bits=8), a stacked [2, K, N] leaf, and an ineligible
    bias and norm."""
    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"layers": {"mlp": {"wi": {"w": w(2, 256, 48)},
                               "wo": {"w": w(2, 192, 40), "b": w(2, 40)}},
                       "attn": {"q_proj": {"w": w(256, 64)}}},
            "final_norm": {"scale": w(48)}}


def _walk_pairs(jtree, ttree, path=()):
    if isinstance(jtree, dict):
        for k in jtree:
            yield from _walk_pairs(jtree[k], ttree[k], path + (k,))
    else:
        yield path, jtree, ttree


@pytest.mark.parametrize("bits,group,nnz,quantize,bf16", [
    (4, 128, 4, False, False),
    (4, 128, 4, False, True),          # a bf16 leaf: cast to f32 first
    (4, 64, 3, False, False),          # K 192: K/8·3 = 72 rows, even
    (8, 128, 4, True, False),          # INT8 values, per-channel scales
    (4, 128, 4, True, True),           # w4 where eligible, INT8 elsewhere
])
def test_pack_tree_leaves_match_reference(bits, group, nnz, quantize, bf16):
    tree = _tree(np.random.default_rng(bits + group + nnz))
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ttree = params_from_numpy(tree)
    if bf16:        # the same bits: both round to nearest even
        q = ("layers", "attn", "q_proj")
        jtree["layers"]["attn"]["q_proj"]["w"] = jtree[q[0]][q[1]][q[2]][
            "w"].astype(jnp.bfloat16)
        ttree["layers"]["attn"]["q_proj"]["w"] = ttree[q[0]][q[1]][q[2]][
            "w"].to(torch.bfloat16)
    kw = dict(enabled=True, block=8, nnz=nnz, weight_bits=bits,
              quant_group=group, apply_to=("mlp", "attn_proj"))
    jt = jpack_tree(jtree, JDbbConfig(**kw), quantize=quantize)
    tt = tpack_tree(ttree, TDbbConfig(**kw), quantize=quantize)
    seen = set()
    for path, j, t in _walk_pairs(jt, tt):
        if not isinstance(j, jdbb.DbbWeight):
            assert not isinstance(t, tdbb.DbbWeight), path
            assert _bytes(j) == _tbytes(t), path
            continue
        assert isinstance(t, tdbb.DbbWeight) and t.indices is None
        assert (t.bits, t.group, t.k_dim, t.nnz) == (j.bits, j.group,
                                                     j.k_dim, j.nnz), path
        seen.add((t.bits, str(t.values.dtype)))
        for f in ("values", "bitmask", "scale"):
            jv, tv = getattr(j, f), getattr(t, f)
            assert (jv is None) == (tv is None), (path, f)
            if jv is not None:
                assert _bytes(jv) == _tbytes(tv), (path, f)
        assert _bytes(decompress_xla(j)) == _tbytes(decompress(t)), path
        assert _bytes(decompress_xla(j, dtype=jnp.bfloat16)) == _tbytes(
            decompress(t, dtype=torch.bfloat16)), path
    assert tfootprint(tt) == jfootprint(jt)
    if bits == 4:
        assert (4, "torch.int8") in seen
        # the K 192 leaf stays bits=8 where G does not divide it
        assert any(b == 8 for b, _ in seen) == bool(192 % group)
    if quantize:
        assert (8, "torch.int8") in seen


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _specs(m, k, n, *, item, bits, group, float_x=True, smoke=False):
    pallas = True
    vals_item = 1
    jspec = jd.OpSpec(domain="matmul", m=m, k=k, n=n, itemsize=item,
                      out_itemsize=item, packed=True, vals_itemsize=vals_item,
                      bits=bits, group=group, epilogue_ops=1, pallas=pallas,
                      float_ok=True)
    tspec = td.OpSpec(domain="matmul", m=m, k=k, n=n, packed=True,
                      bits=bits, group=group, pallas=pallas,
                      float_ok=float_x)
    return jspec, tspec


FULL_KN = ((2048, 2048), (2048, 8192), (8192, 2048))


@pytest.mark.parametrize("m,kn,item,group,want", [
    (8, FULL_KN, 2, 128, ("skinny_dbb_w4", "skinny_dbb")),   # decode
    (24, ((2048, 8192),), 2, 128, ("skinny_dbb_w4", "skinny_dbb")),
    (512, FULL_KN, 2, 128, ("dbb_packed_w4", "dbb_packed")),  # prefill
    (2048, FULL_KN, 2, 128, ("dbb_packed_w4", "dbb_packed")),
    (40, ((2048, 2048),), 2, 128, ("dbb_packed_w4", "dbb_packed")),
    (4, ((128, 256),), 4, 64, ("skinny_dbb_w4", "skinny_dbb")),  # smoke
    (12, ((128, 384),), 4, 64, ("skinny_dbb_w4", "skinny_dbb")),
])
def test_routes_match_reference(m, kn, item, group, want):
    """The table's shapes: w4 (G as given) and the INT8-valued plane."""
    jcfg, tcfg = configs()
    for k, n in kn:
        for bits, name in zip((4, 8), want):
            jspec, tspec = _specs(m, k, n, item=item, bits=bits,
                                  group=group if bits == 4 else 0)
            jname, _ = jd.select(jspec, jd.routes_from_cfg(jcfg))
            tname, treasons = td.select(tspec, td.routes_from_cfg(tcfg))
            assert tname == jname == name, (m, k, n, bits)
    # int8 activations: the w4 routes refuse them in both packages
    jspec = dataclasses.replace(jspec, itemsize=1, bits=4, group=128)
    tspec = dataclasses.replace(tspec, float_ok=False, bits=4, group=128)
    assert jd.select(jspec, {})[0] == td.select(tspec, {})[0] == "xla"
    assert "float x only" in td.select(tspec, {})[1]["dbb_packed_w4"]
    assert "nibble-packed" in td.select(
        dataclasses.replace(tspec, float_ok=True), {})[1]["dbb_packed"]


@pytest.mark.parametrize("m,fn,skinny", [(8, dbb_gemm_skinny, True),
                                         (40, dbb_gemm, False)])
@pytest.mark.parametrize("fmt,nnz,group", [("w4", 4, 64), ("w4", 3, 128),
                                           ("w4", 2, 8), ("i8", 4, 0),
                                           ("i8", 3, 0)])
def test_quantized_gemm_plain_matches_pallas(m, fn, skinny, fmt, nnz, group):
    """dbb_gemm_ref's w4 and INT8-plane branches (the wrappers on the CPU)
    against dbb_gemm_pallas / dbb_gemm_skinny_pallas in interpret mode,
    with bias and a fused activation (and the INT8 plane's per-channel
    scale in the epilogue)."""
    from repro.kernels.dbb_gemm.ops import dbb_gemm as jdbb_gemm
    rng = np.random.default_rng(m + nnz + group)
    k, n = 256, 136
    x = rng.standard_normal((m, k)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    if fmt == "w4":
        jp, tp = _pack_both(w, nnz, group)
        jkw = dict(bits=4, group=group, gscale=jp.scale)
        tkw = dict(bits=4, group=group, gscale=tp.scale)
        js = ts = None
    else:
        qw = jquant.quantize_weight(jnp.asarray(w))
        jp = jdbb.pack_dbb(qw.q, 8, nnz)
        tp = tdbb.pack_dbb(tquant.quantize_weight(torch.from_numpy(w)).q, 8,
                           nnz)
        assert tp.values.dtype == torch.int8
        js, ts, jkw, tkw = qw.scale, torch.tensor(np.asarray(qw.scale)), \
            {}, {}
    want = jdbb_gemm(jnp.asarray(x), jp.values, jp.bitmask,
                     jnp.asarray(bias), js, act="silu", block=8, nnz=nnz,
                     skinny=skinny, **jkw)
    before = dict(LAUNCHES)
    got = fn(torch.from_numpy(x), tp.values, tp.bitmask,
             torch.from_numpy(bias), ts, act="silu", nnz=nnz, **tkw)
    assert LAUNCHES == before          # the CPU path launches nothing
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("m", [8, 40])
@pytest.mark.parametrize("fmt", ["w4", "i8"])
def test_matmul_front_door_matches_reference(m, fmt):
    """dispatch.matmul on the kernel route with a caller scale (folded
    into the w4 group scales / the INT8 plane's epilogue scale), bias and
    act, against the reference's on the same leaf."""
    rng = np.random.default_rng(m)
    k, n = 128, 96
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    tree = {"mlp": {"wi": {"w": w}}}
    kw = dict(enabled=True, weight_bits=4 if fmt == "w4" else 8,
              quant_group=64)
    jleaf = jpack_tree(jax.tree_util.tree_map(jnp.asarray, tree),
                       JDbbConfig(**kw), quantize=True)["mlp"]["wi"]["w"]
    tleaf = tpack_tree(params_from_numpy(tree), TDbbConfig(**kw),
                       quantize=True)["mlp"]["wi"]["w"]
    want = jd.matmul(jnp.asarray(x), jleaf, jnp.asarray(bias),
                     jnp.asarray(scale), act="gelu", pallas=True)
    got = td.matmul(torch.from_numpy(x), tleaf, torch.from_numpy(bias),
                    torch.from_numpy(scale), act="gelu", pallas=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = td.matmul(torch.from_numpy(x), tleaf, torch.from_numpy(bias),
                      torch.from_numpy(scale), act="gelu", pallas=False)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **TOL)
    if fmt == "w4":
        # int8 activations: both packages refuse the w4 kernels and upcast
        # x on the plain route
        xi = np.clip(np.round(x * 30), -127, 127).astype(np.int8)
        want = jd.matmul(jnp.asarray(xi), jleaf, pallas=True)
        got = td.matmul(torch.from_numpy(xi), tleaf, pallas=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_conv_w4_leaf_decompresses_like_reference():
    """The conv front door takes a w4 leaf to the dense routes (the conv
    kernels stream the bits=8 plane only), as the reference does."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 6, 16)).astype(np.float32)
    w = rng.standard_normal((9 * 16, 32)).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    jp, tp = _pack_both(w, 4, 16)
    for use_kernel in (True, False):
        want = jd.conv(jnp.asarray(x), jp, jnp.asarray(bias), kh=3, kw=3,
                       act="relu", use_kernel=use_kernel)
        got = td.conv(torch.from_numpy(x), tp, torch.from_numpy(bias), kh=3,
                      kw=3, act="relu", use_kernel=use_kernel)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the smoke-width model and engine
# ---------------------------------------------------------------------------

FORMATS = {"w4": (dict(weight_bits=4, quant_group=64), False),
           "int8": ({}, True)}


@pytest.fixture(scope="module", params=sorted(FORMATS))
def model(request):
    """(format, reference config, port config, reference packed tree, port
    packed tree): the fixtures' smoke weights, projected and packed by
    each package in the format."""
    dbb_kw, quantize = FORMATS[request.param]
    jcfg, tcfg = configs()
    jcfg = jcfg.replace(dbb=dataclasses.replace(jcfg.dbb, **dbb_kw))
    tcfg = tcfg.replace(dbb=dataclasses.replace(tcfg.dbb, **dbb_kw))
    jdense, tdense = dense_params(seed=1)
    jp = jpack_tree(japply(jdense, jcfg.dbb, straight_through=False),
                    jcfg.dbb, quantize=quantize)
    tp = tpack_tree(tapply(tdense, tcfg.dbb), tcfg.dbb, quantize=quantize)
    leaf = tp["layers"]["mlp"]["wi"]["w"]
    assert (leaf.bits, str(leaf.values.dtype)) == (
        (4, "torch.int8") if request.param == "w4" else (8, "torch.int8"))
    return request.param, jcfg, tcfg, jp, tp


def test_model_hidden_states_match_reference(model):
    _, jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(3)
    tokens = rng.integers(2, 512, (4, 6)).astype(np.int32)
    nxt = rng.integers(2, 512, 4).astype(np.int32)
    jcache = jreg.init_cache(jcfg, 4, 8)
    tcache = treg.init_cache(tcfg, 4, 8, device="cpu")
    jh, jcache = jreg.prefill(jp, jcfg, tokens=jnp.asarray(tokens),
                              cache=jcache)
    th, tcache = treg.prefill(tp, tcfg, torch.from_numpy(tokens), tcache)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **MODEL_TOL)
    jh, _ = jreg.decode_step(jp, jcfg, jnp.asarray(nxt), jcache)
    th, _ = treg.decode_step(tp, tcfg, torch.from_numpy(nxt), tcache)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **MODEL_TOL)


SERVE_PROMPTS = [[5, 17, 3], [9, 9, 9], [42, 7], [4, 8, 15, 16], [23, 42],
                 [7, 7, 7]]
SERVE_BUDGETS = [4, 8, 2, 6, 3, 5]


def test_generate_and_serve_streams_equal_reference(model):
    """Greedy ``generate`` on ragged prompts and packed ``serve`` (6
    requests through 4 slots) give the JAX engine's streams."""
    _, jcfg, tcfg, jp, tp = model
    ps = prompts([5, 3, 7, 2], seed=6)
    teng = ServeEngine(tcfg, tp, max_batch=4, device="cpu")
    jeng = JEngine(jcfg, jp, max_batch=4)
    got = teng.generate(ps, max_new_tokens=6)
    assert got == jeng.generate(ps, max_new_tokens=6)
    assert sum(len(set(r)) > 2 for r in got) >= 2    # the layers matter
    assert teng.serve(SERVE_PROMPTS, max_new_tokens=SERVE_BUDGETS) == \
        jeng.serve(SERVE_PROMPTS, max_new_tokens=SERVE_BUDGETS)


def test_wrappers_refuse_what_the_w4_and_int8_branches_do_not_take():
    """The checks run before any launch, so the CPU shows them: int8
    activations, a wrong plane shape or dtype, a gscale of the wrong
    dtype, shape or presence, and a gscale on a bits=8 plane."""
    rng = np.random.default_rng(4)
    _, p = _pack_both(rng.standard_normal((256, 128)).astype(np.float32),
                      4, 64)
    x = torch.from_numpy(rng.standard_normal((8, 256)).astype(np.float32))
    kw = dict(bits=4, group=64, gscale=p.scale)
    for fn in (dbb_gemm, dbb_gemm_skinny):
        with pytest.raises(TypeError):                       # int8 x
            fn(x.to(torch.int8), p.values, p.bitmask, **kw)
        with pytest.raises(ValueError):                      # plane shape
            fn(x, p.values[:-1].contiguous(), p.bitmask, **kw)
        with pytest.raises(TypeError):                       # plane dtype
            fn(x, p.values.float(), p.bitmask, **kw)
        with pytest.raises(TypeError):                       # gscale dtype
            fn(x, p.values, p.bitmask, bits=4, group=64,
               gscale=p.scale.double())
        with pytest.raises(ValueError):                      # gscale shape
            fn(x, p.values, p.bitmask, bits=4, group=128, gscale=p.scale)
        with pytest.raises(ValueError, match="needs the groupwise"):
            fn(x, p.values, p.bitmask, bits=4, group=64)
        with pytest.raises(ValueError, match="bits=8 scales"):
            fn(x, torch.zeros((128, 128)), p.bitmask, gscale=p.scale)
        with pytest.raises(TypeError):                       # int16 plane
            fn(x, torch.zeros((128, 128), dtype=torch.int16), p.bitmask)
