"""The port's INT8 × INT8 → INT32 datapath against the JAX package on the
CPU, on the same numpy-seeded inputs: `apply_epilogue` on int32
accumulators; each int8 kernel branch's plain version against its Pallas
kernel (interpret mode, as the reference's own tests run it); the
`dispatch.matmul` and `dispatch.conv` front doors on int8 activations with
dense and INT8-valued DBB weights, on automatic and forced routes; the
route table's int8 rows; the two K = 1179 all-127 probes (sums past 2^24,
where an f32 accumulator rounds); and the convnet INT8 chain at smoke
width (quantize, conv with x_s·w_s fused, bias and relu to f32, max-pool,
requantize, …, classifier).

Tolerances: int32 outputs bit-equal; int8 outputs after act none or relu
bit-equal; f32 outputs rtol 1e-6 with atol 1e-7·max|want| (the two
libraries' tanh / exp may differ by an ulp where gelu or silu cancels);
int8 and int32 outputs after gelu or silu (rounded or truncated from
such an f32) off by at most 1 on at most 0.1% of the elements (at least
one).

tests/test_torch_gpu.py holds each CUDA int8 branch against its plain
version on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import quant as jquant
from repro.core.dbb import pack_dbb as jpack
from repro.core.dbb_linear import pack_tree as jpack_tree
from repro.core.sparsity import apply_dbb_to_tree as jproject
from repro.kernels import dispatch as jd
from repro.kernels.conv_gemm.ops import conv_gemm as jconv_gemm
from repro.kernels.conv_gemm.ops import conv_gemm_dbb as jconv_gemm_dbb
from repro.kernels.dbb_gemm.ops import dbb_gemm as jdbb_gemm
from repro.kernels.epilogue import Epilogue as JEpilogue
from repro.kernels.epilogue import apply_epilogue as japply_epilogue
from repro.kernels.sta_gemm.ops import sta_gemm as jsta_gemm
from repro.models import registry as jregistry
from repro_torch.configs import get_config as tget
from repro_torch.core.dbb import DbbWeight
from repro_torch.core.quant import QuantizedWeight, act_scale
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch as td
from repro_torch.kernels.conv_gemm import conv_gemm, conv_gemm_dbb
from repro_torch.kernels.dbb_gemm import dbb_gemm
from repro_torch.kernels.epilogue import Epilogue, apply_epilogue
from repro_torch.kernels.skinny import dbb_gemm_skinny, sta_gemm_skinny
from repro_torch.kernels.sta_gemm import sta_gemm
from repro_torch.models.cnn import max_pool_2x2

torch.set_num_threads(1)
I8, I32, F32 = torch.int8, torch.int32, torch.float32
_JNP = {I8: jnp.int8, I32: jnp.int32, F32: jnp.float32, None: None}


def _check(got: torch.Tensor, want, act: str) -> None:
    """The module doc's tolerances."""
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype == np.float32:
        np.testing.assert_allclose(
            got, want, rtol=1e-6, atol=1e-7 * float(np.abs(want).max()))
    elif act in ("none", "relu"):
        np.testing.assert_array_equal(got, want)
    else:
        diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert diff.max() <= 1
        assert int((diff > 0).sum()) <= max(1, want.size // 1000)


def _ints(r, shape, lo=-127, hi=128):
    return r.integers(lo, hi, shape).astype(np.int8)


def _epilogue_rows(r, n):
    bias = (r.standard_normal(n) * 50).astype(np.float32)
    scale = ((r.random(n) + 0.5) * 2e-3).astype(np.float32)
    return bias, scale


# (act, out dtype, with scale, with bias): the raw int32 sum; a relu'd
# requant; dequant + bias + silu (f32 by default); requant after gelu
EPILOGUES = [("none", None, False, False), ("relu", I8, True, False),
             ("silu", None, True, True), ("gelu", I8, True, True)]


def _pick(bias, scale, has_scale, has_bias):
    return (bias if has_bias else None), (scale if has_scale else None)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# the epilogue on int32 accumulators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("has_scale,has_bias", [(False, False), (True, False),
                                                (False, True), (True, True)])
@pytest.mark.parametrize("out", [I32, F32, I8])
@pytest.mark.parametrize("act", ["none", "relu", "gelu", "silu"])
def test_epilogue_on_int32_accumulators(act, out, has_scale, has_bias):
    """Small sums (the int8 output's range) and sums up to olmo's K·127²
    ≈ 1.3e8, past f32's exact 2^24: with no scale, no bias and act none or
    relu an int32 output is the exact sum (max(acc, 0))."""
    r = np.random.default_rng(0)
    acc = np.concatenate([r.integers(-300, 300, (4, 48)),
                          r.integers(-130_000_000, 130_000_000, (4, 48))]
                         ).astype(np.int32)
    bias, scale = _pick(*_epilogue_rows(r, 48), has_scale, has_bias)
    want = japply_epilogue(jnp.asarray(acc),
                           JEpilogue(act, has_bias, has_scale), _JNP[out],
                           bias=None if bias is None else _j(bias)[None],
                           scale=None if scale is None else _j(scale)[None])
    got = apply_epilogue(torch.from_numpy(acc),
                         Epilogue(act, has_bias, has_scale), out,
                         bias=_t(bias), scale=_t(scale))
    _check(got, want, act)
    if out == I32 and act in ("none", "relu") and not (has_scale
                                                       or has_bias):
        np.testing.assert_array_equal(
            got.numpy(), acc if act == "none" else np.maximum(acc, 0))


# ---------------------------------------------------------------------------
# each int8 branch's plain version against its Pallas kernel
# ---------------------------------------------------------------------------

def _gemm_case(kernel, epi, seed):
    """Port and JAX outputs of one int8 GEMM branch: dense (sta_gemm, its
    skinny variant) or on the INT8 values plane (dbb_gemm, skinny)."""
    act, od, has_scale, has_bias = epi
    skinny = kernel.endswith("skinny")
    m, k, n = (8, 128, 160) if skinny else (40, 200 if kernel == "sta_gemm"
                                            else 136, 96)
    r = np.random.default_rng(seed)
    x = _ints(r, (m, k))
    bias, scale = _pick(*_epilogue_rows(r, n), has_scale, has_bias)
    if kernel.startswith("sta"):
        w = _ints(r, (k, n))
        want = jsta_gemm(jnp.asarray(x), jnp.asarray(w), _j(bias), _j(scale),
                         act=act, out_dtype=_JNP[od], skinny=skinny)
        fn = sta_gemm_skinny if skinny else sta_gemm
        got = fn(_t(x), _t(w), _t(bias), _t(scale), act=act, out_dtype=od)
        return got, want
    q = np.asarray(jquant.quantize_weight(
        jnp.asarray(r.standard_normal((k, n)).astype(np.float32))).q)
    p = jpack(jnp.asarray(q), 8, 3)
    values = np.asarray(p.values)
    bitmask = np.asarray(p.bitmask).view(np.int32)
    assert values.dtype == np.int8
    want = jdbb_gemm(jnp.asarray(x), p.values, p.bitmask, _j(bias),
                     _j(scale), act=act, nnz=3, out_dtype=_JNP[od],
                     skinny=skinny)
    fn = dbb_gemm_skinny if skinny else dbb_gemm
    got = fn(_t(x), _t(values), _t(bitmask), _t(bias), _t(scale), act=act,
             nnz=3, out_dtype=od)
    return got, want


@pytest.mark.parametrize("epi", EPILOGUES, ids=lambda e: f"{e[0]}-{e[1]}")
@pytest.mark.parametrize("kernel", ["sta_gemm", "sta_gemm_skinny",
                                    "dbb_gemm", "dbb_gemm_skinny"])
def test_int8_gemm_plain_matches_pallas(kernel, epi):
    got, want = _gemm_case(kernel, epi, 1)
    _check(got, want, epi[0])


@pytest.mark.parametrize("epi", EPILOGUES, ids=lambda e: f"{e[0]}-{e[1]}")
@pytest.mark.parametrize("packed", [False, True])
def test_int8_conv_plain_matches_pallas(packed, epi):
    """conv_gemm on a 3-channel image (K = 27: the ragged gather of
    convnet's conv0) and conv_gemm_dbb on 16 channels, stride 1 SAME."""
    act, od, has_scale, has_bias = epi
    r = np.random.default_rng(2)
    c = 16 if packed else 3
    x = _ints(r, (2, 7, 6, c))
    bias, scale = _pick(*_epilogue_rows(r, 24), has_scale, has_bias)
    kw = dict(kh=3, kw=3, act=act)
    if packed:
        q = np.asarray(jquant.quantize_weight(jnp.asarray(
            r.standard_normal((9 * c, 24)).astype(np.float32))).q)
        p = jpack(jnp.asarray(q), 8, 2)
        want = jconv_gemm_dbb(jnp.asarray(x), p.values, p.bitmask, _j(bias),
                              _j(scale), nnz=2, out_dtype=_JNP[od], **kw)
        got = conv_gemm_dbb(_t(x), _t(p.values),
                            _t(np.asarray(p.bitmask).view(np.int32)),
                            _t(bias), _t(scale), nnz=2, out_dtype=od, **kw)
    else:
        w = _ints(r, (9 * c, 24))
        want = jconv_gemm(jnp.asarray(x), jnp.asarray(w), _j(bias),
                          _j(scale), out_dtype=_JNP[od], **kw)
        got = conv_gemm(_t(x), _t(w), _t(bias), _t(scale), out_dtype=od,
                        **kw)
    _check(got, want, act)


# ---------------------------------------------------------------------------
# the front doors
# ---------------------------------------------------------------------------

def _quantized_leaf(r, k, n):
    """An INT8-valued DbbWeight, packed by the reference's pack_tree
    (quantize=True), in both packages."""
    w = r.standard_normal((k, n)).astype(np.float32)
    cfg = jget("olmo-1b", smoke=True).dbb
    tree = {"mlp": {"wi": {"w": jnp.asarray(w)}}}
    jleaf = jpack_tree(jproject(tree, cfg), cfg,
                       quantize=True)["mlp"]["wi"]["w"]
    tleaf = params_from_numpy(jleaf)
    assert isinstance(tleaf, DbbWeight) and tleaf.values.dtype == I8
    return jleaf, tleaf


MATMUL_ROUTES = {False: {8: ("skinny_sta", "sta", "xla"),
                         40: ("sta", "xla")},
                 True: {8: ("skinny_dbb", "dbb_packed", "xla"),
                        40: ("dbb_packed", "xla")}}


@pytest.mark.parametrize("epi", EPILOGUES, ids=lambda e: f"{e[0]}-{e[1]}")
@pytest.mark.parametrize("m", [8, 40])
@pytest.mark.parametrize("packed", [False, True])
def test_dispatch_matmul_int8_matches_reference(packed, m, epi, monkeypatch):
    """Auto routes and every applicable forced route in both packages
    agree; a caller scale folds into an INT8 leaf's per-channel scale."""
    act, od, has_scale, has_bias = epi
    r = np.random.default_rng(m + packed)
    k, n = 128, 96
    x = _ints(r, (m, k))
    bias, scale = _pick(*_epilogue_rows(r, n), has_scale, has_bias)
    if packed:
        jw, tw = _quantized_leaf(r, k, n)
    else:
        w = _ints(r, (k, n))
        jw, tw = jnp.asarray(w), _t(w)
    args = dict(act=act)
    want = jd.matmul(jnp.asarray(x), jw, _j(bias), _j(scale),
                     out_dtype=_JNP[od], pallas=True, **args)
    got = td.matmul(_t(x), tw, _t(bias), _t(scale), out_dtype=od,
                    pallas=True, **args)
    _check(got, want, act)
    for route in MATMUL_ROUTES[packed][m]:
        jr = jd.matmul(jnp.asarray(x), jw, _j(bias), _j(scale),
                       out_dtype=_JNP[od], pallas=True, route=route, **args)
        monkeypatch.setenv(td.FORCE_ROUTE_ENV, f"matmul={route}")
        tr = td.matmul(_t(x), tw, _t(bias), _t(scale), out_dtype=od,
                       pallas=True, **args)
        monkeypatch.delenv(td.FORCE_ROUTE_ENV)
        _check(tr, jr, act)
        _check(tr, want, act)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("packed", [False, True])
def test_dispatch_conv_int8_matches_reference(packed, use_kernel):
    """int8 image through the conv front door: a dense int8 weight (int32
    out) and an INT8-valued DBB leaf (its scale in the epilogue: f32 out),
    bias and relu, on the kernel and the explicit im2col routes."""
    r = np.random.default_rng(3)
    x = _ints(r, (2, 6, 6, 16))
    bias = (r.standard_normal(32) * 50).astype(np.float32)
    if packed:
        jw, tw = _quantized_leaf(r, 144, 32)
    else:
        w = _ints(r, (144, 32))
        jw, tw = jnp.asarray(w), _t(w)
    want = jd.conv(jnp.asarray(x), jw, jnp.asarray(bias), kh=3, kw=3,
                   act="relu", use_kernel=use_kernel)
    got = td.conv(_t(x), tw, _t(bias), kh=3, kw=3, act="relu",
                  use_kernel=use_kernel)
    # int32 by default: the f32 bias add truncates (the reference's policy)
    assert got.dtype == (F32 if packed else I32)
    _check(got, want, "relu")


def _chosen(decisions):
    [name] = [d.name for d in decisions if d.chosen]
    return name


@pytest.mark.parametrize("m,k,n,packed,want", [
    (8, 256, 512, False, "skinny_sta"),      # tests/test_dispatch.py rows
    (8, 256, 512, True, "skinny_dbb"),
    (256, 256, 512, True, "dbb_packed"),
    (256, 256, 512, False, "sta"),
    (8, 2048, 8192, True, "skinny_dbb"),     # olmo-1b's projections
    (512, 8192, 2048, True, "dbb_packed"),
    (24, 2048, 2048, False, "skinny_sta"),
    (512, 2048, 8192, False, "sta")])
def test_int8_routes_match_reference(m, k, n, packed, want):
    jname = _chosen(jd.explain("matmul", m=m, k=k, n=n, dtype=jnp.int8,
                               packed=packed, pallas=True))
    spec = td.OpSpec(domain="matmul", m=m, k=k, n=n, packed=packed,
                     pallas=True, x_int8=True, int8_values=packed)
    tname, _ = td.select(spec)
    assert tname == jname == want


def test_int8_route_rules_of_the_port():
    """Where the port's int8 rules are its own: int8 x on a float-valued
    DBB leaf or on the w4 plane takes the plain route (the int8 branch
    streams the INT8 plane; the w4 tile is float), and so does float x on
    an INT8-valued conv leaf (the float conv kernel streams f32 values)."""
    base = dict(domain="matmul", m=8, k=256, n=512, packed=True, pallas=True)
    name, why = td.select(td.OpSpec(**base, x_int8=True))
    assert name == "xla" and "INT8 values plane" in why["skinny_dbb"]
    name, why = td.select(td.OpSpec(**base, x_int8=True, int8_values=True,
                                    bits=4, group=128))
    assert name == "xla" and "float x only" in why["skinny_dbb_w4"]
    conv = dict(domain="conv", m=128, k=144, n=32, packed=True, pallas=True,
                conv_geom=(2, 8, 8, 16, 3, 3, 1))
    assert td.select(td.OpSpec(**conv, int8_values=True))[0] == "conv_xla"
    assert td.select(td.OpSpec(**conv, x_int8=True,
                               int8_values=True))[0] == "conv_dbb"


# ---------------------------------------------------------------------------
# the exactness probes: all-127 operands at K = 1179 (sums of 1.9e7, past
# 2^24; an f32 accumulator rounds them)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pallas", [True, False])
def test_matmul_probe_all_127_at_k1179(pallas):
    x = np.full((4, 1179), 127, np.int8)
    w = np.full((1179, 24), 127, np.int8)
    want = jd.matmul(jnp.asarray(x), jnp.asarray(w), pallas=pallas)
    got = td.matmul(_t(x), _t(w), pallas=pallas)
    assert got.dtype == I32 and int(got[0, 0]) == 1179 * 127 * 127
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_kernel", [True, False])
def test_conv_probe_all_127_at_k1179(use_kernel):
    """3×3 SAME conv on 131 channels: the interior pixels' full windows
    sum 1179·127² = 19016091 (an f32 accumulator gives 19016092)."""
    x = np.full((1, 4, 4, 131), 127, np.int8)
    w = np.full((9 * 131, 16), 127, np.int8)
    want = np.asarray(jd.conv(jnp.asarray(x), jnp.asarray(w), kh=3, kw=3,
                              use_kernel=use_kernel))
    got = td.conv(_t(x), _t(w), kh=3, kw=3, use_kernel=use_kernel)
    assert int(got.max()) == 19016091 == int(want.max())
    np.testing.assert_array_equal(got.numpy(), want)


def test_packed_matmul_probe_all_127():
    """An INT8-valued leaf of all-127 values at K = 1184, no scale: the
    int32 sum 1184·127² through both packages' routes."""
    x = np.full((4, 1184), 127, np.int8)
    jp = jpack(jnp.full((1184, 16), 127, jnp.int8), 8, 8)
    tp = params_from_numpy(jp)
    for pallas in (True, False):
        got = td.matmul(_t(x), tp, pallas=pallas)
        want = jd.matmul(jnp.asarray(x), jp, pallas=pallas)
        assert int(got[0, 0]) == 1184 * 127 * 127
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the convnet INT8 chain at smoke width
# ---------------------------------------------------------------------------

def _jax_int8_chain(params, cfg, images):
    """The reference's operators chained as the paper's INT8 inference:
    per-tensor activation quantization, each conv with x_s·w_s fused, bias
    and relu to f32, a 2×2 max-pool, requantization, the classifier."""
    x, k = jnp.asarray(images), cfg.cnn_kernel
    for i in range(len(cfg.cnn_channels)):
        p = params[f"conv{i}"]
        xs = jquant.act_scale(x)
        xq = jnp.clip(jnp.round(x / xs), -127, 127).astype(jnp.int8)
        w = p["w"]
        if isinstance(w, jquant.QuantizedWeight):
            y = jconv_gemm(xq, w.q, p["b"], xs * w.scale, kh=k, kw=k,
                           act="relu", out_dtype=jnp.float32)
        else:
            y = jd.conv(xq, dataclasses.replace(w, scale=w.scale * xs),
                        p["b"], kh=k, kw=k, act="relu",
                        out_dtype=jnp.float32)
        x = jax.lax.reduce_window(y, -jnp.inf, jax.lax.max, (1, 2, 2, 1),
                                  (1, 2, 2, 1), "VALID")
    flat = x.reshape(x.shape[0], -1)
    xs = jquant.act_scale(flat)
    xq = jnp.clip(jnp.round(flat / xs), -127, 127).astype(jnp.int8)
    return jd.matmul(xq, params["fc"]["w"], params["fc"]["b"], scale=xs,
                     pallas=True, out_dtype=jnp.float32)


def _torch_int8_chain(params, cfg, images, use_kernel):
    x, k = images, cfg.cnn_kernel
    for i in range(len(cfg.cnn_channels)):
        p = params[f"conv{i}"]
        xs = act_scale(x)
        xq = torch.clamp(torch.round(x / xs), -127, 127).to(I8)
        w, scale = p["w"], xs
        if isinstance(w, QuantizedWeight):
            w, scale = w.q, xs * w.scale
        y = td.conv(xq, w, p["b"], scale, kh=k, kw=k, act="relu",
                    out_dtype=F32, use_kernel=use_kernel)
        x = max_pool_2x2(y)
    flat = x.reshape(x.shape[0], -1)
    xs = act_scale(flat)
    xq = torch.clamp(torch.round(flat / xs), -127, 127).to(I8)
    return td.matmul(xq, params["fc"]["w"], params["fc"]["b"], scale=xs,
                     pallas=use_kernel, out_dtype=F32)


def test_convnet_int8_chain_matches_reference():
    """convnet-dbb at smoke width (convs 3→16→32, 16×16 images): conv0 an
    INT8 dense weight (K = 27), conv1 and the classifier INT8-valued DBB
    leaves (pack_tree(quantize=True)); the port's kernel and plain routes
    against the reference's chain."""
    jcfg = jget("convnet-dbb", smoke=True)
    tcfg = tget("convnet-dbb", smoke=True)
    jparams = jpack_tree(jproject(jregistry.init_params(
        jax.random.PRNGKey(0), jcfg), jcfg.dbb), jcfg.dbb, quantize=True)
    c0 = jparams["conv0"]
    assert not hasattr(c0["w"], "bitmask")          # K = 27: stays dense
    jparams = dict(jparams, conv0=dict(c0, w=jquant.quantize_weight(
        c0["w"])))
    tparams = params_from_numpy(jparams)
    assert isinstance(tparams["conv0"]["w"], QuantizedWeight)
    assert isinstance(tparams["conv1"]["w"], DbbWeight)
    assert isinstance(tparams["fc"]["w"], DbbWeight)
    images = np.random.default_rng(7).standard_normal(
        (4, 16, 16, 3)).astype(np.float32)
    want = np.asarray(_jax_int8_chain(jparams, jcfg, images))
    for use_kernel in (True, False):
        got = _torch_int8_chain(tparams, tcfg, _t(images), use_kernel)
        _check(got, want, "none")
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      want.argmax(-1))
