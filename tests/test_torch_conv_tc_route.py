"""The route to conv_gemm_dbb's tensor-core body, on the CPU.

The launchers of csrc/conv_gemm_dbb.cu (conv_gemm_dbb_launch for float
images, conv_gemm_dbb_s8_launch for int8 ones) pick one of two bodies by a
rule on dtype, C, kh, kw, stride and N (tc_body): the tensor-core body
(csrc/conv_tc.cuh: TMA im2col boxes, the DBB planes decompressed in shared
memory, 3xTF32 wgmma for f32, s8 wgmma for int8) or the FMA body
(gemm_tile.cuh). The wrapper mirrors the rule in
``kernels.conv_gemm.ops.tc_body`` to count ``conv_gemm_dbb_tc`` /
``conv_gemm_dbb_s8_tc`` launches. Here the mirror is held against the
launcher's own source (the rule is parsed out of it), the rule is shown
never to read B, H or W and to admit no bf16 image, and the CPU route of
shapes the body takes on the card (numpy-seeded images, 128-pixel tiles
that cross image rows and images, C at the rule's edge, nnz 1, 2, 4 and 8,
stride 2, VALID) is held against the Pallas kernel in interpret mode.
Last, a plain torch emulation of the body's 3xTF32 arithmetic (each
operand split into a tf32 hi and lo, lo·hi + hi·lo + hi·hi summed in f32)
is held against the JAX reference at convnet conv1's geometry, to show the
split keeps the card tests' f32 tolerance before it reaches the card.

Tolerances: f32 rtol 1e-5 with atol 1e-5·max|want| (tests/test_torch_gpu.py's
``_gpu_close``: the kernel sums in another order); int8 images' int32
outputs bit-equal (integer sums), f32 outputs after a scale, bias and relu
rtol 1e-6 with atol 1e-7·max|want| (tests/test_torch_int8.py's).

tests/test_torch_gpu.py holds the body itself against the plain version
and the FMA body on the card.
"""
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dbb import pack_dbb as jpack
from repro.kernels.conv_gemm import ops as jconv
from repro_torch.kernels.build import DTYPE_CODES
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.conv_gemm import conv_gemm_dbb
from repro_torch.kernels.conv_gemm.ops import tc_body
from repro_torch.kernels.conv_gemm.ref import im2col

torch.set_num_threads(1)
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
F32, BF16, I8, I32 = torch.float32, torch.bfloat16, torch.int8, torch.int32


def _c_rule():
    """tc_body's parameters and its expression as a Python function of
    them, read from csrc/conv_gemm_dbb.cu: ``bool tc_body(int dtype, ...)
    { return <expr>; }`` with ``&&`` / ``||`` / ``==`` / ``%`` / ``<=``
    and the dtype codes ``repro::DT_*``."""
    m = re.search(r"bool tc_body\(([^)]*)\)\s*\{\s*return (.*?);\s*\}",
                  (CSRC / "conv_gemm_dbb.cu").read_text(), re.S)
    assert m, "no tc_body rule in conv_gemm_dbb.cu"
    params = [p.split()[-1] for p in m.group(1).split(",")]
    codes = {"repro::DT_F32": DTYPE_CODES[F32],
             "repro::DT_BF16": DTYPE_CODES[BF16],
             "repro::DT_I8": DTYPE_CODES[I8]}
    expr = re.sub(r"\s+", " ", m.group(2))
    for name, code in codes.items():
        expr = expr.replace(name, str(code))
    expr = expr.replace("&&", " and ").replace("||", " or ")
    assert re.fullmatch(r"[\w %=!<>()]+", expr), expr
    return params, lambda **kw: bool(eval(expr, {}, kw))


def _functions():
    """{name: body} of every top-level function in conv_gemm_dbb.cu (its
    text between the braces), found by brace matching."""
    text = (CSRC / "conv_gemm_dbb.cu").read_text()
    out = {}
    for m in re.finditer(r"^(?:extern \"C\" )?[\w:<>]+ (\w+)\([^;{]*\)\s*\{",
                         text, re.M):
        depth, i = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        out[m.group(1)] = text[m.end():i - 1]
    return out


CS = (1, 3, 8, 16, 24, 32, 48, 64, 72, 96, 128, 136, 192, 256)
KS = (1, 3, 5, 7, 32, 33)
STRIDES = (1, 2, 3, 8, 9)
NS = (1, 4, 6, 10, 16, 20, 32, 48, 64, 128, 130, 132, 144, 256, 1000)


def test_rule_mirrors_the_launcher():
    params, rule = _c_rule()
    assert params == ["dtype", "C", "kh", "kw", "stride", "N"]
    for dt in (F32, BF16, I8):
        for c in CS:
            for k in KS:
                for s in STRIDES:
                    for n in NS:
                        want = rule(dtype=DTYPE_CODES[dt], C=c, kh=k, kw=k,
                                    stride=s, N=n)
                        assert tc_body(dt, c, k, k, s, n) is want, (
                            dt, c, k, s, n)
    # kh and kw apart
    assert rule(dtype=0, C=16, kh=3, kw=33, stride=1, N=4) is False
    assert tc_body(F32, 16, 3, 33, 1, 4) is False


def test_rule_never_reads_the_batch_or_the_image_size():
    """A pixel's body must not depend on the batch around it or the image
    size: the rule has no B, H or W to read, in Python or in C."""
    assert list(inspect.signature(tc_body).parameters) == [
        "dtype", "c", "kh", "kw", "stride", "n"]
    params, _ = _c_rule()
    assert not {"B", "H", "W", "Ho", "Wo"} & set(params)


def test_no_bf16_image_takes_the_body():
    _, rule = _c_rule()
    for c in CS:
        for k in KS:
            for s in STRIDES:
                for n in NS:
                    assert not tc_body(BF16, c, k, k, s, n)
                    assert not rule(dtype=DTYPE_CODES[BF16], C=c, kh=k,
                                    kw=k, stride=s, N=n)


def test_only_the_launchers_reach_the_body():
    """The body (repro::convtc) is launched from the two branch launchers
    and the probe's phase launcher only, each behind the rule; the rule's
    export returns it as is."""
    funcs = _functions()
    launches = {name for name, body in funcs.items()
                if "convtc::launch" in body}
    assert launches == {"conv_gemm_dbb_launch", "conv_gemm_dbb_s8_launch",
                        "conv_gemm_dbb_tc_phase_launch"}
    for name in launches:
        assert re.search(r"\btc_body\(", funcs[name]), name
    assert re.fullmatch(
        r"\s*return tc_body\(dtype, C, kh, kw, stride, N\) \? 1 : 0;\s*",
        funcs["conv_gemm_dbb_tc_body"])
    # the int8 launcher asks with the int8 code, the float one with x's
    assert "tc_body(repro::DT_I8, C, kh, kw, stride, N)" in funcs[
        "conv_gemm_dbb_s8_launch"]
    assert "tc_body(dtype, C, kh, kw, stride, N)" in funcs[
        "conv_gemm_dbb_launch"]


@pytest.mark.parametrize("dt,c,k,s,n,want", [
    (F32, 64, 3, 1, 128, True), (F32, 128, 3, 1, 256, True),  # convnet
    (I8, 64, 3, 1, 128, True), (I8, 128, 3, 1, 256, True),    # conv1, 2
    (F32, 16, 3, 1, 32, True),           # convnet smoke's conv1
    (F32, 6, 5, 1, 16, False),           # lenet's conv1: C off the rule
    (I8, 16, 3, 1, 32, False),           # int8 C 16: under a 64-byte piece
    (I8, 64, 3, 1, 24, False),           # int8 N 24: 24-byte plane rows
    (F32, 16, 3, 1, 10, False),          # f32 N 10: 40-byte plane rows
    (F32, 64, 3, 9, 128, False),         # stride past the im2col walk's 8
    (BF16, 64, 3, 1, 128, False)])
def test_convnet_takes_the_body(dt, c, k, s, n, want):
    assert tc_body(dt, c, k, k, s, n) is want


# ---------------------------------------------------------------------------
# the CPU route of shapes the body takes, against the Pallas kernel
# ---------------------------------------------------------------------------

def _pack(r, k_dim, n, nnz, ints):
    w = (r.integers(-127, 128, (k_dim, n)).astype(np.int8) if ints
         else (r.standard_normal((k_dim, n)) / k_dim ** 0.5)
         .astype(np.float32))
    p = jpack(jnp.asarray(w), 8, nnz)
    return (p, torch.tensor(np.asarray(p.values)),
            torch.tensor(np.asarray(p.bitmask).view(np.int32)))


def _close(got, want, rtol, atol):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol * float(np.abs(want).max()))


# b, h, w, c, k, n, stride, padding, nnz: M 126 (a tile across image rows
# and images), C 16 at the f32 rule's edge (K 144 ends half way into a
# 32-deep stage), N off the 128-column tile, stride 2, VALID
F32_CASES = [(2, 9, 7, 16, 3, 20, 1, "SAME", 1),
             (1, 7, 9, 48, 3, 132, 2, "SAME", 4),
             (2, 6, 5, 32, 3, 16, 1, "VALID", 8),
             (1, 6, 6, 64, 3, 128, 1, "SAME", 2)]
# int8: C 64 at the rule's edge (K 576 ends half way into a 128-deep stage)
S8_CASES = [(2, 9, 7, 64, 3, 48, 1, "SAME", 1),
            (1, 7, 9, 64, 3, 16, 2, "SAME", 4),
            (1, 5, 6, 128, 3, 32, 1, "VALID", 8),
            (1, 6, 6, 64, 3, 128, 1, "SAME", 2)]


@pytest.mark.parametrize("b,h,w,c,k,n,stride,padding,nnz", F32_CASES)
def test_f32_cpu_route_matches_pallas(b, h, w, c, k, n, stride, padding,
                                      nnz):
    assert tc_body(F32, c, k, k, stride, n)
    r = np.random.default_rng(b * 1000 + h * w + c + n + nnz)
    x = r.standard_normal((b, h, w, c)).astype(np.float32)
    p, values, bitmask = _pack(r, k * k * c, n, nnz, ints=False)
    bias = r.standard_normal(n).astype(np.float32)
    scale = (r.random(n) + 0.5).astype(np.float32)
    kw = dict(kh=k, kw=k, stride=stride, padding=padding, act="relu")
    want = jconv.conv_gemm_dbb(jnp.asarray(x), p.values, p.bitmask,
                               jnp.asarray(bias), jnp.asarray(scale),
                               nnz=nnz, **kw)
    before = dict(LAUNCHES)
    got = conv_gemm_dbb(torch.tensor(x), values, bitmask, torch.tensor(bias),
                        torch.tensor(scale), nnz=nnz, **kw)
    assert LAUNCHES == before               # the CPU path launches nothing
    _close(got, want, 1e-5, 1e-5)


@pytest.mark.parametrize("b,h,w,c,k,n,stride,padding,nnz", S8_CASES)
def test_s8_cpu_route_matches_pallas(b, h, w, c, k, n, stride, padding, nnz):
    assert tc_body(I8, c, k, k, stride, n)
    r = np.random.default_rng(b * 1000 + h * w + c + n + nnz)
    x = r.integers(-127, 128, (b, h, w, c)).astype(np.int8)
    p, values, bitmask = _pack(r, k * k * c, n, nnz, ints=True)
    assert values.dtype == I8
    kw = dict(kh=k, kw=k, stride=stride, padding=padding)
    want = jconv.conv_gemm_dbb(jnp.asarray(x), p.values, p.bitmask, nnz=nnz,
                               **kw)
    got = conv_gemm_dbb(torch.tensor(x), values, bitmask, nnz=nnz, **kw)
    assert got.dtype == I32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bias = (r.standard_normal(n) * 50).astype(np.float32)
    scale = ((r.random(n) + 0.5) * 2e-3).astype(np.float32)
    want = jconv.conv_gemm_dbb(jnp.asarray(x), p.values, p.bitmask,
                               jnp.asarray(bias), jnp.asarray(scale),
                               nnz=nnz, act="relu", out_dtype=jnp.float32,
                               **kw)
    got = conv_gemm_dbb(torch.tensor(x), values, bitmask, torch.tensor(bias),
                        torch.tensor(scale), nnz=nnz, act="relu",
                        out_dtype=F32, **kw)
    _close(got, want, 1e-6, 1e-7)


# ---------------------------------------------------------------------------
# the 3xTF32 arithmetic, emulated in torch
# ---------------------------------------------------------------------------

def _tf32(a: torch.Tensor) -> torch.Tensor:
    """Round f32 to tf32, nearest with ties away from zero (the body's
    tf32_rna): half a tf32 unit added to the magnitude bits, the low 13
    cut."""
    bits = a.view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def test_3xtf32_keeps_the_f32_tolerance_at_convnet_conv1():
    """convnet conv1 at batch 2 (16x16x64 -> 128, 3x3 SAME, DBB k2): the
    body's arithmetic (a = hi + lo, hi = tf32(a), lo = tf32(a - hi) for
    both operands; lo·B_hi + hi·B_lo + hi·B_hi, each product exact in f32)
    against the JAX reference within the card tests' f32 tolerance; a
    single tf32 pass misses it."""
    r = np.random.default_rng(23)
    x = r.standard_normal((2, 16, 16, 64)).astype(np.float32)
    p, values, bitmask = _pack(r, 576, 128, 2, ints=False)
    bias = r.standard_normal(128).astype(np.float32)
    want = np.asarray(jconv.conv_gemm_dbb(
        jnp.asarray(x), p.values, p.bitmask, jnp.asarray(bias), nnz=2, kh=3,
        kw=3))
    from repro_torch.core.dbb import decompress_bitmask
    w = decompress_bitmask(values, bitmask, block=8)
    a = im2col(torch.tensor(x), 3, 3).reshape(-1, 576)
    a_hi, w_hi = _tf32(a), _tf32(w)
    a_lo, w_lo = _tf32(a - a_hi), _tf32(w - w_hi)
    assert not bool(((a_hi.view(torch.int32) & 0x1FFF) != 0).any())
    got = (a_lo @ w_hi + a_hi @ w_lo + a_hi @ w_hi).reshape(want.shape[:-1]
                                                            + (128,))
    got = (got + torch.tensor(bias)).numpy()
    atol = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    one = ((a_hi @ w_hi).reshape(got.shape) + torch.tensor(bias)).numpy()
    assert np.abs(one - want).max() > atol     # single-pass tf32 misses it
