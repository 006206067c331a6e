"""conv_gemm's three bodies, on the CPU.

csrc/conv_gemm.cu picks a body by rules on dtype, C, kh, kw, stride and N:
the small-C body (``small_body``: f32 or int8 images with K = kh·kw·C <=
kSmallK and N <= kSmallN; convnet's conv0, lenet's conv1), else the
tensor-core body of csrc/conv_tc.cuh on the dense weight (``tc_body``,
conv_gemm_dbb.cu's rule; convnet's dense conv1 and conv2), else the FMA
body. The wrapper mirrors both rules (``conv_gemm.ops.small_body`` /
``tc_body``) to count ``conv_gemm_small`` / ``conv_gemm_s8_small`` and
``conv_gemm_tc`` / ``conv_gemm_s8_tc`` launches. Here, with inputs from
numpy seeds:

* the rules and their constants are parsed out of conv_gemm.cu: the
  mirrors agree with them, neither reads B, H or W, the small-C rule is
  taken first in both launchers, conv_gemm.cu's tensor-core rule is
  conv_gemm_dbb.cu's, and the path's convolutions take the bodies named
  above;
* a model of the small-C body's index arithmetic (its tiling, written here
  after csrc/conv_gemm.cu's small_geom with the parsed constants; the zero-
  halo window of each tile, the K table and each pixel's window offset;
  int8 channels packed four a word, zero-padded) gathers every output
  pixel's im2col row exactly, at ragged tiles, stride 2 and 3, VALID,
  images wider than a tile and windows cut to fit, and its int8 dot
  products equal the Pallas kernel's int32 outputs;
* the CPU route of the shapes both new bodies take (f32 and int8 at N 6,
  16, 64 and past the small rule, stride 2, VALID) is held against
  ``conv_gemm_pallas`` in interpret mode.

Tolerances: f32 rtol 1e-5 with atol 1e-5·max|want| (tests/test_torch_gpu.py's
``_gpu_close``); int8 images' int32 outputs bit-equal (integer sums), f32
outputs after a scale, bias and relu rtol 1e-6 with atol 1e-7·max|want|
(tests/test_torch_int8.py's).

tests/test_torch_gpu.py holds the bodies themselves against the plain
version on the card.
"""
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv_gemm import ops as jconv
from repro_torch.kernels.build import DTYPE_CODES
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.conv_gemm import conv_gemm
from repro_torch.kernels.conv_gemm.ops import (SMALL_K, SMALL_N, small_body,
                                               tc_body)
from repro_torch.kernels.conv_gemm.ref import im2col, out_spatial

torch.set_num_threads(1)
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
SRC = (CSRC / "conv_gemm.cu").read_text()
F32, BF16, I8, I32 = torch.float32, torch.bfloat16, torch.int8, torch.int32
CODES = {"repro::DT_F32": DTYPE_CODES[F32],
         "repro::DT_BF16": DTYPE_CODES[BF16],
         "repro::DT_I8": DTYPE_CODES[I8]}


def _consts() -> dict:
    """conv_gemm.cu's ``constexpr int kName = <expr>;`` constants."""
    scope = {}
    for m in re.finditer(r"^constexpr int (\w+) = ([^;]+);", SRC, re.M):
        scope[m.group(1)] = eval(m.group(2).replace("/", "//"), {},
                                 dict(scope))
    return scope


def _c_rule(name: str, text: str = SRC):
    """``bool name(int a, ...) { return <expr>; }``: its parameters, its
    expression's text and a Python function of it (the dtype codes and
    the source's constants substituted)."""
    m = re.search(rf"bool {name}\(([^)]*)\)\s*\{{\s*return (.*?);\s*\}}",
                  text, re.S)
    assert m, f"no {name} rule"
    params = [p.split()[-1] for p in m.group(1).split(",")]
    expr = re.sub(r"\s+", " ", m.group(2))
    for key, code in CODES.items():
        expr = expr.replace(key, str(code))
    py = expr.replace("&&", " and ").replace("||", " or ")
    assert re.fullmatch(r"[\w %=!<>()*]+", py), py
    scope = _consts()
    return params, expr, lambda **kw: bool(eval(py, dict(scope), kw))


def _functions():
    """{name: body} of conv_gemm.cu's extern "C" functions."""
    out = {}
    for m in re.finditer(r"^extern \"C\" int (\w+)\([^;{]*\)\s*\{", SRC,
                         re.M):
        depth, i = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(SRC[i], 0)
            i += 1
        out[m.group(1)] = SRC[m.end():i - 1]
    return out


CS = (1, 3, 4, 6, 8, 16, 17, 18, 24, 32, 64, 128)
KS = (1, 3, 5, 7)
NS = (1, 4, 6, 10, 16, 20, 48, 64, 65, 128, 256)


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def test_small_rule_mirrors_the_launcher():
    params, _, rule = _c_rule("small_body")
    assert params == ["dtype", "C", "kh", "kw", "N"]
    c = _consts()
    assert (SMALL_K, SMALL_N) == (c["kSmallK"], c["kSmallN"])
    for dt in (F32, BF16, I8):
        for ch in CS:
            for k in KS:
                for n in NS:
                    want = rule(dtype=DTYPE_CODES[dt], C=ch, kh=k, kw=k, N=n)
                    assert small_body(dt, ch, k, k, n) is want, (dt, ch, k, n)
    assert not small_body(BF16, 3, 3, 3, 64)
    assert small_body(F32, 160, 1, 1, 64) and not small_body(F32, 161, 1, 1,
                                                             64)


def test_tc_rule_is_conv_gemm_dbbs():
    """conv_gemm.cu's tensor-core rule is conv_gemm_dbb.cu's, word for
    word, and the wrapper's one mirror serves both."""
    params, expr, rule = _c_rule("tc_body")
    dbb_params, dbb_expr, _ = _c_rule(
        "tc_body", (CSRC / "conv_gemm_dbb.cu").read_text())
    assert (params, expr) == (dbb_params, dbb_expr)
    for dt in (F32, BF16, I8):
        for ch in CS:
            for k in KS:
                for s in (1, 2, 8, 9):
                    for n in NS:
                        assert tc_body(dt, ch, k, k, s, n) is rule(
                            dtype=DTYPE_CODES[dt], C=ch, kh=k, kw=k,
                            stride=s, N=n)


def test_rules_never_read_the_batch_or_the_image_size():
    assert list(inspect.signature(small_body).parameters) == [
        "dtype", "c", "kh", "kw", "n"]
    for name in ("small_body", "tc_body"):
        params, _, _ = _c_rule(name)
        assert not {"B", "H", "W", "Ho", "Wo"} & set(params)


def test_the_launchers_take_the_small_rule_first():
    funcs = _functions()
    assert re.fullmatch(
        r"\s*return small_body\(dtype, C, kh, kw, N\) \? 1 : 0;\s*",
        funcs["conv_gemm_small_body"])
    assert re.sub(r"\s+", " ", funcs["conv_gemm_tc_body"]).strip() == (
        "return !small_body(dtype, C, kh, kw, N) && "
        "tc_body(dtype, C, kh, kw, stride, N) ? 1 : 0;")
    f32 = funcs["conv_gemm_launch"]
    assert (f32.index("small_body(dtype, C, kh, kw, N)")
            < f32.index("tc_body(dtype, C, kh, kw, stride, N)")
            < f32.index("conv_gemm_kernel<"))
    s8 = funcs["conv_gemm_s8_launch"]
    assert "const bool small = small_body(repro::DT_I8, C, kh, kw, N);" in s8
    assert ("const bool tc = !small && tc_body(repro::DT_I8, C, kh, kw, "
            "stride, N);") in s8
    # the dense tensor-core body is conv_tc.cuh's, with no bitmask
    assert f32.count("repro::convtc::kDense") == 1
    assert s8.count("repro::convtc::kDense") == 1


@pytest.mark.parametrize("dt,c,k,n,body", [
    (F32, 3, 3, 64, "small"), (I8, 3, 3, 64, "small"),     # convnet conv0
    (F32, 6, 5, 16, "small"), (I8, 6, 5, 16, "small"),     # lenet conv1
    (F32, 1, 5, 6, "small"),                               # lenet conv0
    (F32, 64, 3, 128, "tc"), (F32, 128, 3, 256, "tc"),     # convnet sta
    (I8, 64, 3, 128, "tc"), (I8, 128, 3, 256, "tc"),       # conv1, conv2
    (F32, 16, 3, 32, "small"),                  # convnet smoke's conv1
    (F32, 24, 3, 64, "fma"), (I8, 72, 3, 64, "fma"),
    (BF16, 3, 3, 64, "fma"), (BF16, 64, 3, 128, "fma")])
def test_the_paths_convolutions_take_their_bodies(dt, c, k, n, body):
    small = small_body(dt, c, k, k, n)
    tc = not small and tc_body(dt, c, k, k, 1, n)
    assert {"small": small, "tc": tc, "fma": not small and not tc}[body]


# ---------------------------------------------------------------------------
# a model of the small-C body's index arithmetic
# ---------------------------------------------------------------------------

def _small_geom(b, h, w, c, ho, wo, kh, kw, s, pack):
    """conv_gemm.cu's small_geom: (cp, words, R, CW, WR, WC, th, tw)."""
    k = _consts()
    cp = -(-c // pack) * pack
    words = kh * kw * cp // pack
    cw_ = min(wo, k["kBand"])
    r = min(k["kBand"] // cw_, ho)
    while True:
        wr, wc = (r - 1) * s + kh, (cw_ - 1) * s + kw
        if wr * wc * cp * 4 // pack <= k["kWindowMax"] or (r == 1
                                                           and cw_ == 1):
            break
        if r > 1:
            r = (r + 1) // 2
        else:
            cw_ = (cw_ + 1) // 2
    return cp, words, r, cw_, wr, wc, -(-ho // r), -(-wo // cw_)


def _gather(x: np.ndarray, kh, kw, stride, padding, pack):
    """Each output pixel's K words as the body reads them: [B·Ho·Wo,
    words, pack] (pack 4: a tap's channels padded to cp with zeros)."""
    b, h, w, c = x.shape
    ho, pt, _ = out_spatial(h, kh, stride, padding)
    wo, pl, _ = out_spatial(w, kw, stride, padding)
    cp, words, r_, cw_, wr_, wc_, th, tw = _small_geom(
        b, h, w, c, ho, wo, kh, kw, stride, pack)
    k = _consts()
    assert r_ * cw_ <= k["kBand"]
    cwd = cp // pack                         # words a window pixel
    kq = np.arange(words)
    tap, cc = kq // cwd, kq % cwd
    koff = ((tap // kw) * wc_ + tap % kw) * cwd + cc
    out = np.full((b * ho * wo, words, pack), 99, x.dtype)
    seen = np.zeros(b * ho * wo, int)
    for tile in range(b * th * tw):
        bi, tr = divmod(tile, th * tw)
        oh0, ow0 = (tr // tw) * r_, (tr % tw) * cw_
        ih0, iw0 = oh0 * stride - pt, ow0 * stride - pl
        win = np.zeros((wr_, wc_, cp), x.dtype)
        for a in range(wr_):
            for j in range(wc_):
                ih, iw = ih0 + a, iw0 + j
                if 0 <= ih < h and 0 <= iw < w:
                    win[a, j, :c] = x[bi, ih, iw]
        flat = win.reshape(-1, pack)
        for q in range(k["kBand"]):
            r, col = divmod(q, cw_)
            if q >= r_ * cw_ or oh0 + r >= ho or ow0 + col >= wo:
                continue
            off = (r * stride * wc_ + col * stride) * cwd
            assert off + koff.max() < flat.shape[0]     # inside the window
            m = (bi * ho + oh0 + r) * wo + ow0 + col
            out[m] = flat[off + koff]
            seen[m] += 1
    assert (seen == 1).all()                 # every pixel, exactly once
    return out, cp


GEOMS = [(2, 8, 8, 3, 3, 1, "SAME"), (2, 14, 14, 6, 5, 1, "SAME"),
         (3, 9, 7, 1, 5, 1, "SAME"), (2, 11, 11, 3, 3, 2, "VALID"),
         (1, 13, 10, 16, 3, 2, "SAME"), (2, 10, 9, 5, 3, 3, "VALID"),
         (1, 5, 300, 3, 3, 1, "SAME"),       # wider than a 128-pixel tile
         (1, 3, 1030, 16, 3, 8, "SAME")]     # a window cut to fit


@pytest.mark.parametrize("b,h,w,c,k,s,padding", GEOMS)
def test_the_small_bodys_windows_gather_im2col_exactly(b, h, w, c, k, s,
                                                       padding):
    r = np.random.default_rng(b * h * w + c + k + s)
    x = r.standard_normal((b, h, w, c)).astype(np.float32)
    got, _ = _gather(x, k, k, s, padding, 1)
    want = im2col(torch.tensor(x), k, k, s, padding).reshape(
        got.shape[0], -1).numpy()
    np.testing.assert_array_equal(got[:, :, 0], want)
    xi = r.integers(-127, 128, (b, h, w, c)).astype(np.int8)
    got, cp = _gather(xi, k, k, s, padding, 4)
    cols = got.reshape(got.shape[0], k * k, cp)
    assert (cols[:, :, c:] == 0).all()          # the zero-padded channels
    want = im2col(torch.tensor(xi), k, k, s, padding).reshape(
        got.shape[0], k * k, c).numpy()
    np.testing.assert_array_equal(cols[:, :, :c], want)


@pytest.mark.parametrize("b,h,w,c,k,s,padding,n", [
    (2, 8, 8, 3, 3, 1, "SAME", 64), (2, 14, 14, 6, 5, 1, "SAME", 16),
    (2, 11, 11, 3, 3, 2, "VALID", 6)])
def test_the_small_bodys_int8_dot_products_equal_pallas(b, h, w, c, k, s,
                                                        padding, n):
    """The model's packed words and filter words (dp4a: four int8 products
    a word, summed exactly) against the Pallas kernel's int32 output."""
    r = np.random.default_rng(7 + c + n)
    x = r.integers(-127, 128, (b, h, w, c)).astype(np.int8)
    wt = r.integers(-127, 128, (k * k * c, n)).astype(np.int8)
    words, cp = _gather(x, k, k, s, padding, 4)
    wp = np.zeros((k * k, cp, n), np.int64)
    wp[:, :c] = wt.reshape(k * k, c, n)
    got = np.einsum("mwp,wpn->mn", words.astype(np.int64),
                    wp.reshape(-1, 4, n)).astype(np.int32)
    want = np.asarray(jconv.conv_gemm(jnp.asarray(x), jnp.asarray(wt), kh=k,
                                      kw=k, stride=s, padding=padding))
    np.testing.assert_array_equal(got.reshape(want.shape), want)


# ---------------------------------------------------------------------------
# the CPU route of the new bodies' shapes, against the Pallas kernel
# ---------------------------------------------------------------------------

def _close(got, want, rtol, atol):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol * float(np.abs(want).max()))


# b, h, w, c, k, n, stride, padding, body
CASES = [(2, 8, 8, 3, 3, 64, 1, "SAME", "small"),     # convnet conv0
         (2, 14, 14, 6, 5, 16, 1, "SAME", "small"),   # lenet conv1
         (3, 9, 7, 1, 5, 6, 1, "SAME", "small"),      # lenet conv0, N 6
         (2, 11, 11, 3, 3, 6, 2, "VALID", "small"),
         (1, 13, 10, 16, 3, 20, 2, "SAME", "small"),
         (1, 6, 6, 64, 3, 128, 1, "SAME", "tc"),      # convnet conv1
         (1, 4, 4, 128, 3, 256, 1, "SAME", "tc"),     # convnet conv2
         (1, 7, 9, 64, 3, 48, 2, "VALID", "tc")]


@pytest.mark.parametrize("b,h,w,c,k,n,stride,padding,body", CASES)
def test_f32_cpu_route_matches_pallas(b, h, w, c, k, n, stride, padding,
                                      body):
    assert small_body(F32, c, k, k, n) is (body == "small")
    assert (body == "tc") is (body != "small"
                              and tc_body(F32, c, k, k, stride, n))
    r = np.random.default_rng(b * 100 + h * w + c + n)
    x = r.standard_normal((b, h, w, c)).astype(np.float32)
    wt = (r.standard_normal((k * k * c, n)) / (k * k * c) ** 0.5
          ).astype(np.float32)
    bias = r.standard_normal(n).astype(np.float32)
    scale = (r.random(n) + 0.5).astype(np.float32)
    kw = dict(kh=k, kw=k, stride=stride, padding=padding, act="relu")
    want = jconv.conv_gemm(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias),
                           jnp.asarray(scale), **kw)
    before = dict(LAUNCHES)
    got = conv_gemm(torch.tensor(x), torch.tensor(wt), torch.tensor(bias),
                    torch.tensor(scale), **kw)
    assert LAUNCHES == before               # the CPU path launches nothing
    _close(got, want, 1e-5, 1e-5)


@pytest.mark.parametrize("b,h,w,c,k,n,stride,padding,body", CASES)
def test_s8_cpu_route_matches_pallas(b, h, w, c, k, n, stride, padding,
                                     body):
    assert small_body(I8, c, k, k, n) is (body == "small")
    assert (body == "tc") is (body != "small"
                              and tc_body(I8, c, k, k, stride, n))
    r = np.random.default_rng(b * 100 + h * w + c + n + 1)
    x = r.integers(-127, 128, (b, h, w, c)).astype(np.int8)
    wt = r.integers(-127, 128, (k * k * c, n)).astype(np.int8)
    kw = dict(kh=k, kw=k, stride=stride, padding=padding)
    want = jconv.conv_gemm(jnp.asarray(x), jnp.asarray(wt), **kw)
    got = conv_gemm(torch.tensor(x), torch.tensor(wt), **kw)
    assert got.dtype == I32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bias = (r.standard_normal(n) * 50).astype(np.float32)
    scale = ((r.random(n) + 0.5) * 2e-3).astype(np.float32)
    want = jconv.conv_gemm(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias),
                           jnp.asarray(scale), act="relu",
                           out_dtype=jnp.float32, **kw)
    got = conv_gemm(torch.tensor(x), torch.tensor(wt), torch.tensor(bias),
                    torch.tensor(scale), act="relu", out_dtype=F32, **kw)
    _close(got, want, 1e-6, 1e-7)
