"""The port's dense GEMM and implicit-GEMM conv wrappers against the
reference's, on the CPU: `sta_gemm` (its plain version `sta_gemm_ref`)
against `repro.kernels.sta_gemm.ops.sta_gemm` (the M-tiled Pallas kernel
in interpret mode), and `im2col`, `conv_gemm`, `conv_gemm_dbb` and
`conv_gemm_packed` against the reference's (`conv_gemm_pallas` /
`conv_gemm_dbb_pallas` in interpret mode where the reference takes them).
The same numpy-seeded inputs go to both.

Tolerances: f32 rtol = atol = 1e-5 for the GEMM and rtol = atol = 1e-4
for the convs, as the reference's own conv test uses (the two sum in
different orders); bf16 one bf16 step (rtol 2^-7, plus 1e-5 of the
largest output). `im2col` is byte-equal.

tests/test_torch_gpu.py holds the CUDA kernels against these plain
versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dbb import pack_dbb as jpack
from repro.kernels.conv_gemm import ops as jconv
from repro.kernels.conv_gemm.ref import im2col as jim2col
from repro.kernels.sta_gemm.ops import sta_gemm as jsta_gemm
from repro_torch.core.dbb import DbbWeight
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.conv_gemm import (conv_gemm, conv_gemm_dbb,
                                           conv_gemm_dbb_ref, conv_gemm_packed,
                                           conv_gemm_ref, im2col, out_spatial)
from repro_torch.kernels.sta_gemm import sta_gemm, sta_gemm_ref

torch.set_num_threads(1)
CONV_TOL = dict(rtol=1e-4, atol=1e-4)


def _rng(seed):
    return np.random.default_rng(seed)


def _close_bf16(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    bound = 2.0 ** -7 * np.abs(want) + 1e-5 * np.abs(want).max()
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


# ---------------------------------------------------------------------------
# sta_gemm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["none", "relu", "gelu", "silu"])
@pytest.mark.parametrize("epi", ["plain", "bias", "bias+scale"])
def test_sta_gemm_matches_reference_f32(act, epi):
    m, k, n = 37, 72, 50                    # ragged against every tile
    r = _rng(10 * len(act) + len(epi))
    x = r.standard_normal((m, k)).astype(np.float32)
    w = r.standard_normal((k, n)).astype(np.float32)
    bias = r.standard_normal(n).astype(np.float32) if "bias" in epi else None
    scale = ((1 + 0.1 * r.standard_normal(n)).astype(np.float32)
             if "scale" in epi else None)
    want = jsta_gemm(jnp.asarray(x), jnp.asarray(w),
                     None if bias is None else jnp.asarray(bias),
                     None if scale is None else jnp.asarray(scale),
                     act=act, skinny=False)
    t = (lambda a: None if a is None else torch.from_numpy(a))
    before = dict(LAUNCHES)
    got = sta_gemm(t(x), t(w), t(bias), t(scale), act=act)
    assert LAUNCHES == before              # the plain version on the CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(
        got.numpy(), sta_gemm_ref(t(x), t(w), t(bias), t(scale),
                                  act=act).numpy())


@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("m,k,n", [(40, 96, 136), (130, 200, 24)])
def test_sta_gemm_matches_reference_bf16(act, m, k, n):
    r = _rng(m + k)
    x = r.standard_normal((m, k)).astype(np.float32)
    w = r.standard_normal((k, n)).astype(np.float32)
    bias = r.standard_normal(n).astype(np.float32)
    want = jsta_gemm(jnp.asarray(x, jnp.bfloat16),
                     jnp.asarray(w, jnp.bfloat16), jnp.asarray(bias),
                     act=act, skinny=False)
    assert want.dtype == jnp.bfloat16
    got = sta_gemm(torch.from_numpy(x).bfloat16(),
                   torch.from_numpy(w).bfloat16(), torch.from_numpy(bias),
                   act=act)
    assert got.dtype == torch.bfloat16
    _close_bf16(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_sta_gemm_out_dtype_and_batch_dims():
    r = _rng(7)
    x = torch.from_numpy(r.standard_normal((2, 3, 16)).astype(np.float32))
    w = torch.from_numpy(r.standard_normal((16, 20)).astype(np.float32))
    y = sta_gemm(x.bfloat16(), w.bfloat16(), out_dtype=torch.float32)
    assert y.shape == (2, 3, 20) and y.dtype == torch.float32
    with pytest.raises(TypeError):
        sta_gemm(x, w.bfloat16())          # w must be in x's dtype


# ---------------------------------------------------------------------------
# im2col and the conv wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("c", [1, 3, 16])
def test_im2col_byte_equal_to_reference(padding, stride, k, c):
    x = _rng(c + k).standard_normal((2, 9, 10, c)).astype(np.float32)
    want = np.asarray(jim2col(jnp.asarray(x), k, k, stride, padding))
    got = im2col(torch.from_numpy(x), k, k, stride, padding).numpy()
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_im2col_window_larger_than_image():
    x = np.ones((1, 2, 3, 2), np.float32)
    want = np.asarray(jim2col(jnp.asarray(x), 5, 5, 1, "VALID"))
    got = im2col(torch.from_numpy(x), 5, 5, 1, "VALID")
    assert tuple(got.shape) == want.shape == (1, 0, 0, 50)


@pytest.mark.parametrize("size,k,stride,padding", [
    (16, 3, 1, "SAME"), (16, 3, 2, "SAME"), (15, 5, 2, "SAME"),
    (9, 4, 2, "SAME"), (16, 5, 1, "VALID"), (11, 3, 3, "VALID")])
def test_out_spatial_matches_reference(size, k, stride, padding):
    assert out_spatial(size, k, stride, padding) == jconv.out_spatial(
        size, k, stride, padding)


def _conv_operands(seed, b, h, w, c, k, n):
    r = _rng(seed)
    x = r.standard_normal((b, h, w, c)).astype(np.float32)
    wt = (r.standard_normal((k * k * c, n)) / np.sqrt(k * k * c)
          ).astype(np.float32)
    bias = r.standard_normal(n).astype(np.float32)
    scale = (1 + 0.1 * r.standard_normal(n)).astype(np.float32)
    return x, wt, bias, scale


@pytest.mark.parametrize("h,w,c,k,n,stride,padding", [
    (8, 8, 3, 3, 32, 1, "SAME"),           # convnet conv0's channels
    (9, 7, 1, 5, 6, 1, "SAME"),            # lenet conv0's, odd sizes
    (10, 10, 16, 3, 10, 2, "SAME"),        # stride 2, odd pad split
    (12, 11, 3, 5, 32, 2, "VALID"),
    (8, 8, 16, 5, 6, 1, "VALID")])
def test_conv_gemm_matches_reference(h, w, c, k, n, stride, padding):
    x, wt, bias, scale = _conv_operands(h * c + k, 2, h, w, c, k, n)
    kw = dict(kh=k, kw=k, stride=stride, padding=padding, act="relu")
    want = np.asarray(jconv.conv_gemm(jnp.asarray(x), jnp.asarray(wt),
                                      jnp.asarray(bias), jnp.asarray(scale),
                                      **kw))
    t = torch.from_numpy
    before = dict(LAUNCHES)
    got = conv_gemm(t(x), t(wt), t(bias), t(scale), **kw).numpy()
    assert LAUNCHES == before
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **CONV_TOL)
    np.testing.assert_array_equal(
        got, conv_gemm_ref(t(x), t(wt), t(bias), t(scale), **kw).numpy())


def _packed(wt, nnz):
    """(reference DbbWeight, port DbbWeight) of a dense [K, N] weight."""
    jp = jpack(jnp.asarray(wt), 8, nnz)
    return jp, params_from_numpy(jp)


@pytest.mark.parametrize("h,w,c,k,n,stride,padding,nnz", [
    (8, 8, 16, 3, 32, 1, "SAME", 2),       # convnet conv1's geometry
    (9, 9, 8, 3, 10, 2, "SAME", 4),
    (10, 8, 16, 5, 6, 1, "VALID", 2),
    (7, 7, 8, 5, 32, 2, "SAME", 4)])
def test_conv_gemm_packed_matches_reference(h, w, c, k, n, stride, padding,
                                            nnz):
    x, wt, bias, _ = _conv_operands(h + c + nnz, 2, h, w, c, k, n)
    jp, tp = _packed(wt, nnz)
    assert isinstance(tp, DbbWeight)
    kw = dict(kh=k, kw=k, stride=stride, padding=padding, act="relu")
    want = np.asarray(jconv.conv_gemm_packed(jnp.asarray(x), jp,
                                             jnp.asarray(bias), **kw))
    got = conv_gemm_packed(torch.from_numpy(x), tp, torch.from_numpy(bias),
                           **kw).numpy()
    np.testing.assert_allclose(got, want, **CONV_TOL)
    raw = conv_gemm_dbb(torch.from_numpy(x), tp.values, tp.bitmask,
                        torch.from_numpy(bias), kh=k, kw=k, stride=stride,
                        padding=padding, act="relu", nnz=nnz).numpy()
    np.testing.assert_array_equal(got, raw)


@pytest.mark.parametrize("k,c,nnz", [(4, 1, 2), (4, 3, 4)])
def test_conv_gemm_dbb_ref_matches_reference_partial_blocks(k, c, nnz):
    """K % 8 == 0 but kw·C is not: the reference takes its explicit route,
    the port's kernel wrapper refuses, and its plain version agrees."""
    x, wt, bias, scale = _conv_operands(k * c, 2, 8, 8, c, k, 16)
    jp, tp = _packed(wt, nnz)
    kw = dict(kh=k, kw=k, padding="SAME", act="none")
    want = np.asarray(jconv.conv_gemm_dbb(
        jnp.asarray(x), jp.values, jp.bitmask, jnp.asarray(bias),
        jnp.asarray(scale), block=8, nnz=nnz, **kw))
    t = torch.from_numpy
    got = conv_gemm_dbb_ref(t(x), tp.values, tp.bitmask, t(bias), t(scale),
                            **kw).numpy()
    np.testing.assert_allclose(got, want, **CONV_TOL)
    with pytest.raises(ValueError, match="kw·C"):
        conv_gemm_dbb(t(x), tp.values, tp.bitmask, t(bias), t(scale),
                      nnz=nnz, **kw)


def test_conv_gemm_packed_refuses_a_wrong_k():
    p = params_from_numpy(jpack(jnp.zeros((32, 8)), 8, 2))
    with pytest.raises(ValueError, match="packed K"):
        conv_gemm_packed(torch.zeros((1, 6, 6, 3)), p, kh=3, kw=3)
