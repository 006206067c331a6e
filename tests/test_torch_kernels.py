"""Each kernel of the port against its Pallas kernel.

On the CPU a wrapper runs its kernel's plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode, as the reference's own tests do.
The same numpy-seeded inputs go to both. Tolerance: f32, rtol = atol =
1e-5 (the two sum in different orders).

tests/test_torch_gpu.py holds each CUDA kernel against its plain version
on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attn.ops import paged_decode_attention as jpaged
from repro.kernels.dbb_gemm.ops import dbb_gemm as jdbb_gemm
from repro.kernels.epilogue import Epilogue as JEpilogue
from repro.kernels.epilogue import apply_epilogue as japply_epilogue
from repro.kernels.sta_gemm.ops import sta_gemm as jsta_gemm
from repro.core.dbb import pack_dbb as jpack
from repro_torch.kernels.attn import (identity_block_table,
                                      paged_decode_attention)
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.dbb_gemm import dbb_gemm
from repro_torch.kernels.epilogue import Epilogue, apply_epilogue
from repro_torch.kernels.skinny import dbb_gemm_skinny, sta_gemm_skinny

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _dbb_operands(m, k, n, seed):
    r = _rng(seed)
    x = r.standard_normal((m, k)).astype(np.float32)
    w = r.standard_normal((k, n)).astype(np.float32)
    bias = r.standard_normal(n).astype(np.float32)
    scale = (1.0 + 0.1 * r.standard_normal(n)).astype(np.float32)
    p = jpack(jnp.asarray(w), 8, 4)
    values = np.asarray(p.values)
    bitmask = np.asarray(p.bitmask).view(np.int32)
    return x, values, bitmask, bias, scale


@pytest.mark.parametrize("act", ["none", "silu", "gelu", "relu"])
def test_epilogue_matches_reference(act):
    r = _rng(0)
    acc = r.standard_normal((6, 40)).astype(np.float32) * 3
    bias = r.standard_normal(40).astype(np.float32)
    scale = r.standard_normal(40).astype(np.float32)
    want = japply_epilogue(jnp.asarray(acc), JEpilogue(act, True, True),
                           jnp.float32, bias=jnp.asarray(bias)[None],
                           scale=jnp.asarray(scale)[None])
    got = apply_epilogue(torch.from_numpy(acc), Epilogue(act, True, True),
                         torch.float32, bias=torch.from_numpy(bias),
                         scale=torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("m,k,n,act,epi", [
    (48, 128, 128, "none", False),      # prefill q/k/v/o at smoke width
    (48, 128, 256, "silu", False),      # gate projection, fused act
    (48, 256, 128, "none", False),      # down projection
    (72, 64, 200, "gelu", True),        # ragged N, bias + scale
])
def test_dbb_gemm_plain_matches_pallas(m, k, n, act, epi):
    x, values, bitmask, bias, scale = _dbb_operands(m, k, n, seed=m + n)
    jb, js = (jnp.asarray(bias), jnp.asarray(scale)) if epi else (None, None)
    want = jdbb_gemm(jnp.asarray(x), jnp.asarray(values),
                     jnp.asarray(bitmask), jb, js, act=act, skinny=False)
    tb, ts = (torch.from_numpy(bias), torch.from_numpy(scale)) if epi \
        else (None, None)
    before = dict(LAUNCHES)
    got = dbb_gemm(torch.from_numpy(x), torch.from_numpy(values),
                   torch.from_numpy(bitmask), tb, ts, act=act)
    assert LAUNCHES == before          # the CPU path launches nothing
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("m,k,n,act", [
    (8, 128, 128, "none"),              # decode projections, B = 8
    (8, 128, 256, "silu"),
    (8, 256, 128, "none"),
    (3, 64, 96, "relu"),                # odd M, ragged N
])
def test_dbb_gemm_skinny_plain_matches_pallas(m, k, n, act):
    x, values, bitmask, bias, _ = _dbb_operands(m, k, n, seed=7 * m + n)
    want = jdbb_gemm(jnp.asarray(x), jnp.asarray(values),
                     jnp.asarray(bitmask), jnp.asarray(bias), act=act,
                     skinny=True)
    got = dbb_gemm_skinny(torch.from_numpy(x), torch.from_numpy(values),
                          torch.from_numpy(bitmask),
                          torch.from_numpy(bias), act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("m,k,n", [(8, 128, 512), (5, 64, 300)])
def test_sta_gemm_skinny_plain_matches_pallas(m, k, n):
    """The head GEMV: f32 hidden rows times the f32 [d, V] head."""
    r = _rng(m + k)
    x = r.standard_normal((m, k)).astype(np.float32)
    w = r.standard_normal((k, n)).astype(np.float32)
    want = jsta_gemm(jnp.asarray(x), jnp.asarray(w), skinny=True)
    got = sta_gemm_skinny(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _decode_operands(b, hkv, g, d, s, page, seed, shuffle=False):
    r = _rng(seed)
    q = r.standard_normal((b, hkv, g, d)).astype(np.float32)
    kc = r.standard_normal((b, s, hkv, d)).astype(np.float32)
    vc = r.standard_normal((b, s, hkv, d)).astype(np.float32)
    n_log = s // page
    kp = kc.reshape(b * n_log, page, hkv, d)
    vp = vc.reshape(b * n_log, page, hkv, d)
    table = np.asarray(identity_block_table(b, n_log, "cpu"))
    if shuffle:          # a true page pool: physical pages in random order
        perm = r.permutation(b * n_log)
        kp, vp = kp[np.argsort(perm)], vp[np.argsort(perm)]
        table = perm[table].astype(np.int32)
    lengths = r.integers(s // 2, s, b).astype(np.int32)
    start = np.minimum(r.integers(0, s // 2, b), lengths).astype(np.int32)
    return q, kp, vp, table, lengths, start


@pytest.mark.parametrize("g,window,softcap,shuffle", [
    (1, 0, 0.0, False),                 # the serving path: MHA, identity
    (2, 0, 0.0, True),                  # GQA group, shuffled pool
    (1, 5, 0.0, False),                 # sliding window
    (4, 0, 30.0, True),                 # logit softcap
])
def test_paged_decode_plain_matches_pallas(g, window, softcap, shuffle):
    args = _decode_operands(8, 4, g, 32, 24, 8, seed=g + window, shuffle=shuffle)
    want = jpaged(*map(jnp.asarray, args), window=window, softcap=softcap,
                  use_kernel=True)
    got = paged_decode_attention(*map(torch.from_numpy, args), window=window,
                                 softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    x, values, bitmask, _, _ = _dbb_operands(8, 64, 32, seed=1)
    tx, tv, tm = map(torch.from_numpy, (x, values, bitmask))
    with pytest.raises(ValueError):
        dbb_gemm_skinny(torch.zeros(40, 64), tv, tm)          # M > 32
    with pytest.raises(TypeError):
        dbb_gemm(tx, tv, tm.to(torch.int64))                  # mask dtype
    with pytest.raises(ValueError):
        dbb_gemm(tx, tv[:, ::2], tm[:, ::2])                  # strided
    with pytest.raises(ValueError):
        dbb_gemm(tx, tv, tm, block=4)                         # block != 8
    with pytest.raises(TypeError):
        sta_gemm_skinny(tx, torch.zeros(64, 16, dtype=torch.float64))
