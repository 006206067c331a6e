"""Each CUDA kernel against its plain PyTorch version on the card, at edge
shapes the serving path does not reach: ragged M and N, every skinny M
bucket, both activation dtypes, GQA groups, a sliding window, a logit
softcap, a shuffled page table and a page large enough to need dynamic
shared memory. Marked ``gpu``; each test skips without a card.

Imports torch and the port only (the card's machine has no JAX):

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: f32 outputs rtol 1e-5, atol 1e-5·max|want| (the kernel and the
plain version sum in different orders); bf16 GEMM outputs rtol 2e-2, atol
2e-3·max|want| (one bf16 rounding step apart). bf16 decode attention: atol
1e-2·max|want|, because the kernel rounds each page's unnormalised
probabilities to bf16 (as the Pallas kernel does) and the plain version
the normalised ones: up to 2^-9 relative per term, summed over up to 512
keys.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.dbb import pack_dbb
from repro_torch.kernels.attn import identity_block_table, paged_decode_attention
from repro_torch.kernels.attn.ref import paged_decode_ref
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.dbb_gemm import dbb_gemm
from repro_torch.kernels.dbb_gemm.ref import dbb_gemm_ref
from repro_torch.kernels.skinny import dbb_gemm_skinny, sta_gemm_skinny
from repro_torch.kernels.skinny.ref import sta_gemm_ref


def _decode_operands(b, hkv, g, d, s, page, seed, shuffle=False):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, hkv, g, d)).astype(np.float32)
    kc = r.standard_normal((b, s, hkv, d)).astype(np.float32)
    vc = r.standard_normal((b, s, hkv, d)).astype(np.float32)
    n_log = s // page
    kp = kc.reshape(b * n_log, page, hkv, d)
    vp = vc.reshape(b * n_log, page, hkv, d)
    table = np.asarray(identity_block_table(b, n_log, "cpu"))
    if shuffle:
        perm = r.permutation(b * n_log)
        kp, vp = kp[np.argsort(perm)], vp[np.argsort(perm)]
        table = perm[table].astype(np.int32)
    lengths = r.integers(s // 2, s, b).astype(np.int32)
    start = np.minimum(r.integers(0, s // 2, b), lengths).astype(np.int32)
    return q, kp, vp, table, lengths, start


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gpu_close(got, want, dtype, bf16_atol=2e-3):
    rtol = 1e-5 if dtype == torch.float32 else 2e-2
    atol = 1e-5 if dtype == torch.float32 else bf16_atol
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,act", [(1, 64, 96, "none"),
                                       (130, 136, 200, "silu"),
                                       (512, 256, 384, "gelu")])
def test_gpu_dbb_gemm(cuda, dtype, m, k, n, act):
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    p = pack_dbb(torch.randn(k, n, generator=g, device=cuda), 8, 4)
    bias = torch.randn(n, generator=g, device=cuda)
    before = LAUNCHES["dbb_gemm"]
    got = dbb_gemm(x, p.values, p.bitmask, bias, act=act)
    torch.cuda.synchronize()
    assert LAUNCHES["dbb_gemm"] == before + 1
    _gpu_close(got, dbb_gemm_ref(x, p.values, p.bitmask, bias, act=act),
               dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 8, 13, 32])
def test_gpu_dbb_gemm_skinny(cuda, dtype, m):
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn(m, 264, generator=g, device=cuda).to(dtype)
    p = pack_dbb(torch.randn(264, 100, generator=g, device=cuda), 8, 3)
    scale = torch.rand(100, generator=g, device=cuda) + 0.5
    got = dbb_gemm_skinny(x, p.values, p.bitmask, None, scale, act="silu",
                          nnz=3)
    _gpu_close(got, dbb_gemm_ref(x, p.values, p.bitmask, None, scale,
                                 act="silu"), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 8, 20, 32])
def test_gpu_sta_gemm_skinny(cuda, dtype, m):
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn(m, 256, generator=g, device=cuda).to(dtype)
    w = torch.randn(256, 1000, generator=g, device=cuda).to(dtype)
    _gpu_close(sta_gemm_skinny(x, w), sta_gemm_ref(x, w), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,page,window,softcap,shuffle", [
    (1, 64, 0, 0.0, False), (4, 16, 7, 0.0, True), (32, 256, 0, 20.0, True)])
def test_gpu_paged_decode(cuda, dtype, g, page, window, softcap, shuffle):
    args = _decode_operands(4, 2, g, 128, 512, page, seed=g,
                            shuffle=shuffle)
    q, kp, vp, table, lengths, start = (torch.from_numpy(a).to(cuda)
                                        for a in args)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    got = paged_decode_attention(q, kp, vp, table, lengths, start,
                                 window=window, softcap=softcap)
    want = paged_decode_ref(q, kp, vp, table, lengths, start,
                            sm_scale=128 ** -0.5, window=window,
                            softcap=softcap)
    _gpu_close(got, want, dtype, bf16_atol=1e-2)
