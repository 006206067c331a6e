"""Each CUDA kernel against its plain PyTorch version on the card, at edge
shapes the serving path does not reach: ragged M, K and N, every skinny M
bucket, both activation dtypes, GQA groups, a sliding window, a logit
softcap, a shuffled page table, a page large enough to need dynamic
shared memory, and convolutions with odd image sizes, 1-16 channels,
stride 2 and VALID padding. Marked ``gpu``; each test skips without a
card.

Imports torch and the port only (the card's machine has no JAX):

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: f32 outputs rtol 1e-5, atol 1e-5·max|want| (the kernel and the
plain version sum in different orders); bf16 GEMM outputs rtol 2e-2, atol
2e-3·max|want| (one bf16 rounding step apart). bf16 attention (decode and
both prefills): atol 1e-2·max|want|, because the kernel rounds each tile's
unnormalised probabilities to bf16 (as the Pallas kernels do) and the
plain version the normalised ones: up to 2^-9 relative per term, summed
over up to 512 keys. Flash prefill compares the rows that see a key; a
row below a left-padded row's ``start`` is garbage by contract.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.dbb import pack_dbb
from repro_torch.kernels.attn import (flash_attention, identity_block_table,
                                      packed_flash_attention,
                                      paged_decode_attention)
from repro_torch.kernels.attn.ref import (flash_prefill_ref,
                                          packed_prefill_ref,
                                          paged_decode_ref)
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.conv_gemm import (conv_gemm, conv_gemm_dbb,
                                           conv_gemm_dbb_ref, conv_gemm_ref)
from repro_torch.kernels.dbb_gemm import dbb_gemm
from repro_torch.kernels.dbb_gemm.ref import dbb_gemm_ref
from repro_torch.kernels.skinny import dbb_gemm_skinny, sta_gemm_skinny
from repro_torch.kernels.sta_gemm import sta_gemm, sta_gemm_ref


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,s,hq,hkv,d,start,q_offset,window,softcap", [
    (2, 77, 77, 4, 4, 128, (0, 13), (0, 0), 0, 0.0),     # ragged T = S
    (2, 50, 190, 4, 2, 128, (5, 0), (120, 64), 0, 0.0),  # continuation, g 2
    (1, 130, 130, 2, 1, 64, (3,), (0,), 33, 20.0),       # window, softcap
    (3, 64, 64, 2, 1, 128, (0, 1, 63), (0, 0, 0), 0, 0.0),
])
def test_gpu_flash_prefill(cuda, dtype, b, t, s, hq, hkv, d, start,
                           q_offset, window, softcap):
    g = torch.Generator(device=cuda).manual_seed(t + s)
    q = torch.randn(b, t, hq, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, s, hkv, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, s, hkv, d, generator=g, device=cuda).to(dtype)
    st = torch.tensor(start, dtype=torch.int32, device=cuda)
    qo = torch.tensor(q_offset, dtype=torch.int32, device=cuda)
    before = LAUNCHES["flash_prefill"]
    got = flash_attention(q, k, v, st, q_offset=qo, window=window,
                          softcap=softcap)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_prefill"] == before + 1
    want = flash_prefill_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), st, qo, sm_scale=d ** -0.5,
                             window=window, softcap=softcap).transpose(1, 2)
    real = (torch.arange(t, device=cuda)[None, :] + qo[:, None]) >= st[:, None]
    _gpu_close(got[real], want[real], dtype, bf16_atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lens,pad,hq,hkv,window,softcap", [
    ((70, 90, 7, 150), 45, 4, 2, 0, 0.0),   # tile [64,128) meets segment 1
    ((100, 7, 150, 40), 36, 4, 4, 50, 30.0),
    ((1, 1, 300), 0, 2, 1, 0, 0.0),
])
def test_gpu_flash_prefill_packed(cuda, dtype, lens, pad, hq, hkv, window,
                                  softcap):
    t, d = sum(lens) + pad, 128
    g = torch.Generator(device=cuda).manual_seed(t)
    q = torch.randn(t, hq, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(t, hkv, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(t, hkv, d, generator=g, device=cuda).to(dtype)
    seg = torch.repeat_interleave(
        torch.arange(len(lens) + 1, dtype=torch.int32),
        torch.tensor(list(lens) + [pad])).to(cuda)
    before = LAUNCHES["flash_prefill_packed"]
    got = packed_flash_attention(q, k, v, seg, window=window,
                                 softcap=softcap)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_prefill_packed"] == before + 1
    want = packed_prefill_ref(q.transpose(0, 1), k.transpose(0, 1),
                              v.transpose(0, 1), seg, sm_scale=d ** -0.5,
                              window=window, softcap=softcap).transpose(0, 1)
    _gpu_close(got, want, dtype, bf16_atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,act,out_f32", [
    (1, 5, 3, "none", False),               # every edge ragged
    (37, 72, 50, "silu", False),
    (130, 200, 300, "gelu", True),          # f32 output of bf16 operands
    (512, 256, 384, "relu", False)])
def test_gpu_sta_gemm(cuda, dtype, m, k, n, act, out_f32):
    g = torch.Generator(device=cuda).manual_seed(m + k)
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    w = torch.randn(k, n, generator=g, device=cuda).to(dtype)
    bias = torch.randn(n, generator=g, device=cuda)
    scale = torch.rand(n, generator=g, device=cuda) + 0.5
    od = torch.float32 if out_f32 else None
    before = LAUNCHES["sta_gemm"]
    got = sta_gemm(x, w, bias, scale, act=act, out_dtype=od)
    torch.cuda.synchronize()
    assert LAUNCHES["sta_gemm"] == before + 1
    assert got.dtype == (od or dtype)
    _gpu_close(got, sta_gemm_ref(x, w, bias, scale, act=act, out_dtype=od),
               dtype)


def _conv_inputs(cuda, b, h, w, c, k, n, dtype):
    g = torch.Generator(device=cuda).manual_seed(h * w + c + n)
    x = torch.randn(b, h, w, c, generator=g, device=cuda).to(dtype)
    wt = torch.randn(k * k * c, n, generator=g, device=cuda) / (k * k * c
                                                                ) ** 0.5
    bias = torch.randn(n, generator=g, device=cuda)
    scale = torch.rand(n, generator=g, device=cuda) + 0.5
    return x, wt, bias, scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c,k,n,stride,padding", [
    (2, 9, 7, 1, 5, 6, 1, "SAME"),          # lenet conv0's channels
    (2, 8, 8, 3, 3, 64, 1, "SAME"),         # convnet conv0's
    (2, 10, 10, 16, 3, 10, 2, "SAME"),      # stride 2, odd pad split
    (3, 12, 11, 3, 5, 200, 2, "VALID"),
    (1, 33, 33, 8, 3, 130, 1, "SAME")])     # 16-byte gathers, ragged N
def test_gpu_conv_gemm(cuda, dtype, b, h, w, c, k, n, stride, padding):
    x, wt, bias, scale = _conv_inputs(cuda, b, h, w, c, k, n, dtype)
    kw = dict(kh=k, kw=k, stride=stride, padding=padding, act="relu")
    before = LAUNCHES["conv_gemm"]
    got = conv_gemm(x, wt.to(dtype), bias, scale, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["conv_gemm"] == before + 1
    _gpu_close(got, conv_gemm_ref(x, wt.to(dtype), bias, scale, **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c,k,n,stride,padding,nnz", [
    (2, 8, 8, 16, 3, 32, 1, "SAME", 2),
    (2, 9, 9, 8, 3, 10, 2, "SAME", 4),
    (2, 16, 16, 64, 3, 128, 1, "SAME", 2),  # convnet conv1's geometry
    (1, 10, 8, 16, 5, 6, 1, "VALID", 3)])
def test_gpu_conv_gemm_dbb(cuda, dtype, b, h, w, c, k, n, stride, padding,
                           nnz):
    x, wt, bias, scale = _conv_inputs(cuda, b, h, w, c, k, n, dtype)
    p = pack_dbb(wt, 8, nnz)
    kw = dict(kh=k, kw=k, stride=stride, padding=padding, act="relu")
    before = LAUNCHES["conv_gemm_dbb"]
    got = conv_gemm_dbb(x, p.values, p.bitmask, bias, scale, nnz=nnz, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["conv_gemm_dbb"] == before + 1
    _gpu_close(got, conv_gemm_dbb_ref(x, p.values, p.bitmask, bias, scale,
                                      **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["convnet-dbb", "lenet5-dbb"])
@pytest.mark.parametrize("mode", ["sta", "dbb"])
def test_gpu_cnn_kernel_route_matches_plain_route(cuda, arch, mode):
    from repro_torch.configs import get_config
    from repro_torch.core.dbb_linear import pack_tree
    from repro_torch.core.sparsity import apply_dbb_to_tree
    from repro_torch.models import cnn
    cfg = get_config(arch, smoke=True)
    params = cnn.cnn_init(cfg, seed=0, device=cuda)
    if mode == "dbb":
        params = pack_tree(apply_dbb_to_tree(params, cfg.dbb), cfg.dbb)
    g = torch.Generator(device=cuda).manual_seed(1)
    img = torch.randn(8, cfg.cnn_img, cfg.cnn_img, cfg.cnn_in_ch,
                      generator=g, device=cuda)
    before = LAUNCHES["conv_gemm"] + LAUNCHES["conv_gemm_dbb"]
    got = cnn.cnn_apply(params, cfg, img, matmul=mode)
    torch.cuda.synchronize()
    # lenet's smoke convs (N = 4 and 8) take the plain route by design
    launched = LAUNCHES["conv_gemm"] + LAUNCHES["conv_gemm_dbb"] - before
    assert launched == (2 if arch == "convnet-dbb" else 0)
    want = cnn.cnn_apply(params, cfg, img, matmul=mode, use_kernel=False)
    _gpu_close(got, want, torch.float32)
