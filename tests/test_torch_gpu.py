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
row below a left-padded row's ``start`` is garbage by contract. The fused
w4 and INT8-valued DBB planes: the same GEMM tolerances (the kernel and
the plain version dequantize to the same bits; the INT8 plane's scale
rides the epilogue in both). The fused
sampling head: scores within 1e-5 of the largest (the GEMV sums in
another order, logf may differ by an ulp), indices equal on every row
whose top-2 score margin exceeds twice that; at temperature 0 with
default penalties it is the skinny head's argmax bit for bit. The int8
branches (INT8 x INT8 -> INT32): bit-equal for int32 outputs and for
int8 and f32 outputs after none or relu (integer sums are exact in any
order, and the f32 epilogue takes torch's separate multiply and add);
after gelu or silu f32 within rtol 1e-6 (atol 1e-7·max|want|: libm
tanh / exp may differ by an ulp) and int8 / int32 off by at most 1 on at
most 0.1% of the elements (at least one). The tensor-core body of the
bf16 sta_gemm and dbb_gemm branches: the bf16 GEMM tolerance against the
plain versions; exact where the math is exact (one-hot probes, a row at
any M, dbb_gemm against sta_gemm on the decompressed weight). The
tensor-core body of the bf16 flash prefills (D 64, 128, 256): the bf16
attention tolerance against the plain versions at T and S of 1 to 1000,
ragged starts, offsets, whole tiles masked, views at 16-byte offsets;
every output finite; a row's output bit for bit the same at any T or
place in its tile; a ``_tc`` launch counted for each bf16 D 64 / 128
call and for no other. The split-K bodies (dbb_gemm_skinny's float
branches, dbb_gemm's f32 x at N <= 16): the GEMM tolerances above against
the plain versions on every plane and M bucket, ragged K slices and both
copy paths (TMA boxes, cp.async); every output finite; a row bit for bit
the same at any M <= 32 or place in the batch; two calls bit-equal; a
``_split`` / ``_narrow`` launch counted by the launchers' own rules. The
int8 tensor-core body (the int8 branches of sta_gemm and dbb_gemm, K
and N multiples of 16): the int8 branches' tolerance
against the plain versions at ragged M, K off the 128-deep stage, N off
the tile, both tile heights and every nnz; bit-equal to the IMAD body on
zero-padded neighbours of its rule (the same sums); the all-127 sums
exactly; two calls and a row at any M bit-equal; a ``_s8_tc`` launch
counted by the launchers' own rules. The tensor-core body of conv_gemm_dbb
(f32 images on 3xTF32 wgmma, int8 ones on s8 wgmma, the image by TMA
im2col boxes): the f32 tolerance above and the int8 branches' against the
plain version at convnet conv1 / conv2's geometry, ragged pixel tiles, N
off the tile, stride 2 and VALID; int8 outputs bit-equal to the IMAD
body on a zero-padded neighbour off the rule; an image's output bit for
bit the same in any batch; the all-127 sums exactly; a ``_tc`` launch
counted by the launcher's own rule. The fused sampling head on the skinny
float body: the fused head's tolerance above on every cluster size and
with blocks that walk two tiles; at temperature 0 the skinny head's logit
and argmax bit for bit at olmo-1b's head; ties to the lowest index across
tiles and blocks; a row's sample the same in any batch. conv_gemm's
small-C body: the f32 tolerance against the plain version, bit-equal to
the FMA body (f32) and the IMAD body (int8) on the same weights, the int8
branches' tolerance (bit-equal after none or relu) against the plain
version; its dense images on the tensor-core body: the f32 tolerance,
bit-equal to conv_gemm_dbb's body on the weight as an all-ones plane of
nnz 8, int8 as the int8 branches; ``_small`` / ``_tc`` launches counted
by the launcher's own rules.
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
@pytest.mark.parametrize("kernel", ["sta_gemm_skinny", "dbb_gemm_skinny"])
def test_gpu_skinny_row_is_the_same_bits_in_any_batch(cuda, kernel):
    """The skinny kernels keep every M <= 32 row in one block with a K
    order that reads no M: rows 0..7, 8..15 and 16..23 of an M24 call (the
    speculative verify) equal M8 calls (decode) on those rows bit for
    bit."""
    g = torch.Generator(device=cuda).manual_seed(24)
    x = torch.randn(24, 512, generator=g, device=cuda)
    if kernel == "sta_gemm_skinny":
        w = torch.randn(512, 640, generator=g, device=cuda)

        def run(a):
            return sta_gemm_skinny(a, w)
    else:
        p = pack_dbb(torch.randn(512, 640, generator=g, device=cuda), 8, 4)

        def run(a):
            return dbb_gemm_skinny(a.bfloat16(), p.values, p.bitmask,
                                   act="silu")
    full = run(x)
    for r0 in (0, 8, 16):
        assert torch.equal(full[r0:r0 + 8], run(x[r0:r0 + 8].contiguous()))


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


def _long_decode(cuda, dtype, b=8, hkv=4, g=1, d=128, page=64, n_log=10,
                 seed=0):
    """serve's decode shape at long contexts: a contiguous cache [B, S,
    Hkv, D] (S = n_log pages), lengths 256 to S - 1 and ragged starts,
    as (q, k cache, v cache, lengths, start)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    s = n_log * page
    q = torch.randn(b, hkv, g, d, generator=gen, device=cuda).to(dtype)
    kc = torch.randn(b, s, hkv, d, generator=gen, device=cuda).to(dtype)
    vc = torch.randn(b, s, hkv, d, generator=gen, device=cuda).to(dtype)
    lengths = torch.randint(256, s, (b,), generator=gen, device=cuda,
                            dtype=torch.int32)
    start = torch.randint(0, 200, (b,), generator=gen, device=cuda,
                          dtype=torch.int32)
    return q, kc, vc, lengths, start


def _pool(kc, vc, page, extra, seed):
    """The contiguous cache's pages scattered over a pool with ``extra``
    more logical pages a row (never live) and as many spare physical
    pages, in random order: (k pool, v pool, table)."""
    b, s, hkv, d = kc.shape
    n_log = s // page
    gen = torch.Generator().manual_seed(seed)
    total = b * (n_log + extra) + 5
    perm = torch.randperm(total, generator=gen).to(kc.device)
    kp = torch.zeros(total, page, hkv, d, dtype=kc.dtype, device=kc.device)
    vp = torch.zeros_like(kp)
    table = perm[:b * (n_log + extra)].view(b, n_log + extra).int()
    kp[table[:, :n_log].reshape(-1).long()] = kc.reshape(-1, page, hkv, d)
    vp[table[:, :n_log].reshape(-1).long()] = vc.reshape(-1, page, hkv, d)
    return kp, vp, table.contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (300, 30.0)])
def test_gpu_paged_decode_long_contexts(cuda, dtype, window, softcap):
    """Contexts of 256-639 keys (serve's), 10 one-page splits a row at
    page 64, through a shuffled pool: the plain version's tolerance."""
    q, kc, vc, lengths, start = _long_decode(cuda, dtype)
    kp, vp, table = _pool(kc, vc, 64, 0, seed=1)
    got = paged_decode_attention(q, kp, vp, table, lengths, start,
                                 window=window, softcap=softcap)
    want = paged_decode_ref(q, kp, vp, table, lengths, start,
                            sm_scale=128 ** -0.5, window=window,
                            softcap=softcap)
    assert torch.isfinite(got).all()
    _gpu_close(got, want, dtype, bf16_atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [16, 64, 128])
def test_gpu_paged_decode_layouts_give_equal_bits(cuda, dtype, page):
    """The same rows through the contiguous cache (identity table) and
    through a shuffled pool whose table is wider (another n_log): equal
    bits, since a row's splits read neither the layout nor n_log; two
    calls give equal bits too."""
    q, kc, vc, lengths, start = _long_decode(cuda, dtype, page=page,
                                             n_log=640 // page, seed=page)
    b, s, hkv, d = kc.shape
    n_log = s // page
    ident = paged_decode_attention(
        q, kc.view(b * n_log, page, hkv, d), vc.view(b * n_log, page, hkv, d),
        identity_block_table(b, n_log, cuda), lengths, start, window=200)
    kp, vp, table = _pool(kc, vc, page, 3, seed=page + 1)
    pooled = paged_decode_attention(q, kp, vp, table, lengths, start,
                                    window=200)
    assert torch.equal(ident, pooled)
    assert torch.equal(pooled, paged_decode_attention(
        q, kp, vp, table, lengths, start, window=200))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_paged_decode_row_alone_equals_row_in_batch(cuda, dtype):
    """A row decoded alone (its own table row, B 1) gives the bits it gets
    inside the batch of 8."""
    q, kc, vc, lengths, start = _long_decode(cuda, dtype, hkv=2, g=4,
                                             seed=3)
    kp, vp, table = _pool(kc, vc, 64, 2, seed=4)
    full = paged_decode_attention(q, kp, vp, table, lengths, start,
                                  softcap=20.0)
    for r in (0, 3, 7):
        one = paged_decode_attention(
            q[r:r + 1].clone(), kp, vp, table[r:r + 1].clone(),
            lengths[r:r + 1].clone(), start[r:r + 1].clone(), softcap=20.0)
        assert torch.equal(full[r:r + 1], one), r


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_paged_decode_masked_chunks_and_pages(cuda, dtype):
    """Keys masked in whole chunks and pages: left padding past the first
    pages, a window that ends inside a page, a 128-slot page whose first or
    last 64 keys are all masked, a row of one valid key. Each masked chunk
    contributes nothing: the plain version's tolerance, every value
    finite."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    b, hkv, g, d, page, n_log = 6, 2, 2, 64, 128, 5
    s = page * n_log
    q = torch.randn(b, hkv, g, d, generator=gen, device=cuda).to(dtype)
    kc = torch.randn(b, s, hkv, d, generator=gen, device=cuda).to(dtype)
    vc = torch.randn(b, s, hkv, d, generator=gen, device=cuda).to(dtype)
    i32 = dict(dtype=torch.int32, device=cuda)
    lengths = torch.tensor([600, 600, 200, 63, 300, 500], **i32)
    start = torch.tensor([0, 390, 140, 63, 257, 10], **i32)
    kp, vp, table = _pool(kc, vc, page, 1, seed=10)
    for window in (0, 100):
        got = paged_decode_attention(q, kp, vp, table, lengths, start,
                                     window=window)
        want = paged_decode_ref(q, kp, vp, table, lengths, start,
                                sm_scale=d ** -0.5, window=window)
        assert torch.isfinite(got).all()
        _gpu_close(got, want, dtype, bf16_atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,k,n", [(torch.float32, 2048, 4099),
                                       (torch.bfloat16, 8192, 2048),
                                       (torch.bfloat16, 136, 999)])
def test_gpu_sta_gemm_skinny_rows_equal_at_any_m(cuda, dtype, k, n):
    """All M <= 32 rows share one weight pass in a K order that reads no M,
    no tiling and no cluster split: every row of an M 1, 8, 24 or 32 call
    is the same row at M 1 bit for bit, on the 16-byte, 4-byte and 2-byte
    copy paths (N 4099 f32, N 999 bf16) and the cluster split (K8192
    N2048); the plain version's tolerance."""
    gen = torch.Generator(device=cuda).manual_seed(k + n)
    x = torch.randn(32, k, generator=gen, device=cuda).to(dtype)
    w = (torch.randn(k, n, generator=gen, device=cuda) * 0.05).to(dtype)
    bias = torch.randn(n, generator=gen, device=cuda)
    ones = [sta_gemm_skinny(x[r:r + 1].contiguous(), w, bias, act="silu")
            for r in range(32)]
    for m in (1, 8, 24, 32):
        got = sta_gemm_skinny(x[:m].contiguous(), w, bias, act="silu")
        for r in range(m):
            assert torch.equal(got[r:r + 1], ones[r]), (m, r)
    _gpu_close(got, sta_gemm_ref(x, w, bias, act="silu"), dtype)


def _flash_tc_counted(before, name, dtype, d):
    """A bf16 launch at D 64 / 128 / 256 counts one ``_tc`` launch beside
    the kernel's; any other launch leaves the ``_tc`` count alone."""
    from repro_torch.kernels.attn.ops import tc_body
    assert LAUNCHES[name] == before[name] + 1
    assert tc_body(dtype, d) == (dtype == torch.bfloat16
                                 and d in (64, 128, 256))
    assert LAUNCHES[name + "_tc"] == before[name + "_tc"] + tc_body(dtype, d)


def _flash_case(cuda, dtype, b, t, s, hq, hkv, d, start, q_offset, window,
                softcap, q=None, k=None, v=None):
    g = torch.Generator(device=cuda).manual_seed(t + s)
    if q is None:
        q = torch.randn(b, t, hq, d, generator=g, device=cuda).to(dtype)
        k = torch.randn(b, s, hkv, d, generator=g, device=cuda).to(dtype)
        v = torch.randn(b, s, hkv, d, generator=g, device=cuda).to(dtype)
    st = torch.tensor(start, dtype=torch.int32, device=cuda)
    qo = torch.tensor(q_offset, dtype=torch.int32, device=cuda)
    before = dict(LAUNCHES)
    got = flash_attention(q, k, v, st, q_offset=qo, window=window,
                          softcap=softcap)
    torch.cuda.synchronize()
    _flash_tc_counted(before, "flash_prefill", dtype, d)
    assert torch.isfinite(got.float()).all()     # rows seeing no key too
    want = flash_prefill_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), st, qo, sm_scale=d ** -0.5,
                             window=window, softcap=softcap).transpose(1, 2)
    real = (torch.arange(t, device=cuda)[None, :] + qo[:, None]) >= st[:, None]
    _gpu_close(got[real], want[real], dtype, bf16_atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,s,hq,hkv,d,start,q_offset,window,softcap", [
    (2, 77, 77, 4, 4, 128, (0, 13), (0, 0), 0, 0.0),     # ragged T = S
    (2, 50, 190, 4, 2, 128, (5, 0), (120, 64), 0, 0.0),  # continuation, g 2
    (1, 130, 130, 2, 1, 64, (3,), (0,), 33, 20.0),       # window, softcap
    (3, 64, 64, 2, 1, 128, (0, 1, 63), (0, 0, 0), 0, 0.0),
    (1, 1, 1, 2, 2, 128, (0,), (0,), 0, 0.0),            # T = S = 1
    (2, 63, 63, 2, 1, 128, (0, 17), (0, 0), 0, 0.0),
    (2, 65, 65, 2, 2, 64, (0, 64), (0, 0), 0, 0.0),      # start on a tile
    (1, 127, 127, 4, 2, 128, (30,), (0,), 0, 0.0),
    (2, 129, 257, 2, 2, 128, (0, 100), (128, 7), 0, 0.0),
    (1, 1000, 1000, 2, 1, 128, (333,), (0,), 0, 0.0),
    (2, 1, 1000, 2, 2, 128, (0, 500), (999, 640), 0, 0.0),  # one-row chunk
    (2, 63, 1000, 2, 2, 64, (65, 0), (937, 65), 0, 0.0),
    (1, 100, 100, 2, 2, 72, (7,), (0,), 0, 0.0),         # D 72: FMA body
    # D 256 (paligemma: MQA, 8 query heads on one KV head): two consumer
    # warpgroups in bf16, 32 columns a thread in the FMA body
    (1, 384, 384, 8, 1, 256, (0,), (0,), 0, 0.0),
    (2, 77, 77, 8, 1, 256, (0, 13), (0, 0), 0, 0.0),
    (2, 50, 190, 8, 1, 256, (5, 0), (120, 64), 0, 0.0),  # continuation
    (1, 130, 130, 2, 1, 256, (3,), (0,), 33, 20.0),      # window, softcap
    (2, 1, 1000, 2, 2, 256, (0, 500), (999, 640), 0, 0.0),
    (1, 100, 100, 2, 2, 192, (7,), (0,), 0, 0.0),        # D 192: FMA body
])
def test_gpu_flash_prefill(cuda, dtype, b, t, s, hq, hkv, d, start,
                           q_offset, window, softcap):
    _flash_case(cuda, dtype, b, t, s, hq, hkv, d, start, q_offset, window,
                softcap)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_gpu_flash_prefill_whole_tiles_masked(cuda, dtype, d):
    """Batch row 0's keys start at 200, so its first three query tiles
    (rows 0-191) see no key at all and run no tile; a 16-key window leaves
    most rows of each block with a whole running tile masked (a row past
    key kj0 + 79 sees none of tile kj0's keys). Every output stays finite;
    the real rows match."""
    _flash_case(cuda, dtype, 2, 256, 256, 2, 2, d, (200, 0), (0, 0), 16,
                0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lens,pad,hq,hkv,d,window,softcap", [
    ((70, 90, 7, 150), 45, 4, 2, 128, 0, 0.0),   # tile [64,128) meets seg 1
    ((100, 7, 150, 40), 36, 4, 4, 128, 50, 30.0),
    ((1, 1, 300), 0, 2, 1, 128, 0, 0.0),
    ((1,), 0, 2, 2, 128, 0, 0.0),                # T = 1
    ((63,), 0, 2, 2, 64, 0, 0.0),
    ((64, 1, 62), 2, 2, 2, 128, 0, 0.0),         # boundaries on the tiles
    ((65, 62), 2, 2, 1, 64, 0, 0.0),
    ((127, 2), 0, 2, 2, 128, 0, 0.0),
    ((129, 500, 371), 0, 2, 2, 128, 0, 0.0),     # T 1000
    ((5, 3, 7, 64, 1, 1, 2, 90), 27, 2, 2, 128, 8, 0.0),
    ((100, 100), 0, 2, 2, 72, 0, 0.0),           # D 72: FMA body
    ((70, 90, 7, 150), 45, 8, 1, 256, 0, 0.0),   # D 256, MQA g 8
    ((129, 500, 371), 0, 2, 1, 256, 0, 0.0),
    ((5, 3, 7, 64, 1, 1, 2, 90), 27, 2, 2, 256, 8, 0.0),
])
def test_gpu_flash_prefill_packed(cuda, dtype, lens, pad, hq, hkv, d,
                                  window, softcap):
    """The short segments under an 8-key window (the case before last)
    put rows whose whole first running tile holds no key of theirs beside
    rows that see it: the probability mask's case."""
    t = sum(lens) + pad
    g = torch.Generator(device=cuda).manual_seed(t)
    q = torch.randn(t, hq, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(t, hkv, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(t, hkv, d, generator=g, device=cuda).to(dtype)
    seg = torch.repeat_interleave(
        torch.arange(len(lens) + 1, dtype=torch.int32),
        torch.tensor(list(lens) + [pad])).to(cuda)
    before = dict(LAUNCHES)
    got = packed_flash_attention(q, k, v, seg, window=window,
                                 softcap=softcap)
    torch.cuda.synchronize()
    _flash_tc_counted(before, "flash_prefill_packed", dtype, d)
    assert torch.isfinite(got.float()).all()
    want = packed_prefill_ref(q.transpose(0, 1), k.transpose(0, 1),
                              v.transpose(0, 1), seg, sm_scale=d ** -0.5,
                              window=window, softcap=softcap).transpose(0, 1)
    _gpu_close(got, want, dtype, bf16_atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("packed", [False, True])
def test_gpu_flash_prefill_views_at_16_byte_offsets(cuda, dtype, packed):
    """q, k and v as contiguous views 16 bytes (and 32, 48) into larger
    buffers: the kernels take any 16-byte-aligned base, not only an
    allocation's."""
    b, t, h, d = (1, 200, 2, 128) if packed else (2, 100, 2, 128)
    off = 16 // torch.tensor([], dtype=dtype).element_size()
    g = torch.Generator(device=cuda).manual_seed(3)
    n = b * t * h * d
    shape = (t, h, d) if packed else (b, t, h, d)
    q, k, v = (torch.randn(n + 3 * off, generator=g, device=cuda).to(dtype)
               [off * i:off * i + n].view(shape) for i in (1, 2, 3))
    assert all(a.data_ptr() % 128 for a in (q, k, v))
    if not packed:
        _flash_case(cuda, dtype, b, t, t, h, h, d, (0, 9), (0, 0), 0, 0.0,
                    q=q, k=k, v=v)
        return
    seg = torch.repeat_interleave(torch.arange(3, dtype=torch.int32),
                                  torch.tensor([90, 70, 40])).to(cuda)
    before = dict(LAUNCHES)
    got = packed_flash_attention(q, k, v, seg)
    torch.cuda.synchronize()
    _flash_tc_counted(before, "flash_prefill_packed", dtype, d)
    want = packed_prefill_ref(q.transpose(0, 1), k.transpose(0, 1),
                              v.transpose(0, 1), seg, sm_scale=d ** -0.5
                              ).transpose(0, 1)
    _gpu_close(got, want, dtype, bf16_atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128, 256])
def test_gpu_flash_tc_row_is_the_same_bits_at_any_t(cuda, d):
    """The tensor-core body sums a row's keys tile by tile in one order
    whatever T, S or its place in the block: row 150 of a T = S = 200
    prefill equals the same query as a one-row chunk at q_offset 150 and
    as row 22 of a 64-row chunk at q_offset 128 (S 200), bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn(1, 200, 2, d, generator=g, device=cuda).to(BF)
               for _ in range(3))

    def run(lo, hi):
        qo = torch.tensor([lo], dtype=torch.int32, device=cuda)
        return flash_attention(q[:, lo:hi].contiguous(), k, v, q_offset=qo)
    full = run(0, 200)[0, 150]
    assert torch.equal(full, run(150, 151)[0, 0])
    assert torch.equal(full, run(128, 192)[0, 22])


@pytest.mark.gpu
def test_gpu_flash_tc_counts_follow_the_kernels_own_rule(cuda):
    """attn.ops.tc_body mirrors the launchers' rule: the libraries'
    exported flash_prefill_tc_body / flash_prefill_packed_tc_body agree on
    every dtype and a grid of D."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.attn.ops import tc_body
    for name in ("flash_prefill", "flash_prefill_packed"):
        rule = getattr(build.load(name), f"{name}_tc_body")
        rule.argtypes = [ctypes.c_int] * 2
        for dt in (torch.float32, BF):
            for d in (1, 32, 63, 64, 65, 72, 96, 128, 129, 256):
                assert bool(rule(build.dtype_code(dt), d)) == tc_body(dt, d)


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


def _head_sample_case(cuda, m, k, n, seed):
    """Hidden rows scaled so the logits are O(1) (the noise decides
    tokens), counts with some rows above zero, ragged penalties, and
    temperature-0 rows among the sampled ones."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    h = torch.randn(m, k, generator=g, device=cuda) / k ** 0.5
    w = torch.randn(k, n, generator=g, device=cuda)
    counts = torch.randint(0, 3, (m, n), generator=g, device=cuda,
                           dtype=torch.int32)
    counts[::3] = 0
    r = torch.arange(m, device=cuda)
    f32 = dict(dtype=torch.float32)
    temp = torch.where(r % 4 == 0, 0.0, 0.5 + 0.1 * (r % 7)).to(**f32)
    rep = torch.where(r % 2 == 0, 1.0, 1.3).to(**f32)
    pres = torch.where(r % 3 == 1, 0.4, 0.0).to(**f32)
    freq = torch.where(r % 5 == 2, 0.2, 0.0).to(**f32)
    seed_ = (r * 7919 - 3).to(torch.int32)
    step = (r * 3).to(torch.int32)
    return h, w, counts, (temp, rep, pres, freq, seed_, step)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,base", [(1, 2048, 50304, 0),
                                        (8, 2048, 50304, 0),
                                        (24, 256, 1024, 0),
                                        (32, 128, 384, 1000)])
def test_gpu_head_sample_fused(cuda, m, k, n, base):
    """Against the plain version: scores within f32 tolerance (the GEMV
    sums in another order; logf may differ by an ulp), indices equal on
    every row whose top-2 score margin exceeds twice that tolerance."""
    from repro_torch.kernels.sample import (head_sample_fused,
                                            head_sample_fused_ref,
                                            sample_scores)
    h, w, counts, rows = _head_sample_case(cuda, m, k, n, m + k)
    before = LAUNCHES["head_sample_fused"]
    got_s, got_i = head_sample_fused(h, w, counts, *rows, base=base)
    torch.cuda.synchronize()
    assert LAUNCHES["head_sample_fused"] == before + 1
    want_s, want_i = head_sample_fused_ref(h, w, counts, *rows, base=base)
    scale = max(want_s.abs().max().item(), 1.0)
    tol = 1e-5 * scale
    torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=tol)
    col = base + torch.arange(n, device=cuda)[None, :]
    temp, rep, pres, freq, seed_, step = (a[:, None] for a in rows)
    scores = sample_scores(h @ w, counts, temp, rep, pres, freq, seed_,
                           step, col)
    top2 = scores.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * tol
    assert bool((got_i == want_i)[decided].all())
    assert int(decided.sum()) >= m - 1


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 16, 32])
def test_gpu_head_sample_temperature_zero_is_greedy_bit_for_bit(cuda, m):
    """Temperature 0, default penalties: the fused kernel's score is the
    skinny head kernel's logit bit for bit (same per-column K order) and
    its index that logit row's first maximum."""
    from repro_torch.kernels.sample import head_sample_fused
    g = torch.Generator(device=cuda).manual_seed(m)
    h = torch.randn(m, 2048, generator=g, device=cuda)
    w = torch.randn(2048, 4096, generator=g, device=cuda)
    z = torch.zeros(m, device=cuda)
    zi = torch.zeros(m, dtype=torch.int32, device=cuda)
    s, i = head_sample_fused(h, w, torch.zeros((m, 4096), dtype=torch.int32,
                                               device=cuda),
                             z, z + 1, z, z, zi, zi)
    logits = sta_gemm_skinny(h, w)
    assert torch.equal(s, logits.max(dim=-1).values)
    assert torch.equal(i.long(), torch.argmax(logits, dim=-1))


@pytest.mark.gpu
def test_gpu_head_sample_tie_across_tiles_takes_the_lowest_index(cuda):
    """Columns 5, 130 and 300 (three different 128-column tiles) and 7
    (the same warp as 5) hold the same weights, so their logits are equal
    bit for bit and beat every other column: the lowest index wins on
    every row, at temperature 0 and with penalties that leave them tied."""
    from repro_torch.kernels.sample import head_sample_fused
    m, k, n = 8, 256, 512
    g = torch.Generator(device=cuda).manual_seed(0)
    h = torch.rand(m, k, generator=g, device=cuda) + 0.5
    w = -torch.rand(k, n, generator=g, device=cuda)
    top = torch.rand(k, generator=g, device=cuda)
    for c in (300, 130, 7, 5):
        w[:, c] = top
    z = torch.zeros(m, device=cuda)
    zi = torch.zeros(m, dtype=torch.int32, device=cuda)
    counts = torch.zeros((m, n), dtype=torch.int32, device=cuda)
    counts[:, [5, 7, 130, 300]] = 2               # seen: penalised alike
    rep = torch.full((m,), 1.5, device=cuda)
    pres = torch.full((m,), 0.25, device=cuda)
    _, i = head_sample_fused(h, w, counts, z, rep, pres, z, zi, zi)
    assert i.tolist() == [5] * m
    fresh = torch.zeros_like(counts)
    for drop, want in ((None, 5), (5, 7), (7, 130)):
        if drop is not None:
            w[:, drop] = -1.0          # 7 ties 130 and 300; then 130 does
        _, i = head_sample_fused(h, w, fresh, z, z + 1, z, z, zi, zi)
        assert i.tolist() == [want] * m


@pytest.mark.gpu
def test_gpu_head_sample_refuses_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.sample import head_sample_fused
    h, w, counts, rows = _head_sample_case(cuda, 33, 128, 256, 0)
    with pytest.raises(ValueError, match="M in"):
        head_sample_fused(h, w, counts, *rows)
    h, w, counts, rows = _head_sample_case(cuda, 8, 128, 200, 0)
    with pytest.raises(ValueError, match="multiples of 128"):
        head_sample_fused(h, w, counts, *rows)
    h, w, counts, rows = _head_sample_case(cuda, 8, 128, 256, 0)
    with pytest.raises(ValueError, match="contiguous"):
        head_sample_fused(h, w.t().contiguous().t(), counts, *rows)


@pytest.mark.gpu
@pytest.mark.parametrize("draft_k", [0, 2])
def test_gpu_sampled_serve_kernel_route_matches_plain_route(cuda, draft_k):
    """Smoke-width f32 olmo-1b, packed: sampled (and speculative) serve on
    the kernel route gives the plain route's streams; paged equals
    contiguous; the fused head launches once per sampled decode step and
    per prefill call (and never on the speculative path)."""
    from repro_torch.configs import get_config
    from repro_torch.core.dbb_linear import iter_leaves, pack_tree
    from repro_torch.core.sparsity import apply_dbb_to_tree
    from repro_torch.models import registry
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sampling import SamplingParams
    cfg = get_config("olmo-1b", smoke=True).replace(
        remat="none", gemm_impl="pallas", kv_page_size=8)
    params = registry.init_params(cfg, seed=0, device=cuda)
    params["embed"]["table"] *= 0.1
    for leaf in iter_leaves(params["layers"]):
        leaf *= 3.0
    packed = pack_tree(apply_dbb_to_tree(params, cfg.dbb), cfg.dbb)
    r = np.random.default_rng(3)
    ps = [list(map(int, r.integers(2, 512, n))) for n in (12, 7, 3, 9, 5)]
    sp = [SamplingParams(temperature=0.6 + 0.2 * i, seed=i,
                         repetition_penalty=1.2 if i % 2 else 1.0)
          for i in range(5)]
    outs = {}
    for name, c, paged in (("kernel", cfg, False), ("paged", cfg, True),
                           ("plain", cfg.replace(gemm_impl="xla"), False)):
        eng = ServeEngine(c, packed, max_batch=4, paged=paged, device=cuda)
        before = LAUNCHES["head_sample_fused"]
        outs[name] = eng.serve(ps, max_new_tokens=10, sampling=sp,
                               draft_k=draft_k)
        launched = LAUNCHES["head_sample_fused"] - before
        if name != "plain":
            decode = 0 if draft_k else eng.last_decode_steps
            assert launched == eng.serve_stats["prefill_calls"] + decode
        else:
            assert launched == 0
    assert outs["kernel"] == outs["paged"] == outs["plain"]


def _w4_case(cuda, dtype, m, k, n, nnz, group, seed):
    """x, the w4 leaf of a random [k, n] weight, a bias, and the leaf's
    group scales with a caller's per-channel scale folded in (what
    dispatch.matmul hands the kernels)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    p = pack_dbb(torch.randn(k, n, generator=g, device=cuda), 8, nnz,
                 bits=4, group=group)
    bias = torch.randn(n, generator=g, device=cuda)
    scale = torch.rand(n, generator=g, device=cuda) + 0.5
    return x, p, bias, (p.scale * scale).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,nnz,group,act", [
    (1, 256, 96, 1, 256, "none"), (130, 272, 200, 3, 8, "silu"),
    (77, 384, 136, 3, 64, "relu"), (512, 512, 384, 8, 128, "gelu")])
def test_gpu_dbb_gemm_w4(cuda, dtype, m, k, n, nnz, group, act):
    x, p, bias, gs = _w4_case(cuda, dtype, m, k, n, nnz, group, m + k)
    before = LAUNCHES["dbb_gemm_w4"]
    got = dbb_gemm(x, p.values, p.bitmask, bias, act=act, nnz=nnz, bits=4,
                   group=group, gscale=gs)
    torch.cuda.synchronize()
    assert LAUNCHES["dbb_gemm_w4"] == before + 1
    _gpu_close(got, dbb_gemm_ref(x, p.values, p.bitmask, bias, act=act,
                                 bits=4, group=group, gscale=gs), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 8, 24, 32])
@pytest.mark.parametrize("k,n,nnz,group", [(272, 100, 3, 8),
                                           (512, 136, 8, 256)])
def test_gpu_dbb_gemm_skinny_w4(cuda, dtype, m, k, n, nnz, group):
    x, p, bias, gs = _w4_case(cuda, dtype, m, k, n, nnz, group, 7 * m + k)
    before = LAUNCHES["dbb_gemm_skinny_w4"]
    got = dbb_gemm_skinny(x, p.values, p.bitmask, bias, act="silu",
                          nnz=nnz, bits=4, group=group, gscale=gs)
    torch.cuda.synchronize()
    assert LAUNCHES["dbb_gemm_skinny_w4"] == before + 1
    _gpu_close(got, dbb_gemm_ref(x, p.values, p.bitmask, bias, act="silu",
                                 bits=4, group=group, gscale=gs), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,m", [("dbb_gemm", 130), ("dbb_gemm", 3),
                                    ("dbb_gemm_skinny", 8),
                                    ("dbb_gemm_skinny", 29)])
def test_gpu_dbb_gemm_int8_plane(cuda, dtype, name, m):
    """INT8-valued planes (pack_tree(quantize=True)): the per-channel scale
    rides the epilogue, with bias and act."""
    from repro_torch.core.quant import quantize_weight
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn(m, 264, generator=g, device=cuda).to(dtype)
    qw = quantize_weight(torch.randn(264, 200, generator=g, device=cuda))
    p = pack_dbb(qw.q, 8, 3)
    assert p.values.dtype == torch.int8
    bias = torch.randn(200, generator=g, device=cuda)
    fn = dbb_gemm if name == "dbb_gemm" else dbb_gemm_skinny
    before = LAUNCHES[name + "_i8"]
    got = fn(x, p.values, p.bitmask, bias, qw.scale, act="gelu", nnz=3)
    torch.cuda.synchronize()
    assert LAUNCHES[name + "_i8"] == before + 1
    _gpu_close(got, dbb_gemm_ref(x, p.values, p.bitmask, bias, qw.scale,
                                 act="gelu"), dtype)


@pytest.mark.gpu
def test_gpu_skinny_w4_row_is_the_same_bits_in_any_batch(cuda):
    """As for the bits=8 planes: rows 0..7 of an M24 w4 call equal an M8
    call on those rows bit for bit."""
    x, p, bias, gs = _w4_case(cuda, torch.bfloat16, 24, 512, 640, 4, 128, 24)

    def run(a):
        return dbb_gemm_skinny(a, p.values, p.bitmask, bias, act="silu",
                               bits=4, group=128, gscale=gs)
    full = run(x)
    for r0 in (0, 8, 16):
        assert torch.equal(full[r0:r0 + 8], run(x[r0:r0 + 8].contiguous()))


@pytest.mark.gpu
def test_gpu_dbb_refuses_what_the_w4_and_int8_branches_do_not_take(cuda):
    x, p, _, gs = _w4_case(cuda, torch.bfloat16, 8, 256, 128, 4, 64, 0)
    kw = dict(bits=4, group=64, gscale=gs)
    for fn in (dbb_gemm, dbb_gemm_skinny):
        with pytest.raises(TypeError):                     # int8 x
            fn(x.to(torch.int8), p.values, p.bitmask, **kw)
        with pytest.raises(ValueError):                    # plane shape
            fn(x, p.values[:-1].contiguous(), p.bitmask, **kw)
        with pytest.raises(TypeError):                     # plane dtype
            fn(x, p.values.float(), p.bitmask, **kw)
        with pytest.raises(TypeError):                     # gscale dtype
            fn(x, p.values, p.bitmask, bits=4, group=64,
               gscale=gs.bfloat16())
        with pytest.raises(ValueError):                    # gscale shape
            fn(x, p.values, p.bitmask, bits=4, group=128, gscale=gs)
        with pytest.raises(TypeError):                     # int16 plane
            fn(x, torch.zeros((128, 128), dtype=torch.int16, device=cuda),
               p.bitmask)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["w4", "int8"])
def test_gpu_quantized_generate_kernel_route_matches_plain_route(cuda, fmt):
    """Smoke-width f32 olmo-1b packed as w4 (G 64) or with INT8 values:
    greedy generate on the kernel route gives the plain route's tokens,
    every layer GEMM launches the format's kernels and no f32-plane DBB
    kernel launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.dbb_linear import iter_leaves, pack_tree
    from repro_torch.core.sparsity import apply_dbb_to_tree
    from repro_torch.kernels.common import reset_launches
    from repro_torch.models import registry
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config("olmo-1b", smoke=True).replace(remat="none",
                                                    gemm_impl="pallas")
    if fmt == "w4":
        cfg = cfg.replace(dbb=dataclasses.replace(
            cfg.dbb, weight_bits=4, quant_group=64))
    params = registry.init_params(cfg, seed=0, device=cuda)
    params["embed"]["table"] *= 0.1
    for leaf in iter_leaves(params["layers"]):
        leaf *= 3.0
    packed = pack_tree(apply_dbb_to_tree(params, cfg.dbb), cfg.dbb,
                       quantize=fmt == "int8")
    r = np.random.default_rng(5)
    ps = [list(map(int, r.integers(2, 512, n))) for n in (12, 7, 40, 9)]
    eng = ServeEngine(cfg, packed, max_batch=4, device=cuda)
    reset_launches()
    out = eng.generate(ps, max_new_tokens=8)
    counts = dict(LAUNCHES)
    sfx = "_w4" if fmt == "w4" else "_i8"
    per_pass = 7 * cfg.num_layers
    assert counts["dbb_gemm" + sfx] == per_pass            # one prefill
    assert counts["dbb_gemm_skinny" + sfx] == per_pass * eng.last_decode_steps
    assert counts["dbb_gemm"] == counts["dbb_gemm_skinny"] == 0
    plain = ServeEngine(cfg.replace(gemm_impl="xla"), packed, max_batch=4,
                        device=cuda).generate(ps, max_new_tokens=8)
    assert out == plain


# ---------------------------------------------------------------------------
# the int8 branches: INT8 x INT8 -> INT32
# ---------------------------------------------------------------------------

I8, I32, F32 = torch.int8, torch.int32, torch.float32


def _s8_close(got, want, act):
    """The int8 branches' tolerance (module doc)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if act in ("none", "relu"):
        assert torch.equal(got, want)
    elif got.dtype == F32:
        scale = want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7 * scale)
    else:
        diff = (got.long() - want.long()).abs()
        assert diff.max().item() <= 1
        assert int((diff > 0).sum()) <= max(1, want.numel() // 1000)


def _s8_operands(cuda, m, k, n, seed, lo=-127, hi=128):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randint(lo, hi, (m, k), generator=g, device=cuda, dtype=I8)
    w = torch.randint(lo, hi, (k, n), generator=g, device=cuda, dtype=I8)
    bias = torch.randn(n, generator=g, device=cuda) * 100
    scale = (torch.rand(n, generator=g, device=cuda) + 0.5) * 1e-3
    return x, w, bias, scale


# (act, out dtype, with scale, with bias): the raw sum; relu'd requant;
# dequant + bias + silu / gelu; requant after gelu; int32 after gelu
S8_EPILOGUES = [("none", None, False, False), ("relu", I8, True, False),
                ("silu", None, True, True), ("gelu", F32, True, True),
                ("gelu", I8, True, True), ("relu", F32, False, True),
                ("gelu", I32, False, True)]


def _epi(bias, scale, has_scale, has_bias):
    return (bias if has_bias else None), (scale if has_scale else None)


@pytest.mark.gpu
@pytest.mark.parametrize("act,od,has_scale,has_bias", S8_EPILOGUES)
@pytest.mark.parametrize("name,m,k,n", [
    ("sta_gemm", 130, 200, 300),            # ragged M, N, K (K % 8 != 0)
    ("sta_gemm", 1, 5, 3),
    ("sta_gemm_skinny", 13, 264, 100),      # ragged N
    ("sta_gemm_skinny", 32, 512, 640)])
def test_gpu_s8_dense_branches(cuda, name, m, k, n, act, od, has_scale,
                               has_bias):
    x, w, bias, scale = _s8_operands(cuda, m, k, n, m + k)
    b, s = _epi(bias, scale, has_scale, has_bias)
    fn = sta_gemm if name == "sta_gemm" else sta_gemm_skinny
    before = LAUNCHES[name + "_s8"]
    got = fn(x, w, b, s, act=act, out_dtype=od)
    torch.cuda.synchronize()
    assert LAUNCHES[name + "_s8"] == before + 1
    want = sta_gemm_ref(x, w, b, s, act=act, out_dtype=od)
    assert got.dtype == (od or (F32 if has_scale else I32))
    _s8_close(got, want, act)


@pytest.mark.gpu
@pytest.mark.parametrize("act,od,has_scale,has_bias", S8_EPILOGUES)
@pytest.mark.parametrize("name,m", [("dbb_gemm", 130), ("dbb_gemm", 3),
                                    ("dbb_gemm_skinny", 8),
                                    ("dbb_gemm_skinny", 29)])
@pytest.mark.parametrize("nnz", [1, 3, 8])
def test_gpu_s8_dbb_branches(cuda, name, m, nnz, act, od, has_scale,
                             has_bias):
    from repro_torch.core.quant import quantize_weight
    x, _, bias, scale = _s8_operands(cuda, m, 264, 200, m + nnz)
    g = torch.Generator(device=cuda).manual_seed(nnz)
    qw = quantize_weight(torch.randn(264, 200, generator=g, device=cuda))
    p = pack_dbb(qw.q, 8, nnz)
    b, s = _epi(bias, qw.scale * scale, has_scale, has_bias)
    fn = dbb_gemm if name == "dbb_gemm" else dbb_gemm_skinny
    before = LAUNCHES[name + "_s8"]
    got = fn(x, p.values, p.bitmask, b, s, act=act, nnz=nnz, out_dtype=od)
    torch.cuda.synchronize()
    assert LAUNCHES[name + "_s8"] == before + 1
    _s8_close(got, dbb_gemm_ref(x, p.values, p.bitmask, b, s, act=act,
                                out_dtype=od), act)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sta_gemm", "sta_gemm_skinny", "dbb_gemm",
                                  "dbb_gemm_skinny", "conv_gemm",
                                  "conv_gemm_dbb"])
def test_gpu_s8_requant_rounds_half_to_even(cuda, name):
    """scale 0.5 on odd sums puts every output on a .5: the int8 store
    rounds half to even (rintf), as torch.round and jnp.round do."""
    g = torch.Generator(device=cuda).manual_seed(5)
    half = torch.full((64,), 0.5, device=cuda)
    if name.startswith("conv"):
        x = torch.randint(-3, 4, (2, 6, 6, 8), generator=g, device=cuda,
                          dtype=I8)
        w = torch.randint(-3, 4, (72, 64), generator=g, device=cuda,
                          dtype=I8)
        kw = dict(kh=3, kw=3, act="none", out_dtype=I8)
        if name == "conv_gemm":
            got = conv_gemm(x, w, None, half, **kw)
            acc = conv_gemm_ref(x, w, **dict(kw, out_dtype=I32))
        else:
            p = pack_dbb(w, 8, 8)
            got = conv_gemm_dbb(x, p.values, p.bitmask, None, half, nnz=8,
                                **kw)
            acc = conv_gemm_dbb_ref(x, p.values, p.bitmask,
                                    **dict(kw, out_dtype=I32))
    else:
        x = torch.randint(-3, 4, (8, 64), generator=g, device=cuda, dtype=I8)
        w = torch.randint(-3, 4, (64, 64), generator=g, device=cuda,
                          dtype=I8)
        if name.startswith("dbb"):
            p = pack_dbb(w, 8, 8)
            fn = dbb_gemm if name == "dbb_gemm" else dbb_gemm_skinny
            got = fn(x, p.values, p.bitmask, None, half, nnz=8, act="none",
                     out_dtype=I8)
        else:
            fn = sta_gemm if name == "sta_gemm" else sta_gemm_skinny
            got = fn(x, w, None, half, act="none", out_dtype=I8)
        acc = sta_gemm_ref(x, w)
    torch.cuda.synchronize()
    a = acc.cpu().numpy().astype(np.float64)
    want = np.clip(np.round(a * 0.5), -127, 127)   # numpy: half to even
    assert (np.abs(a) % 2 == 1).sum() > 50          # many .5 cases
    np.testing.assert_array_equal(got.cpu().numpy(), want.astype(np.int8))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sta_gemm", "sta_gemm_skinny", "dbb_gemm",
                                  "dbb_gemm_skinny", "conv_gemm",
                                  "conv_gemm_dbb"])
def test_gpu_s8_all_127_is_the_exact_integer(cuda, name):
    """All-127 operands: every sum K·127² is past 2^24 (f32's exact
    range), and the int32 output is that integer."""
    if name.startswith("conv"):
        c = 131 if name == "conv_gemm" else 136    # K = 1179 / 1224
        x = torch.full((1, 5, 5, c), 127, dtype=I8, device=cuda)
        w = torch.full((9 * c, 24), 127, dtype=I8, device=cuda)
        kw = dict(kh=3, kw=3, padding="VALID")
        if name == "conv_gemm":
            got = conv_gemm(x, w, **kw)
        else:
            p = pack_dbb(w, 8, 8)
            got = conv_gemm_dbb(x, p.values, p.bitmask, nnz=8, **kw)
        k = 9 * c
    else:
        k = 1179 if name == "sta_gemm" else 1184
        x = torch.full((8, k), 127, dtype=I8, device=cuda)
        w = torch.full((k, 40), 127, dtype=I8, device=cuda)
        if name.startswith("dbb"):
            p = pack_dbb(w, 8, 8)
            fn = dbb_gemm if name == "dbb_gemm" else dbb_gemm_skinny
            got = fn(x, p.values, p.bitmask, nnz=8)
        else:
            fn = sta_gemm if name == "sta_gemm" else sta_gemm_skinny
            got = fn(x, w)
    torch.cuda.synchronize()
    assert got.dtype == I32 and k * 127 * 127 > 2 ** 24
    assert bool((got == k * 127 * 127).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["sta_gemm_skinny", "dbb_gemm_skinny"])
def test_gpu_s8_skinny_row_is_the_same_bits_in_any_batch(cuda, kernel):
    """rows 0..7 of an M24 int8 call equal an M8 call on those rows, on the
    f32 output of a fused dequant + bias + gelu."""
    x, w, bias, scale = _s8_operands(cuda, 24, 512, 640, 24)
    if kernel == "sta_gemm_skinny":
        def run(a):
            return sta_gemm_skinny(a, w, bias, scale, act="gelu")
    else:
        p = pack_dbb(w, 8, 4)

        def run(a):
            return dbb_gemm_skinny(a, p.values, p.bitmask, bias, scale,
                                   act="gelu")
    full = run(x)
    for r0 in (0, 8, 16):
        assert torch.equal(full[r0:r0 + 8], run(x[r0:r0 + 8].contiguous()))


@pytest.mark.gpu
@pytest.mark.parametrize("act,od,has_scale,has_bias", S8_EPILOGUES)
@pytest.mark.parametrize("b,h,w,c,k,n,stride,padding", [
    (2, 9, 7, 1, 5, 6, 1, "SAME"),          # K = 25: ragged gather
    (2, 8, 8, 3, 3, 64, 1, "SAME"),         # convnet conv0's channels
    (2, 10, 10, 16, 3, 10, 2, "SAME"),      # stride 2, odd pad split
    (3, 12, 11, 3, 5, 200, 2, "VALID"),
    (1, 33, 33, 8, 3, 130, 1, "SAME")])     # 8-byte gathers, ragged N
def test_gpu_s8_conv_gemm(cuda, b, h, w, c, k, n, stride, padding, act, od,
                          has_scale, has_bias):
    x, _, bias, scale = _s8_operands(cuda, 1, 1, n, h * w + c)
    g = torch.Generator(device=cuda).manual_seed(c + n)
    x = torch.randint(-127, 128, (b, h, w, c), generator=g, device=cuda,
                      dtype=I8)
    wt = torch.randint(-127, 128, (k * k * c, n), generator=g, device=cuda,
                       dtype=I8)
    bi, sc = _epi(bias, scale, has_scale, has_bias)
    kw = dict(kh=k, kw=k, stride=stride, padding=padding, act=act,
              out_dtype=od)
    before = LAUNCHES["conv_gemm_s8"]
    got = conv_gemm(x, wt, bi, sc, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["conv_gemm_s8"] == before + 1
    _s8_close(got, conv_gemm_ref(x, wt, bi, sc, **kw), act)


@pytest.mark.gpu
@pytest.mark.parametrize("act,od,has_scale,has_bias", S8_EPILOGUES)
@pytest.mark.parametrize("b,h,w,c,k,n,stride,padding,nnz", [
    (2, 8, 8, 16, 3, 32, 1, "SAME", 2),
    (2, 9, 9, 8, 3, 10, 2, "SAME", 4),
    (2, 16, 16, 64, 3, 128, 1, "SAME", 2),  # convnet conv1's geometry
    (1, 10, 8, 16, 5, 6, 1, "VALID", 3),
    (1, 7, 7, 8, 3, 20, 1, "SAME", 1),
    (1, 7, 7, 8, 3, 20, 1, "SAME", 8)])
def test_gpu_s8_conv_gemm_dbb(cuda, b, h, w, c, k, n, stride, padding, nnz,
                              act, od, has_scale, has_bias):
    from repro_torch.core.quant import quantize_weight
    _, _, bias, scale = _s8_operands(cuda, 1, 1, n, h * w + c + nnz)
    g = torch.Generator(device=cuda).manual_seed(c + n + nnz)
    x = torch.randint(-127, 128, (b, h, w, c), generator=g, device=cuda,
                      dtype=I8)
    qw = quantize_weight(torch.randn(k * k * c, n, generator=g, device=cuda))
    p = pack_dbb(qw.q, 8, nnz)
    bi, sc = _epi(bias, qw.scale * scale, has_scale, has_bias)
    kw = dict(kh=k, kw=k, stride=stride, padding=padding, act=act,
              out_dtype=od)
    before = LAUNCHES["conv_gemm_dbb_s8"]
    got = conv_gemm_dbb(x, p.values, p.bitmask, bi, sc, nnz=nnz, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["conv_gemm_dbb_s8"] == before + 1
    _s8_close(got, conv_gemm_dbb_ref(x, p.values, p.bitmask, bi, sc, **kw),
              act)


@pytest.mark.gpu
@pytest.mark.parametrize("name,m", [("dbb_gemm", 130),
                                    ("dbb_gemm_skinny", 24)])
def test_gpu_float_i8_branch_equals_the_f32_plane_bit_for_bit(cuda, name, m):
    """The float ``_i8`` branch shares its body with the f32 plane: int8
    values and the same values stored as f32 give the same bits (the int8
    branches' template parameters leave the float instantiations as they
    were)."""
    from repro_torch.core.quant import quantize_weight
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn(m, 264, generator=g, device=cuda).bfloat16()
    qw = quantize_weight(torch.randn(264, 200, generator=g, device=cuda))
    p = pack_dbb(qw.q, 8, 3)
    bias = torch.randn(200, generator=g, device=cuda)
    fn = dbb_gemm if name == "dbb_gemm" else dbb_gemm_skinny
    got = fn(x, p.values, p.bitmask, bias, qw.scale, act="gelu", nnz=3)
    f32 = fn(x, p.values.float(), p.bitmask, bias, qw.scale, act="gelu",
             nnz=3)
    assert torch.equal(got, f32)


@pytest.mark.gpu
def test_gpu_int8_dispatch_takes_the_s8_branches(cuda):
    """int8 x through the front doors launches each int8 branch once and
    equals the plain route bit for bit (int32 outputs)."""
    from repro_torch.core.quant import quantize_weight
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.common import reset_launches
    x, w, _, _ = _s8_operands(cuda, 40, 256, 512, 3)
    g = torch.Generator(device=cuda).manual_seed(4)
    qw = quantize_weight(torch.randn(256, 512, generator=g, device=cuda))
    p = pack_dbb(qw.q, 8, 4, scale=qw.scale)
    img = torch.randint(-127, 128, (2, 8, 8, 72), generator=g, device=cuda,
                        dtype=I8)
    qc = quantize_weight(torch.randn(648, 64, generator=g, device=cuda))
    wc, pc = qc.q, pack_dbb(qc.q, 8, 2, scale=qc.scale)
    reset_launches()
    runs = {
        "sta_gemm_s8": lambda k: dispatch.matmul(x, w, pallas=k),
        "sta_gemm_skinny_s8": lambda k: dispatch.matmul(x[:8], w, pallas=k),
        "dbb_gemm_s8": lambda k: dispatch.matmul(x, p, pallas=k),
        "dbb_gemm_skinny_s8": lambda k: dispatch.matmul(x[:8], p, pallas=k),
        "conv_gemm_s8": lambda k: dispatch.conv(img, wc, kh=3, kw=3,
                                                use_kernel=k),
        "conv_gemm_dbb_s8": lambda k: dispatch.conv(img, pc, kh=3, kw=3,
                                                    use_kernel=k)}
    for name, run in runs.items():
        before = dict(LAUNCHES)
        got = run(True)
        torch.cuda.synchronize()
        moved = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                 if LAUNCHES[k] != before[k]}
        # K 256 and N 512 take the int8 tensor-core body of the M-tiled two
        want = {name: 1}
        if name in ("sta_gemm_s8", "dbb_gemm_s8"):
            want[name + "_tc"] = 1
        assert moved == want, (name, moved)
        want = run(False)
        assert got.dtype == want.dtype
        assert torch.equal(got, want), name



# ---------------------------------------------------------------------------
# The tensor-core body (csrc/tc_gemm.cuh) of sta_gemm and dbb_gemm: bf16
# operands, 128 x 64 tiles, K in stages of 64
# ---------------------------------------------------------------------------

BF = torch.bfloat16


def _dbb_plane(cuda, w, plane, nnz=4):
    """(positional DBB operands after x, keyword operands) of ``w [K, N]``
    in one values format: f32, INT8 values (scale in the epilogue) or w4
    (G 64)."""
    from repro_torch.core.quant import quantize_weight
    if plane == "_w4":
        p = pack_dbb(w, 8, nnz, bits=4, group=64)
        return (p.values, p.bitmask), dict(nnz=nnz, bits=4, group=64,
                                           gscale=p.scale)
    if plane == "_i8":
        qw = quantize_weight(w)
        p = pack_dbb(qw.q, 8, nnz)
        return (p.values, p.bitmask, None, qw.scale), dict(nnz=nnz)
    p = pack_dbb(w, 8, nnz)
    return (p.values, p.bitmask), dict(nnz=nnz)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 63, 65, 130, 600])
@pytest.mark.parametrize("k,n,act,out_f32", [
    (200, 200, "silu", False),      # K % 64 != 0, N % 64 != 0
    (72, 136, "gelu", True),        # f32 output of bf16 operands
    (2048, 8, "none", False)])      # one 8-wide column strip
def test_gpu_sta_gemm_tensor_core_body(cuda, m, k, n, act, out_f32):
    from repro_torch.kernels.sta_gemm.ops import tc_body
    assert tc_body(BF, k, n)
    g = torch.Generator(device=cuda).manual_seed(m * k + n)
    x = torch.randn(m, k, generator=g, device=cuda).to(BF)
    w = torch.randn(k, n, generator=g, device=cuda).to(BF)
    bias = torch.randn(n, generator=g, device=cuda)
    scale = torch.rand(n, generator=g, device=cuda) + 0.5
    od = torch.float32 if out_f32 else None
    before = dict(LAUNCHES)
    got = sta_gemm(x, w, bias, scale, act=act, out_dtype=od)
    torch.cuda.synchronize()
    assert LAUNCHES["sta_gemm"] == before["sta_gemm"] + 1
    assert LAUNCHES["sta_gemm_tc"] == before["sta_gemm_tc"] + 1
    assert got.dtype == (od or BF)
    _gpu_close(got, sta_gemm_ref(x, w, bias, scale, act=act, out_dtype=od),
               BF)


@pytest.mark.gpu
@pytest.mark.parametrize("plane", ["", "_i8", "_w4"])
@pytest.mark.parametrize("m", [1, 63, 65, 130, 600])
@pytest.mark.parametrize("n", [200, 4104])
def test_gpu_dbb_gemm_tensor_core_body(cuda, plane, m, n):
    """All three values planes at K 320 (five stages, the last one half
    past K), N 200 (128-row tiles) and N 4104 (256-row tiles, N >= 4096),
    both with a ragged last column tile."""
    k = 320
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn(m, k, generator=g, device=cuda).to(BF)
    args, kw = _dbb_plane(cuda, torch.randn(k, n, generator=g, device=cuda),
                          plane)
    bias = torch.randn(n, generator=g, device=cuda)
    before = dict(LAUNCHES)
    got = dbb_gemm(x, *args[:2], bias, *args[3:], act="silu", **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["dbb_gemm" + plane] == before["dbb_gemm" + plane] + 1
    assert LAUNCHES["dbb_gemm_tc"] == before["dbb_gemm_tc"] + 1
    want = dbb_gemm_ref(x, *args[:2], bias, *args[3:], act="silu",
                        **{k_: v for k_, v in kw.items() if k_ != "nnz"})
    _gpu_close(got, want, BF)


@pytest.mark.gpu
@pytest.mark.parametrize("plane", ["", "_i8", "_w4"])
@pytest.mark.parametrize("nnz", [5, 8])
def test_gpu_dbb_gemm_tensor_core_body_dense_blocks(cuda, plane, nnz):
    """nnz > 4 expands each block by a running rank instead of the
    byte-permute table the serving path's k = 4 takes."""
    m, k, n = 130, 320, 200
    g = torch.Generator(device=cuda).manual_seed(nnz)
    x = torch.randn(m, k, generator=g, device=cuda).to(BF)
    args, kw = _dbb_plane(cuda, torch.randn(k, n, generator=g, device=cuda),
                          plane, nnz=nnz)
    before = LAUNCHES["dbb_gemm_tc"]
    got = dbb_gemm(x, *args, act="gelu", **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["dbb_gemm_tc"] == before + 1
    want = dbb_gemm_ref(x, *args, act="gelu",
                        **{k_: v for k_, v in kw.items() if k_ != "nnz"})
    _gpu_close(got, want, BF)


def _one_hot_probe(cuda, m, k, n):
    """x with distinct small integers (exact in bf16) and a one-hot weight
    that sends row sigma(c) of K to column c: the product is x[:, sigma]
    exactly, so a swizzle, descriptor or fragment mistake shows as a wrong
    column or row, not as noise."""
    mm = torch.arange(m, device=cuda)[:, None]
    kk = torch.arange(k, device=cuda)[None, :]
    x = ((mm * 7 + kk * 3) % 61 - 30).to(BF)
    sigma = (torch.arange(n, device=cuda) * 37 + 11) % k
    w = torch.zeros(k, n, device=cuda)
    w[sigma, torch.arange(n, device=cuda)] = 1.0
    return x, w, x[:, sigma]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["sta_gemm", "dbb_gemm"])
@pytest.mark.parametrize("m,k,n", [(130, 256, 192), (600, 320, 72),
                                   (300, 128, 4160)])
def test_gpu_tensor_core_body_one_hot_probe(cuda, kernel, m, k, n):
    x, w, want = _one_hot_probe(cuda, m, k, n)
    before = LAUNCHES[kernel + "_tc"]
    if kernel == "sta_gemm":
        got = sta_gemm(x, w.to(BF))
    else:
        p = pack_dbb(w, 8, 1)
        got = dbb_gemm(x, p.values, p.bitmask, nnz=1)
    torch.cuda.synchronize()
    assert LAUNCHES[kernel + "_tc"] == before + 1
    bad = (got != want).nonzero()
    assert bad.numel() == 0, f"{len(bad)} wrong outputs, first {bad[:8]}"


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["sta_gemm", "dbb_gemm", "dbb_gemm_w4"])
@pytest.mark.parametrize("n", [320, 4160])
def test_gpu_tensor_core_row_is_the_same_bits_at_any_m(cuda, kernel, n):
    """Serve's packed, chunked and padded prefills run one row at different
    M and in different places of a tile: row 77 of an M512 call equals the
    same row alone (M1) and as the last row of an M130 call (the ragged
    second tile of 128-row tiles), bit for bit; N 4160 puts DBB on its
    256-row tiles."""
    k = 512
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(512, k, generator=g, device=cuda).to(BF)
    w = torch.randn(k, n, generator=g, device=cuda)
    bias = torch.randn(n, generator=g, device=cuda)
    if kernel == "sta_gemm":
        wb = w.to(BF)

        def run(a):
            return sta_gemm(a, wb, bias, act="gelu")
    else:
        args, kw = _dbb_plane(cuda, w, "_w4" if kernel == "dbb_gemm_w4"
                              else "")

        def run(a):
            return dbb_gemm(a, *args, bias, act="gelu", **kw)
    row = x[77:78]
    full = run(x)[77]
    alone = run(row.contiguous())[0]
    x130 = torch.cat([x[200:329], row]).contiguous()
    last = run(x130)[129]
    assert torch.equal(full, alone)
    assert torch.equal(full, last)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(130, 100, 200),    # K % 8 != 0
                                   (65, 5, 64),         # K % 8 != 0
                                   (70, 256, 300)])     # N % 8 != 0
def test_gpu_sta_gemm_ragged_rows_take_the_fma_body(cuda, m, k, n):
    """Where TMA's 16-byte row stride fails, bf16 runs the plain-FMA body
    (no ``_tc`` launch) and stays right."""
    from repro_torch.kernels.sta_gemm.ops import tc_body
    assert not tc_body(BF, k, n)
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g, device=cuda).to(BF)
    w = torch.randn(k, n, generator=g, device=cuda).to(BF)
    before = dict(LAUNCHES)
    got = sta_gemm(x, w, act="silu")
    torch.cuda.synchronize()
    assert LAUNCHES["sta_gemm"] == before["sta_gemm"] + 1
    assert LAUNCHES["sta_gemm_tc"] == before["sta_gemm_tc"]
    _gpu_close(got, sta_gemm_ref(x, w, act="silu"), BF)


@pytest.mark.gpu
def test_gpu_tc_counts_follow_the_kernels_own_rule(cuda):
    """The wrappers' tc_body mirrors the launchers' rule: the libraries'
    exported sta_gemm_tc_body / dbb_gemm_tc_body agree on every dtype and
    a grid of K and N; f32 and int8 never take the tensor-core body, and
    f32 launches leave the ``_tc`` counts alone."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.dbb_gemm.ops import tc_body as dbb_tc
    from repro_torch.kernels.sta_gemm.ops import tc_body as sta_tc
    sta_q = build.load("sta_gemm").sta_gemm_tc_body
    sta_q.argtypes = [ctypes.c_int] * 3
    dbb_q = build.load("dbb_gemm").dbb_gemm_tc_body
    dbb_q.argtypes = [ctypes.c_int]
    for dt in (torch.float32, BF, torch.int8):
        code = build.dtype_code(dt)
        assert bool(dbb_q(code)) == dbb_tc(dt) == (dt == BF)
        for k in (0, 5, 8, 100, 200, 2048, 8192):
            for n in (1, 3, 8, 64, 200, 300, 8192, 50304):
                assert bool(sta_q(code, k, n)) == sta_tc(dt, k, n), (dt, k, n)
    x = torch.randn(130, 256, device=cuda)
    p = pack_dbb(torch.randn(256, 192, device=cuda), 8, 4)
    before = dict(LAUNCHES)
    sta_gemm(x, torch.randn(256, 192, device=cuda))
    dbb_gemm(x, p.values, p.bitmask)
    torch.cuda.synchronize()
    moved = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
             if LAUNCHES[k] != before[k]}
    assert moved == {"sta_gemm": 1, "dbb_gemm": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("plane", ["", "_i8", "_w4"])
@pytest.mark.parametrize("n", [136, 4104])
def test_gpu_dbb_tensor_core_body_equals_sta_gemm_on_the_dense_weight(
        cuda, plane, n):
    """The DBB producers' bf16 tiles are the dense weight the reference
    multiplies: dbb_gemm's tensor-core body equals sta_gemm's on that
    weight (rounded to bf16, the INT8 plane's scale in the epilogue) bit
    for bit, as both sum K in one order (at N 4104 on 256-row tiles)."""
    from repro_torch.core.dbb import decompress_bitmask
    from repro_torch.kernels.dbb_gemm.ref import decompress_w4_ref
    k, m = 384, 200
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(m, k, generator=g, device=cuda).to(BF)
    args, kw = _dbb_plane(cuda, torch.randn(k, n, generator=g, device=cuda),
                          plane, nnz=3 if plane != "_w4" else 4)
    if plane == "_w4":
        dense = decompress_w4_ref(args[0], args[1], kw["gscale"], group=64)
    else:
        dense = decompress_bitmask(args[0].float(), args[1], block=8)
    got = dbb_gemm(x, *args, **kw)
    want = sta_gemm(x, dense.to(BF), scale=args[3] if plane == "_i8"
                    else None)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The split-K bodies (csrc/split_k.cuh): dbb_gemm's narrow body (f32 x, N <=
# 16) and dbb_gemm_skinny's float body (all M <= 32 rows in one block, K
# split across a thread-block cluster, the planes through a cp.async ring)
# ---------------------------------------------------------------------------

def _split_plane(cuda, w, plane, nnz, group):
    """(positional DBB operands after x, keyword operands) of ``w [K, N]``
    in one values format: f32, INT8 values (scale in the epilogue) or w4
    (groups of ``group``)."""
    from repro_torch.core.quant import quantize_weight
    if plane == "_w4":
        p = pack_dbb(w, 8, nnz, bits=4, group=group)
        return (p.values, p.bitmask, None, None), dict(
            nnz=nnz, bits=4, group=group, gscale=p.scale)
    if plane == "_i8":
        qw = quantize_weight(w)
        p = pack_dbb(qw.q, 8, nnz)
        return (p.values, p.bitmask, None, qw.scale), dict(nnz=nnz)
    p = pack_dbb(w, 8, nnz)
    return (p.values, p.bitmask, None, None), dict(nnz=nnz)


def _split_case(cuda, dtype, plane, m, k, n, nnz, group, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    args, kw = _split_plane(cuda, torch.randn(k, n, generator=g,
                                              device=cuda), plane, nnz, group)
    args = (args[0], args[1], torch.randn(n, generator=g, device=cuda),
            args[3])
    return x, args, kw


def _ref(x, args, kw, act):
    return dbb_gemm_ref(x, *args, act=act,
                        **{k_: v for k_, v in kw.items() if k_ != "nnz"})


# (K, N, nnz, w4 group): K 784 / 1048 / 264 split raggedly (a short last
# slice; at 1048 slices past K are empty), N 10 and 3 leave most of the
# 16- or 64-column tile masked; in the skinny body N 10 takes the 4-byte
# and byte cp.async copies of the planes, N 136 TMA boxes for the f32
# plane and 4-byte copies for the int8 and w4 ones, N 192 TMA boxes for
# all; K 4096 N 10 k 2 is convnet's classifier
NARROW_SHAPES = [(4096, 10, 2, 128), (784, 16, 3, 8), (1048, 3, 4, 8),
                 (64, 10, 1, 8), (4608, 7, 4, 128)]
SPLIT_SHAPES = [(264, 10, 3, 8), (1048, 136, 3, 8), (4096, 10, 2, 128),
                (2048, 192, 4, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("plane", ["", "_i8", "_w4"])
@pytest.mark.parametrize("m", [1, 5, 256, 300])
@pytest.mark.parametrize("k,n,nnz,group", NARROW_SHAPES)
def test_gpu_dbb_gemm_narrow_body(cuda, plane, m, k, n, nnz, group):
    """f32 x at N <= 16 on the narrow split-K body, every values plane,
    ragged row tiles and K slices: the plain version's f32 tolerance, one
    ``dbb_gemm_narrow`` launch."""
    from repro_torch.kernels.dbb_gemm.ops import narrow_body
    assert narrow_body(torch.float32, n)
    if plane == "_w4" and (k // 8 * nnz) % 2:
        nnz += 1
    x, args, kw = _split_case(cuda, torch.float32, plane, m, k, n, nnz,
                              group, m + k + n)
    before = dict(LAUNCHES)
    got = dbb_gemm(x, *args, act="relu", **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["dbb_gemm" + plane] == before["dbb_gemm" + plane] + 1
    assert LAUNCHES["dbb_gemm_narrow"] == before["dbb_gemm_narrow"] + 1
    assert LAUNCHES["dbb_gemm_tc"] == before["dbb_gemm_tc"]
    _gpu_close(got, _ref(x, args, kw, "relu"), torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("plane", ["", "_i8", "_w4"])
def test_gpu_dbb_gemm_narrow_bits(cuda, plane):
    """Two calls give equal bits (no atomics), and a row's bits do not
    depend on M or its place in the 4-row tile (convnet's classifier
    shape, K in 8 slices)."""
    x, args, kw = _split_case(cuda, torch.float32, plane, 256, 4096, 10, 2,
                              128, 7)
    full = dbb_gemm(x, *args, **kw)
    assert torch.equal(full, dbb_gemm(x, *args, **kw))
    for r0, m in ((0, 1), (3, 2), (5, 7), (100, 33), (255, 1)):
        sub = dbb_gemm(x[r0:r0 + m].contiguous(), *args, **kw)
        assert torch.equal(full[r0:r0 + m], sub), (r0, m)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("plane", ["", "_i8", "_w4"])
@pytest.mark.parametrize("m", [1, 7, 8, 9, 24, 32])
@pytest.mark.parametrize("k,n,nnz,group", SPLIT_SHAPES)
def test_gpu_dbb_gemm_skinny_split_body(cuda, dtype, plane, m, k, n, nnz,
                                        group):
    """Float x on the split-K body, every values plane, every skinny M
    bucket, ragged K slices and column tiles: the GEMM tolerances, one
    ``dbb_gemm_skinny_split`` launch."""
    if plane == "_w4" and (k // 8 * nnz) % 2:
        nnz += 1
    x, args, kw = _split_case(cuda, dtype, plane, m, k, n, nnz, group,
                              m * 7 + k + n)
    before = dict(LAUNCHES)
    got = dbb_gemm_skinny(x, *args, act="silu", **kw)
    torch.cuda.synchronize()
    name = "dbb_gemm_skinny" + plane
    assert LAUNCHES[name] == before[name] + 1
    assert (LAUNCHES["dbb_gemm_skinny_split"]
            == before["dbb_gemm_skinny_split"] + 1)
    assert torch.isfinite(got).all()
    _gpu_close(got, _ref(x, args, kw, "silu"), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("plane", ["", "_i8", "_w4"])
@pytest.mark.parametrize("k,n,nnz,group", [(1048, 136, 3, 8),
                                           (2048, 192, 4, 128)])
def test_gpu_skinny_split_row_is_the_same_bits_in_any_batch(
        cuda, dtype, plane, k, n, nnz, group):
    """A row's bits do not depend on M <= 32 or its place in the batch
    (the K order is (K, N, nnz)'s alone), and two calls give equal
    bits."""
    if plane == "_w4" and (k // 8 * nnz) % 2:
        nnz += 1
    x, args, kw = _split_case(cuda, dtype, plane, 32, k, n, nnz, group, 3)
    full = dbb_gemm_skinny(x, *args, act="gelu", **kw)
    assert torch.equal(full, dbb_gemm_skinny(x, *args, act="gelu", **kw))
    for r0, m in ((0, 1), (0, 8), (5, 2), (9, 15), (31, 1), (8, 24)):
        sub = dbb_gemm_skinny(x[r0:r0 + m].contiguous(), *args, act="gelu",
                              **kw)
        assert torch.equal(full[r0:r0 + m], sub), (r0, m)


@pytest.mark.gpu
@pytest.mark.parametrize("plane", ["", "_i8", "_w4"])
@pytest.mark.parametrize("nnz", [5, 8])
def test_gpu_skinny_split_body_dense_blocks(cuda, plane, nnz):
    """nnz 5 and 8 (the values ring's largest stages; at 5 the w4 slots of
    a block straddle bytes) at M 32, f32 and bf16 x."""
    for dtype in (torch.float32, torch.bfloat16):
        x, args, kw = _split_case(cuda, dtype, plane, 32, 1024, 200, nnz,
                                  64, nnz)
        got = dbb_gemm_skinny(x, *args, **kw)
        _gpu_close(got, _ref(x, args, kw, "none"), dtype)


@pytest.mark.gpu
def test_gpu_split_counts_follow_the_kernels_own_rules(cuda):
    """The wrappers' narrow_body and split_body mirror the launchers'
    rules (the libraries' exported dbb_gemm_narrow_body /
    dbb_gemm_skinny_split_body) on every dtype and a grid of N; an f32
    dbb_gemm at N 17 and a bf16 one at N 10 leave the narrow count alone,
    an int8 dbb_gemm_skinny the split count."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.dbb_gemm.ops import narrow_body
    from repro_torch.kernels.skinny.ops import split_body
    nq = build.load("dbb_gemm").dbb_gemm_narrow_body
    nq.argtypes = [ctypes.c_int] * 2
    sq = build.load("dbb_gemm_skinny").dbb_gemm_skinny_split_body
    sq.argtypes = [ctypes.c_int]
    for dt in (torch.float32, BF, torch.int8):
        code = build.dtype_code(dt)
        assert bool(sq(code)) == split_body(dt) == (dt != torch.int8)
        for n in (1, 3, 10, 15, 16, 17, 64, 2048):
            assert bool(nq(code, n)) == narrow_body(dt, n), (dt, n)
    g = torch.Generator(device=cuda).manual_seed(1)
    for dt, n, want in ((torch.float32, 10, {"dbb_gemm": 1,
                                             "dbb_gemm_narrow": 1}),
                        (torch.float32, 17, {"dbb_gemm": 1}),
                        (BF, 10, {"dbb_gemm": 1, "dbb_gemm_tc": 1})):
        x = torch.randn(40, 256, generator=g, device=cuda).to(dt)
        p = pack_dbb(torch.randn(256, n, generator=g, device=cuda), 8, 4)
        before = dict(LAUNCHES)
        dbb_gemm(x, p.values, p.bitmask)
        torch.cuda.synchronize()
        moved = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                 if LAUNCHES[k] != before[k]}
        assert moved == want, (dt, n, moved)
    x = torch.randint(-127, 128, (8, 256), generator=g, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (256, 64), generator=g, device=cuda,
                      dtype=torch.int8)
    p = pack_dbb(w, 8, 4)
    before = dict(LAUNCHES)
    dbb_gemm_skinny(x, p.values, p.bitmask)
    torch.cuda.synchronize()
    moved = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
             if LAUNCHES[k] != before[k]}
    assert moved == {"dbb_gemm_skinny_s8": 1}


# ---------------------------------------------------------------------------
# The int8 tensor-core body (csrc/tc_gemm_s8.cuh) of sta_gemm's and
# dbb_gemm's int8 branches: s8 wgmma, K in stages of 128, 64-wide column
# tiles of 128 rows (256 where N >= 4096)
# ---------------------------------------------------------------------------

def _s8_tc_run(cuda, kernel, x, w, nnz, *args, **kw):
    """One int8 call on the s8 body (dense w, or w packed at ``nnz``):
    (output, plain version's output); checks one ``_s8`` and one
    ``_s8_tc`` launch."""
    before = dict(LAUNCHES)
    if kernel == "sta_gemm":
        got = sta_gemm(x, w, *args, **kw)
        want = sta_gemm_ref(x, w, *args, **kw)
    else:
        p = pack_dbb(w, 8, nnz)
        got = dbb_gemm(x, p.values, p.bitmask, *args, nnz=nnz, **kw)
        want = dbb_gemm_ref(x, p.values, p.bitmask, *args, **kw)
    torch.cuda.synchronize()
    for name in (kernel + "_s8", kernel + "_s8_tc"):
        assert LAUNCHES[name] == before[name] + 1, name
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("act,od,has_scale,has_bias", S8_EPILOGUES)
@pytest.mark.parametrize("m", [1, 65, 300])
@pytest.mark.parametrize("k,n", [(16, 16), (144, 80), (272, 208),
                                 (1184, 4112)])
def test_gpu_s8_tensor_core_body_dense(cuda, m, k, n, act, od, has_scale,
                                       has_bias):
    """K 144 / 272 / 1184 leave the last 128-deep stage short, N 80 / 208
    / 4112 the last column tile; N 4112 takes the 256-row tiles."""
    from repro_torch.kernels.sta_gemm.ops import s8_tc_body
    assert s8_tc_body(k, n)
    x, w, bias, scale = _s8_operands(cuda, m, k, n, m + k + n)
    b, s = _epi(bias, scale, has_scale, has_bias)
    got, want = _s8_tc_run(cuda, "sta_gemm", x, w, 0, b, s, act=act,
                           out_dtype=od)
    assert got.dtype == (od or (F32 if has_scale else I32))
    _s8_close(got, want, act)


@pytest.mark.gpu
@pytest.mark.parametrize("act,od,has_scale,has_bias", S8_EPILOGUES)
@pytest.mark.parametrize("m", [1, 65, 300])
@pytest.mark.parametrize("k,n,nnz", [(16, 16, 1), (144, 80, 3), (272, 208, 4),
                                     (272, 208, 8), (320, 4112, 5),
                                     (1184, 48, 2)])
def test_gpu_s8_tensor_core_body_dbb(cuda, m, k, n, nnz, act, od, has_scale,
                                     has_bias):
    """Every slot layout (nnz 1-4 in one word, 5 and 8 in two; at 8 no
    zero slot), K off the stage, N off the tile, N 4112 on 256-row tiles,
    N 48 in one masked tile."""
    from repro_torch.kernels.dbb_gemm.ops import s8_tc_body
    assert s8_tc_body(k, n)
    x, w, bias, scale = _s8_operands(cuda, m, k, n, m + k + n + nnz)
    b, s = _epi(bias, scale, has_scale, has_bias)
    got, want = _s8_tc_run(cuda, "dbb_gemm", x, w, nnz, b, s, act=act,
                           out_dtype=od)
    _s8_close(got, want, act)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["sta_gemm", "dbb_gemm"])
@pytest.mark.parametrize("m,k,n", [(130, 264, 200), (300, 1176, 4100),
                                   (65, 8, 24)])
def test_gpu_s8_tensor_core_body_equals_the_imad_body(cuda, kernel, m, k, n):
    """Shapes just off the s8 rule (K or N not a multiple of 16) run the
    IMAD body; their operands padded with zero K columns / rows and zero N
    columns to the next multiple of 16 run the s8 body on the same sums:
    the outputs agree bit for bit, on the f32 epilogue (scale, bias,
    gelu) too."""
    from repro_torch.kernels.dbb_gemm.ops import s8_tc_body as dbb_rule
    from repro_torch.kernels.sta_gemm.ops import s8_tc_body as sta_rule
    x, w, bias, scale = _s8_operands(cuda, m, k, n, m + k)
    kp, np_ = -(-k // 16) * 16, -(-n // 16) * 16
    xp = torch.zeros(m, kp, dtype=I8, device=cuda)
    xp[:, :k] = x
    wp = torch.zeros(kp, np_, dtype=I8, device=cuda)
    wp[:k, :n] = w
    pad = torch.zeros(np_ - n, device=cuda)
    bp, sp = torch.cat([bias, pad]), torch.cat([scale, pad])
    if kernel == "sta_gemm":
        assert not sta_rule(k, n) and sta_rule(kp, np_)

        def run(a, b, bi, sc, **kw):
            return sta_gemm(a, b, bi, sc, **kw)
    else:
        assert not dbb_rule(k, n) and dbb_rule(kp, np_)

        def run(a, b, bi, sc, **kw):
            p = pack_dbb(b, 8, 4)
            return dbb_gemm(a, p.values, p.bitmask, bi, sc, nnz=4, **kw)
    for kw in (dict(), dict(act="gelu"), dict(act="relu",
                                              out_dtype=I8)):
        bi = bias if kw else None
        before = LAUNCHES[kernel + "_s8_tc"]
        imad = run(x, w, bi, scale if kw else None, **kw)
        torch.cuda.synchronize()
        assert LAUNCHES[kernel + "_s8_tc"] == before
        tc = run(xp, wp, bp if kw else None, sp if kw else None, **kw)
        torch.cuda.synchronize()
        assert LAUNCHES[kernel + "_s8_tc"] == before + 1
        assert torch.equal(tc[:, :n], imad), kw


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["sta_gemm", "dbb_gemm"])
@pytest.mark.parametrize("m,k,n", [(512, 1184, 256), (300, 1184, 4112),
                                   (8, 8192, 48)])
def test_gpu_s8_tc_all_127_is_the_exact_integer(cuda, kernel, m, k, n):
    """All-127 operands at K the s8 body takes (1184 beside the IMAD
    body's 1179 probe, and olmo's 8192): every int32 sum K·127² exactly,
    past 2^24, on both tile heights."""
    x = torch.full((m, k), 127, dtype=I8, device=cuda)
    w = torch.full((k, n), 127, dtype=I8, device=cuda)
    got, want = _s8_tc_run(cuda, kernel, x, w, 8)
    assert got.dtype == I32 and k * 127 * 127 > 2 ** 24
    assert bool((got == k * 127 * 127).all())
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["sta_gemm", "dbb_gemm"])
@pytest.mark.parametrize("n", [208, 4112])
def test_gpu_s8_tc_bits_at_any_m_and_across_calls(cuda, kernel, n):
    """Two calls give equal bits, and rows of an M512 call equal the same
    rows alone (M1) and in a ragged M130 call, on the f32 epilogue."""
    x, w, bias, scale = _s8_operands(cuda, 512, 512, n, 9)
    if kernel == "sta_gemm":
        def run(a):
            return sta_gemm(a, w, bias, scale, act="gelu")
    else:
        p = pack_dbb(w, 8, 4)

        def run(a):
            return dbb_gemm(a, p.values, p.bitmask, bias, scale, act="gelu",
                            nnz=4)
    full = run(x)
    assert torch.equal(full, run(x))
    assert torch.equal(full[77], run(x[77:78].contiguous())[0])
    assert torch.equal(full[200:330], run(x[200:330].contiguous()))


@pytest.mark.gpu
def test_gpu_s8_tc_counts_follow_the_kernels_own_rules(cuda):
    """The wrappers' s8_tc_body mirrors the launchers' rules (the
    libraries' exported sta_gemm_s8_tc_body / dbb_gemm_s8_tc_body) on a
    grid of K and N; float launches and int8 launches off the rule leave
    the ``_s8_tc`` counts alone."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.dbb_gemm.ops import s8_tc_body as dbb_rule
    from repro_torch.kernels.sta_gemm.ops import s8_tc_body as sta_rule
    sq = build.load("sta_gemm").sta_gemm_s8_tc_body
    sq.argtypes = [ctypes.c_int] * 2
    dq = build.load("dbb_gemm").dbb_gemm_s8_tc_body
    dq.argtypes = [ctypes.c_int] * 2
    for k in (0, 8, 16, 24, 136, 1179, 1184, 2048, 8192):
        for n in (1, 10, 16, 24, 200, 208, 4104, 8192):
            assert bool(sq(k, n)) == sta_rule(k, n), (k, n)
            assert bool(dq(k, n)) == dbb_rule(k, n), (k, n)
    g = torch.Generator(device=cuda).manual_seed(2)
    before = dict(LAUNCHES)
    for dt in (torch.float32, BF):
        x = torch.randn(130, 256, generator=g, device=cuda).to(dt)
        w = torch.randn(256, 192, generator=g, device=cuda)
        p = pack_dbb(w, 8, 4)
        sta_gemm(x, w.to(dt))
        dbb_gemm(x, p.values, p.bitmask)
    xi, wi, _, _ = _s8_operands(cuda, 130, 264, 200, 3)
    sta_gemm(xi, wi)
    pi = pack_dbb(wi, 8, 4)
    dbb_gemm(xi, pi.values, pi.bitmask)
    xc, wc, _, _ = _s8_operands(cuda, 256, 4096, 10, 4)    # the classifier
    pc = pack_dbb(wc, 8, 2)
    dbb_gemm(xc, pc.values, pc.bitmask, nnz=2)
    torch.cuda.synchronize()
    for name in ("sta_gemm_s8_tc", "dbb_gemm_s8_tc"):
        assert LAUNCHES[name] == before[name], name
    assert LAUNCHES["sta_gemm_s8"] == before["sta_gemm_s8"] + 1
    assert LAUNCHES["dbb_gemm_s8"] == before["dbb_gemm_s8"] + 2


# ---------------------------------------------------------------------------
# The skinny int8 body (csrc/split_k_s8.cuh) of dbb_gemm_skinny's and
# sta_gemm_skinny's int8 branches: all M <= 32 rows and 64 columns a block,
# K in 128-deep stages split over <= 8 blocks, s8 mma.sync, the slices
# added by a second launch from a workspace
# ---------------------------------------------------------------------------

# (act, out dtype, with scale, with bias) whose outputs are exact: the raw
# int32 sum, int8 requantized after relu, f32 with a bias after relu
S8_EXACT = [("none", None, False, False), ("relu", I8, True, False),
            ("relu", F32, False, True)]


def _s8_skinny(cuda, kernel, x, w, nnz, bias=None, scale=None, **kw):
    """One int8 skinny call on the body (dense w, or w packed at ``nnz``)
    and its plain version's output; checks one ``_s8`` launch."""
    before = LAUNCHES[kernel + "_s8"]
    if kernel == "sta_gemm_skinny":
        got = sta_gemm_skinny(x, w, bias, scale, **kw)
        want = sta_gemm_ref(x, w, bias, scale, **kw)
    else:
        p = pack_dbb(w, 8, nnz)
        got = dbb_gemm_skinny(x, p.values, p.bitmask, bias, scale, nnz=nnz,
                              **kw)
        want = dbb_gemm_ref(x, p.values, p.bitmask, bias, scale, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES[kernel + "_s8"] == before + 1
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["sta_gemm_skinny", "dbb_gemm_skinny"])
@pytest.mark.parametrize("m", [1, 8, 13, 24, 32])
@pytest.mark.parametrize("k,n", [(264, 10), (264, 200), (264, 640),
                                 (2048, 10), (2048, 200), (2048, 640)])
def test_gpu_s8_skinny_body_is_the_plain_version_bit_for_bit(cuda, kernel,
                                                             m, k, n):
    """Every skinny M bucket; K 264 (three 128-deep stages, the last one
    8 deep; x rows of 8-byte multiples: cp.async) and K 2048 (8 slices of
    two stages at N 10 and 200); N 640 with K 2048 takes the TMA boxes,
    N 10 the byte copies and N 200 the 4-byte ones. The exact epilogues
    bit for bit, each call counted once, two calls equal."""
    x, w, bias, scale = _s8_operands(cuda, m, k, n, m * 31 + k + n)
    nnz = 2 if m % 2 else 4
    for act, od, has_scale, has_bias in S8_EXACT:
        b, s = _epi(bias, scale, has_scale, has_bias)
        got, want = _s8_skinny(cuda, kernel, x, w, nnz, b, s, act=act,
                               out_dtype=od)
        assert torch.equal(got, want), (act, od)
        again, _ = _s8_skinny(cuda, kernel, x, w, nnz, b, s, act=act,
                              out_dtype=od)
        assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["sta_gemm_skinny", "dbb_gemm_skinny"])
@pytest.mark.parametrize("nnz", [1, 3, 5, 8])
def test_gpu_s8_skinny_body_every_nnz_and_the_fused_epilogues(cuda, kernel,
                                                              nnz):
    """M 29 at K 1184 N 136 (TMA boxes, 10 stages over 8 slices): every
    nnz's stage layout (the DBB branch; the dense one runs once a case)
    and every epilogue of S8_EPILOGUES within the int8 tolerance."""
    x, w, bias, scale = _s8_operands(cuda, 29, 1184, 136, nnz)
    for act, od, has_scale, has_bias in S8_EPILOGUES:
        b, s = _epi(bias, scale, has_scale, has_bias)
        got, want = _s8_skinny(cuda, kernel, x, w, nnz, b, s, act=act,
                               out_dtype=od)
        _s8_close(got, want, act)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["sta_gemm_skinny", "dbb_gemm_skinny"])
def test_gpu_s8_skinny_all_127_at_k8192(cuda, kernel):
    """All-127 operands at M 32 K 8192 (every int32 sum 8192·127², past
    f32's exact 2^24): each output is that integer."""
    x = torch.full((32, 8192), 127, dtype=I8, device=cuda)
    w = torch.full((8192, 136), 127, dtype=I8, device=cuda)
    got, want = _s8_skinny(cuda, kernel, x, w, 8)
    assert got.dtype == I32 and torch.equal(got, want)
    assert bool((got == 8192 * 127 * 127).all())


@pytest.mark.gpu
def test_gpu_s8_skinny_workspace_follows_the_rule(cuda):
    """The workspace the wrappers allocate holds ``s8_splits(K, N)``
    slices (the Python mirror they allocate through), which both
    libraries' exported rule gives on a grid of K and N: 1, 2, 4 or 8,
    within 2 blocks an SM and two 128-deep stages a slice where it
    splits."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.skinny.ops import s8_splits
    rules = []
    for kernel in ("sta_gemm_skinny", "dbb_gemm_skinny"):
        fn = getattr(build.load(kernel), kernel + "_s8_splits")
        fn.argtypes = [ctypes.c_int] * 2
        rules.append((kernel, fn))
    for k in (0, 8, 264, 512, 1184, 2048, 4096, 8192, 16384):
        for n in (1, 10, 136, 200, 640, 2048, 8192, 50304):
            s = rules[0][1](k, n)
            for kernel, fn in rules:
                assert fn(k, n) == s == s8_splits(k, n), (k, n)
            assert s in (1, 2, 4, 8), (k, n, s)
            if s > 1:
                assert -(-n // 64) * s <= 2 * 132 and -(-k // 128) >= 2 * s


# ---------------------------------------------------------------------------
# The tensor-core body of conv_gemm_dbb (csrc/conv_tc.cuh): the image by TMA
# im2col boxes, the DBB planes decompressed in shared memory, f32 images on
# 3xTF32 wgmma, int8 images on s8 wgmma
# ---------------------------------------------------------------------------

# b, h, w, c, k, n, stride, padding, nnz: convnet conv1 and conv2's
# geometry; M off the 128-pixel tile (tiles across image rows and images);
# N off the 128-column tile; stride 2; VALID; C past one tap a stage
CONV_TC_SHAPES = [(2, 16, 16, 64, 3, 128, 1, "SAME", 2),
                  (2, 8, 8, 128, 3, 256, 1, "SAME", 2),
                  (2, 9, 7, 64, 3, 48, 1, "SAME", 1),
                  (1, 11, 13, 64, 3, 32, 2, "SAME", 4),
                  (1, 10, 8, 64, 5, 16, 1, "VALID", 8),
                  (3, 5, 6, 128, 3, 144, 2, "VALID", 3)]
# f32 only: C at the rule's edge (16: a stage of K 32 is two taps' pieces,
# K 144 ends half way into a stage), N 20 (N % 4)
CONV_TC_F32_SHAPES = [(2, 9, 7, 16, 3, 20, 1, "SAME", 1),
                      (1, 7, 9, 48, 3, 132, 2, "SAME", 4)]


def _conv_tc_s8(cuda, b, h, w, c, k, n, nnz, seed):
    from repro_torch.core.quant import quantize_weight
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randint(-127, 128, (b, h, w, c), generator=g, device=cuda,
                      dtype=I8)
    qw = quantize_weight(torch.randn(k * k * c, n, generator=g, device=cuda))
    bias = torch.randn(n, generator=g, device=cuda) * 100
    scale = (torch.rand(n, generator=g, device=cuda) + 0.5) * qw.scale
    return x, pack_dbb(qw.q, 8, nnz), bias, scale


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,c,k,n,stride,padding,nnz",
                         CONV_TC_SHAPES + CONV_TC_F32_SHAPES)
def test_gpu_conv_tc_f32(cuda, b, h, w, c, k, n, stride, padding, nnz):
    from repro_torch.kernels.conv_gemm.ops import tc_body
    assert tc_body(torch.float32, c, k, k, stride, n)
    x, wt, bias, scale = _conv_inputs(cuda, b, h, w, c, k, n, torch.float32)
    p = pack_dbb(wt, 8, nnz)
    kw = dict(kh=k, kw=k, stride=stride, padding=padding, act="relu")
    before = dict(LAUNCHES)
    got = conv_gemm_dbb(x, p.values, p.bitmask, bias, scale, nnz=nnz, **kw)
    torch.cuda.synchronize()
    moved = {key: LAUNCHES[key] - before[key] for key in LAUNCHES
             if LAUNCHES[key] != before[key]}
    assert moved == {"conv_gemm_dbb": 1, "conv_gemm_dbb_tc": 1}
    assert bool(torch.isfinite(got).all())
    _gpu_close(got, conv_gemm_dbb_ref(x, p.values, p.bitmask, bias, scale,
                                      **kw), torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("act,od,has_scale,has_bias", S8_EPILOGUES)
@pytest.mark.parametrize("b,h,w,c,k,n,stride,padding,nnz", CONV_TC_SHAPES)
def test_gpu_conv_tc_s8(cuda, b, h, w, c, k, n, stride, padding, nnz, act,
                        od, has_scale, has_bias):
    from repro_torch.kernels.conv_gemm.ops import tc_body
    assert tc_body(I8, c, k, k, stride, n)
    x, p, bias, scale = _conv_tc_s8(cuda, b, h, w, c, k, n, nnz, h * w + n)
    bi, sc = _epi(bias, scale, has_scale, has_bias)
    kw = dict(kh=k, kw=k, stride=stride, padding=padding, act=act,
              out_dtype=od)
    before = dict(LAUNCHES)
    got = conv_gemm_dbb(x, p.values, p.bitmask, bi, sc, nnz=nnz, **kw)
    torch.cuda.synchronize()
    moved = {key: LAUNCHES[key] - before[key] for key in LAUNCHES
             if LAUNCHES[key] != before[key]}
    assert moved == {"conv_gemm_dbb_s8": 1, "conv_gemm_dbb_s8_tc": 1}
    _s8_close(got, conv_gemm_dbb_ref(x, p.values, p.bitmask, bi, sc, **kw),
              act)


@pytest.mark.gpu
@pytest.mark.parametrize("nnz", [1, 2, 8])
def test_gpu_conv_tc_s8_equals_the_fma_body(cuda, nnz):
    """The int8 tensor-core body and the IMAD body on the same sums: C 64
    (on the rule) against the image and weight zero-padded to C 72 (off it:
    the FMA body). Integer sums are exact in any order, so the int32 output
    and the f32 epilogue's are bit-equal."""
    from repro_torch.kernels.conv_gemm.ops import tc_body
    b, h, w, c, k, n = 2, 9, 7, 64, 3, 48
    x, p, bias, scale = _conv_tc_s8(cuda, b, h, w, c, k, n, nnz, 7 + nnz)
    from repro_torch.core.dbb import decompress_bitmask
    dense = decompress_bitmask(p.values, p.bitmask, block=8)
    xp = torch.zeros((b, h, w, c + 8), dtype=I8, device=cuda)
    xp[..., :c] = x
    wp = torch.zeros((k * k, c + 8, n), dtype=I8, device=cuda)
    wp[:, :c] = dense.reshape(k * k, c, n)
    pp = pack_dbb(wp.reshape(k * k * (c + 8), n), 8, nnz)
    assert tc_body(I8, c, k, k, 1, n) and not tc_body(I8, c + 8, k, k, 1, n)
    for bi, sc, act in ((None, None, "none"), (bias, scale, "gelu")):
        before = LAUNCHES["conv_gemm_dbb_s8_tc"]
        got = conv_gemm_dbb(x, p.values, p.bitmask, bi, sc, kh=k, kw=k,
                            act=act, nnz=nnz)
        fma = conv_gemm_dbb(xp, pp.values, pp.bitmask, bi, sc, kh=k, kw=k,
                            act=act, nnz=nnz)
        torch.cuda.synchronize()
        assert LAUNCHES["conv_gemm_dbb_s8_tc"] == before + 1
        assert torch.equal(got, fma)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, I8])
def test_gpu_conv_tc_image_is_the_same_bits_in_any_batch(cuda, dtype):
    """An image's output does not depend on the batch around it or on its
    pixels' places in the 128-pixel tiles: image 1 of a batch of 3 (its
    pixels start at 9·7 = 63, mid-tile) equals a call on it alone, bit for
    bit."""
    b, h, w, c, k, n, nnz = 3, 9, 7, 64, 3, 48, 2
    if dtype == I8:
        x, p, bias, scale = _conv_tc_s8(cuda, b, h, w, c, k, n, nnz, 3)
    else:
        x, wt, bias, scale = _conv_inputs(cuda, b, h, w, c, k, n, dtype)
        p = pack_dbb(wt, 8, nnz)
    kw = dict(kh=k, kw=k, act="gelu", nnz=nnz)
    full = conv_gemm_dbb(x, p.values, p.bitmask, bias, scale, **kw)
    one = conv_gemm_dbb(x[1:2].contiguous(), p.values, p.bitmask, bias,
                        scale, **kw)
    again = conv_gemm_dbb(x, p.values, p.bitmask, bias, scale, **kw)
    assert torch.equal(full[1:2], one) and torch.equal(full, again)


@pytest.mark.gpu
def test_gpu_conv_tc_counts_follow_the_kernels_own_rule(cuda):
    """The wrapper's tc_body equals the launcher's exported rule on a grid
    of dtypes and geometry, and no bf16 image takes the body."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.conv_gemm.ops import tc_body
    fn = build.load("conv_gemm_dbb").conv_gemm_dbb_tc_body
    fn.argtypes = [ctypes.c_int] * 6
    for dt in (torch.float32, torch.bfloat16, I8):
        for c in (1, 8, 16, 24, 48, 64, 72, 128, 192):
            for kk in (1, 3, 5, 33):
                for s in (1, 2, 8, 9):
                    for n in (6, 10, 16, 20, 48, 130, 256):
                        want = fn(build.dtype_code(dt), c, kk, kk, s, n) == 1
                        assert tc_body(dt, c, kk, kk, s, n) is want
                        assert not (want and dt == torch.bfloat16)


@pytest.mark.gpu
def test_gpu_conv_tc_s8_all_127_is_the_exact_integer(cuda):
    """All-127 operands at C 128 (K 1152, every sum 1152·127² past 2^24)
    on the int8 tensor-core body: each output is that integer."""
    x = torch.full((2, 5, 5, 128), 127, dtype=I8, device=cuda)
    p = pack_dbb(torch.full((1152, 32), 127, dtype=I8, device=cuda), 8, 8)
    before = LAUNCHES["conv_gemm_dbb_s8_tc"]
    got = conv_gemm_dbb(x, p.values, p.bitmask, kh=3, kw=3, padding="VALID",
                        nnz=8)
    torch.cuda.synchronize()
    assert LAUNCHES["conv_gemm_dbb_s8_tc"] == before + 1
    assert got.dtype == I32 and bool((got == 1152 * 127 * 127).all())


# ---------------------------------------------------------------------------
# head_sample_fused on the skinny float body (csrc/skinny_float.cuh, with
# sta_gemm_skinny): persistent blocks walking 64-column tiles, a running
# best per row, the blocks' partials merged by a second launch
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 9, 24, 32])
@pytest.mark.parametrize("k,n", [(2048, 1024),    # a cluster of 4 blocks
                                 (2048, 4096),    # a cluster of 2
                                 (128, 8960),     # blocks 0-7 walk 2 tiles
                                 (2048, 50304)])  # the olmo-1b head
def test_gpu_head_sample_body_matches_the_plain_version(cuda, m, k, n):
    """The fused kernel's tolerance (module doc) on every cluster size and
    with blocks that walk more than one tile; one launch counted."""
    from repro_torch.kernels.sample import (head_sample_fused,
                                            head_sample_fused_ref,
                                            sample_scores)
    h, w, counts, rows = _head_sample_case(cuda, m, k, n, 7 * m + k)
    before = LAUNCHES["head_sample_fused"]
    got_s, got_i = head_sample_fused(h, w, counts, *rows, base=11)
    torch.cuda.synchronize()
    assert LAUNCHES["head_sample_fused"] == before + 1
    want_s, want_i = head_sample_fused_ref(h, w, counts, *rows, base=11)
    tol = 1e-5 * max(want_s.abs().max().item(), 1.0)
    torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=tol)
    col = 11 + torch.arange(n, device=cuda)[None, :]
    scores = sample_scores(h @ w, counts, *(a[:, None] for a in rows), col)
    top2 = scores.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * tol
    assert bool((got_i == want_i)[decided].all())
    assert int(decided.sum()) >= m - 1


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 24, 32])
def test_gpu_head_sample_t0_is_the_greedy_head_bit_for_bit(cuda, m):
    """At olmo-1b's head (K2048 N50304): temperature 0 with default
    penalties gives the skinny head's max logit and its first argmax, bit
    for bit, at M 1, 8, 24 and 32 (one body, one K order)."""
    from repro_torch.kernels.sample import head_sample_fused
    g = torch.Generator(device=cuda).manual_seed(100 + m)
    h = torch.randn(m, 2048, generator=g, device=cuda)
    w = torch.randn(2048, 50304, generator=g, device=cuda) * 0.02
    z = torch.zeros(m, device=cuda)
    zi = torch.zeros(m, dtype=torch.int32, device=cuda)
    s, i = head_sample_fused(h, w, torch.zeros((m, 50304), dtype=torch.int32,
                                               device=cuda),
                             z, z + 1, z, z, zi, zi)
    logits = sta_gemm_skinny(h, w)
    assert torch.equal(s, logits.max(dim=-1).values)
    assert torch.equal(i.long(), torch.argmax(logits, dim=-1))


@pytest.mark.gpu
def test_gpu_head_sample_ties_across_blocks_take_the_lowest_index(cuda):
    """K 128, N 8960: 140 tiles on 132 blocks, so block 0 walks tiles 0 and
    132 and block 5 tiles 5 and 137. Equal columns in both of block 0's
    tiles, in both of block 5's (different halves) and in block 9's tile
    beat every other column: the lowest index wins on every row, and each
    time it is dropped the next-lowest does."""
    from repro_torch.kernels.sample import head_sample_fused
    from repro_torch.kernels.sample.ops import partials
    m, k, n = 8, 128, 8960
    assert partials(k, n) == 132
    g = torch.Generator(device=cuda).manual_seed(5)
    h = torch.rand(m, k, generator=g, device=cuda) + 0.5
    w = -torch.rand(k, n, generator=g, device=cuda)
    top = torch.rand(k, generator=g, device=cuda)
    tied = [5, 64 * 5 + 40, 64 * 9 + 2, 64 * 132 + 3, 64 * 137 + 1]
    for c in tied:
        w[:, c] = top
    z = torch.zeros(m, device=cuda)
    zi = torch.zeros(m, dtype=torch.int32, device=cuda)
    fresh = torch.zeros((m, n), dtype=torch.int32, device=cuda)
    for drop, want in ((None, 5), (5, 360), (360, 578), (578, 8451),
                       (8451, 8769)):
        if drop is not None:
            w[:, drop] = -1.0
        _, i = head_sample_fused(h, w, fresh, z, z + 1, z, z, zi, zi)
        assert i.tolist() == [want] * m, drop


@pytest.mark.gpu
def test_gpu_head_sample_workspace_follows_the_rule(cuda):
    """The wrapper's partial count (sample.ops.partials, a mirror of the
    body's grid) equals the library's head_sample_fused_partials, and a
    row's sample does not depend on the rows beside it."""
    from repro_torch.kernels.sample import head_sample_fused
    from repro_torch.kernels.sample.ops import _partials, partials
    for k in (128, 256, 1024, 2048, 8192):
        for n in (128, 384, 1024, 4096, 4224, 4352, 8960, 50304):
            assert partials(k, n) == _partials(k, n), (k, n)
    h, w, counts, rows = _head_sample_case(cuda, 24, 2048, 4096, 3)
    s24, i24 = head_sample_fused(h, w, counts, *rows)
    s1, i1 = head_sample_fused(h[5:6].contiguous(), w,
                               counts[5:6].contiguous(),
                               *(a[5:6].contiguous() for a in rows))
    assert torch.equal(s24[5:6], s1) and torch.equal(i24[5:6], i1)


# ---------------------------------------------------------------------------
# conv_gemm's small-C body (the filter and a tile's zero-halo window in
# shared memory, all N channels a block, TMA bulk stores) and its dense
# images on conv_tc.cuh
# ---------------------------------------------------------------------------

# b, h, w, c, k, n, stride, padding: convnet conv0 and lenet conv1's
# geometry, N 6 (no vector store), stride 2 and 3, VALID, an image wider
# than a 128-pixel tile, a window cut to fit (stride 8 over W 1030)
SMALL_SHAPES = [(2, 32, 32, 3, 3, 64, 1, "SAME"),
                (2, 14, 14, 6, 5, 16, 1, "SAME"),
                (3, 9, 7, 1, 5, 6, 1, "SAME"),
                (2, 11, 11, 3, 3, 6, 2, "VALID"),
                (2, 10, 9, 5, 3, 20, 3, "VALID"),
                (1, 5, 300, 3, 3, 64, 1, "SAME"),
                (1, 3, 1030, 16, 3, 8, 8, "SAME")]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,c,k,n,stride,padding", SMALL_SHAPES)
def test_gpu_conv_small_f32(cuda, b, h, w, c, k, n, stride, padding):
    from repro_torch.kernels.conv_gemm.ops import small_body
    assert small_body(torch.float32, c, k, k, n)
    x, wt, bias, scale = _conv_inputs(cuda, b, h, w, c, k, n, torch.float32)
    kw = dict(kh=k, kw=k, stride=stride, padding=padding, act="relu")
    before = dict(LAUNCHES)
    got = conv_gemm(x, wt, bias, scale, **kw)
    torch.cuda.synchronize()
    moved = {key: LAUNCHES[key] - before[key] for key in LAUNCHES
             if LAUNCHES[key] != before[key]}
    assert moved == {"conv_gemm": 1, "conv_gemm_small": 1}
    _gpu_close(got, conv_gemm_ref(x, wt, bias, scale, **kw), torch.float32)
    assert torch.equal(got, conv_gemm(x, wt, bias, scale, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("act,od,has_scale,has_bias", S8_EPILOGUES)
@pytest.mark.parametrize("b,h,w,c,k,n,stride,padding", SMALL_SHAPES)
def test_gpu_conv_small_s8(cuda, b, h, w, c, k, n, stride, padding, act, od,
                           has_scale, has_bias):
    """int8 images: bit-equal to the plain version (dp4a sums exactly)."""
    g = torch.Generator(device=cuda).manual_seed(h * w + c + n)
    x = torch.randint(-127, 128, (b, h, w, c), generator=g, device=cuda,
                      dtype=I8)
    wt = torch.randint(-127, 128, (k * k * c, n), generator=g, device=cuda,
                       dtype=I8)
    bias = torch.randn(n, generator=g, device=cuda) * 100 if has_bias else None
    scale = ((torch.rand(n, generator=g, device=cuda) + 0.5) * 1e-3
             if has_scale else None)
    kw = dict(kh=k, kw=k, stride=stride, padding=padding, act=act,
              out_dtype=od)
    before = LAUNCHES["conv_gemm_s8_small"]
    got = conv_gemm(x, wt, bias, scale, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["conv_gemm_s8_small"] == before + 1
    _s8_close(got, conv_gemm_ref(x, wt, bias, scale, **kw), act)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, I8])
@pytest.mark.parametrize("c,n", [(8, 64), (16, 10)])
def test_gpu_conv_small_equals_the_fma_body(cuda, dtype, c, n):
    """The small-C body against the FMA (f32) / IMAD (int8) body, reached
    through conv_gemm_dbb on the dense weight as a DBB plane of nnz 8 (an
    all-ones bitmask: the same weights in K order) at C 8 and 16 x 3x3
    (K 72 / 144; off the tensor-core rule at N 10): bit for bit."""
    from repro_torch.kernels.conv_gemm.ops import small_body, tc_body
    assert small_body(dtype, c, 3, 3, n) and not tc_body(dtype, c, 3, 3, 1, n)
    g = torch.Generator(device=cuda).manual_seed(c + n)
    if dtype == I8:
        x = torch.randint(-127, 128, (3, 13, 11, c), generator=g, device=cuda,
                          dtype=I8)
        wt = torch.randint(-127, 128, (9 * c, n), generator=g, device=cuda,
                           dtype=I8)
    else:
        x, wt, _, _ = _conv_inputs(cuda, 3, 13, 11, c, 3, n, dtype)
    bias = torch.randn(n, generator=g, device=cuda)
    scale = torch.rand(n, generator=g, device=cuda) + 0.5
    ones = torch.full((9 * c // 8, n), 0xFF, dtype=torch.int32, device=cuda)
    for act in ("none", "relu", "gelu"):
        kw = dict(kh=3, kw=3, act=act)
        if dtype == I8:
            kw["out_dtype"] = torch.float32
        small = conv_gemm(x, wt, bias, scale, **kw)
        fma = conv_gemm_dbb(x, wt, ones, bias, scale, nnz=8, **kw)
        assert torch.equal(small, fma), act


DENSE_TC_SHAPES = [(2, 16, 16, 64, 3, 128, 1, "SAME"),   # convnet conv1
                   (2, 8, 8, 128, 3, 256, 1, "SAME"),    # convnet conv2
                   (1, 11, 13, 64, 3, 48, 2, "SAME"),
                   (3, 5, 6, 128, 3, 144, 2, "VALID")]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,c,k,n,stride,padding", DENSE_TC_SHAPES)
def test_gpu_conv_dense_tc_f32(cuda, b, h, w, c, k, n, stride, padding):
    """Dense f32 images on conv_tc.cuh's dense mode (3xTF32): the f32
    tolerance against the plain version; bit-equal to conv_gemm_dbb's
    tensor-core body on the same weight as an all-ones plane of nnz 8 (the
    same tiles, expanded another way)."""
    from repro_torch.kernels.conv_gemm.ops import tc_body
    assert tc_body(torch.float32, c, k, k, stride, n)
    x, wt, bias, scale = _conv_inputs(cuda, b, h, w, c, k, n, torch.float32)
    kw = dict(kh=k, kw=k, stride=stride, padding=padding, act="relu")
    before = dict(LAUNCHES)
    got = conv_gemm(x, wt, bias, scale, **kw)
    torch.cuda.synchronize()
    moved = {key: LAUNCHES[key] - before[key] for key in LAUNCHES
             if LAUNCHES[key] != before[key]}
    assert moved == {"conv_gemm": 1, "conv_gemm_tc": 1}
    _gpu_close(got, conv_gemm_ref(x, wt, bias, scale, **kw), torch.float32)
    ones = torch.full((k * k * c // 8, n), 0xFF, dtype=torch.int32,
                      device=cuda)
    plane = conv_gemm_dbb(x, wt, ones, bias, scale, nnz=8, **kw)
    assert torch.equal(got, plane)


@pytest.mark.gpu
@pytest.mark.parametrize("act,od,has_scale,has_bias", S8_EPILOGUES)
@pytest.mark.parametrize("b,h,w,c,k,n,stride,padding", DENSE_TC_SHAPES)
def test_gpu_conv_dense_tc_s8(cuda, b, h, w, c, k, n, stride, padding, act,
                              od, has_scale, has_bias):
    """Dense int8 images on the s8 tensor-core body (w transposed to K-major
    tiles): bit-equal to the plain version."""
    g = torch.Generator(device=cuda).manual_seed(h * w + c + n)
    x = torch.randint(-127, 128, (b, h, w, c), generator=g, device=cuda,
                      dtype=I8)
    wt = torch.randint(-127, 128, (k * k * c, n), generator=g, device=cuda,
                       dtype=I8)
    bias = torch.randn(n, generator=g, device=cuda) * 100 if has_bias else None
    scale = ((torch.rand(n, generator=g, device=cuda) + 0.5) * 1e-4
             if has_scale else None)
    kw = dict(kh=k, kw=k, stride=stride, padding=padding, act=act,
              out_dtype=od)
    before = LAUNCHES["conv_gemm_s8_tc"]
    got = conv_gemm(x, wt, bias, scale, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["conv_gemm_s8_tc"] == before + 1
    _s8_close(got, conv_gemm_ref(x, wt, bias, scale, **kw), act)


@pytest.mark.gpu
def test_gpu_conv_dense_tc_s8_all_127_is_the_exact_integer(cuda):
    x = torch.full((2, 5, 5, 128), 127, dtype=I8, device=cuda)
    wt = torch.full((1152, 32), 127, dtype=I8, device=cuda)
    got = conv_gemm(x, wt, kh=3, kw=3, padding="VALID")
    assert got.dtype == I32 and bool((got == 1152 * 127 * 127).all())


@pytest.mark.gpu
def test_gpu_conv_gemm_counts_follow_the_kernels_own_rules(cuda):
    """The wrapper's small_body and tc_body equal the launcher's exported
    rules (conv_gemm_small_body, conv_gemm_tc_body: the tensor-core rule
    where the small one does not take the image) on a grid of dtypes and
    geometry."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.conv_gemm.ops import small_body, tc_body
    lib = build.load("conv_gemm")
    small_fn, tc_fn = lib.conv_gemm_small_body, lib.conv_gemm_tc_body
    small_fn.argtypes = [ctypes.c_int] * 5
    tc_fn.argtypes = [ctypes.c_int] * 6
    for dt in (torch.float32, torch.bfloat16, I8):
        code = build.dtype_code(dt)
        for c in (1, 3, 6, 8, 16, 17, 24, 64, 128):
            for kk in (1, 3, 5, 33):
                for n in (6, 10, 16, 20, 48, 64, 65, 130, 256):
                    small = small_body(dt, c, kk, kk, n)
                    assert small is (small_fn(code, c, kk, kk, n) == 1)
                    for s in (1, 2, 9):
                        want = tc_fn(code, c, kk, kk, s, n) == 1
                        assert want is (not small
                                        and tc_body(dt, c, kk, kk, s, n))


# ---------------------------------------------------------------------------
# the rest of the dense_lm family's shapes: GQA groups 5, 7, 12 at D 128,
# the 4096-token window over a 5120-token prompt, QKV bias at the K/V
# projections' N 512 / 1024, starcoder2's GeLU up-projection, the untied
# heads at K 5120, N 152064
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(10, 2), (14, 2), (12, 1)])
def test_gpu_flash_prefill_gqa_groups(cuda, dtype, hq, hkv):
    """GQA groups of 5 (qwen), 7 (yi) and 12 (starcoder2): ragged starts,
    T = S off the tile, and a continuation chunk."""
    _flash_case(cuda, dtype, 2, 300, 300, hq, hkv, 128, (0, 37), (0, 0), 0,
                0.0)
    _flash_case(cuda, dtype, 2, 70, 400, hq, hkv, 128, (0, 5), (330, 256),
                0, 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv", [(12, 1), (48, 4)])
def test_gpu_flash_prefill_window_4096_at_5120(cuda, hq, hkv):
    """starcoder2's 4096-token window over a 5120-token prompt in bf16 at
    D 128 (G 12): rows past 4096 drop their oldest keys, tiles wholly
    outside the window are skipped; the second case is the layer's own
    48 query heads over 4 KV heads."""
    _flash_case(cuda, torch.bfloat16, 1, 5120, 5120, hq, hkv, 128, (0,),
                (0,), 4096, 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 64])
def test_gpu_flash_prefill_packed_gqa_12(cuda, dtype, window):
    """The packed prefill at starcoder2's group (Hq 12 over one KV head),
    segments off the tile, with and without a window."""
    lens, pad = (70, 300, 5, 129), 10
    t = sum(lens) + pad
    g = torch.Generator(device=cuda).manual_seed(t + window)
    q = torch.randn(t, 12, 128, generator=g, device=cuda).to(dtype)
    k = torch.randn(t, 1, 128, generator=g, device=cuda).to(dtype)
    v = torch.randn(t, 1, 128, generator=g, device=cuda).to(dtype)
    seg = torch.repeat_interleave(
        torch.arange(len(lens) + 1, dtype=torch.int32),
        torch.tensor(list(lens) + [pad])).to(cuda)
    before = dict(LAUNCHES)
    got = packed_flash_attention(q, k, v, seg, window=window)
    torch.cuda.synchronize()
    _flash_tc_counted(before, "flash_prefill_packed", dtype, 128)
    assert torch.isfinite(got.float()).all()
    want = packed_prefill_ref(q.transpose(0, 1), k.transpose(0, 1),
                              v.transpose(0, 1), seg, sm_scale=128 ** -0.5,
                              window=window).transpose(0, 1)
    _gpu_close(got, want, dtype, bf16_atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,page,window", [(5, 64, 0), (7, 64, 100),
                                           (12, 16, 37), (12, 64, 4096)])
def test_gpu_paged_decode_gqa_groups(cuda, dtype, g, page, window):
    """Decode at G 5, 7 and 12 (D 128) through a shuffled pool, with and
    without a window; the last case at starcoder2's window over contexts
    of 2560-5119 slots."""
    s = 5120 if window == 4096 else 512
    args = _decode_operands(2, 2, g, 128, s, page, seed=g + window,
                            shuffle=True)
    q, kp, vp, table, lengths, start = (torch.from_numpy(a).to(cuda)
                                        for a in args)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    before = LAUNCHES["paged_decode"]
    got = paged_decode_attention(q, kp, vp, table, lengths, start,
                                 window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["paged_decode"] == before + 1
    want = paged_decode_ref(q, kp, vp, table, lengths, start,
                            sm_scale=128 ** -0.5, window=window)
    _gpu_close(got, want, dtype, bf16_atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,act", [(512, 5120, 1024, "none"),
                                       (512, 6144, 512, "none"),
                                       (300, 7168, 1024, "none"),
                                       (512, 6144, 24576, "gelu")])
def test_gpu_dbb_gemm_family_shapes(cuda, m, k, n, act):
    """bf16 x on the tensor-core body: the QKV bias at the K/V
    projections' N 1024 (qwen, yi) and 512 (starcoder2), and
    starcoder2's GeLU up-projection (K 6144, N 24576)."""
    g = torch.Generator(device=cuda).manual_seed(k + n)
    x = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    p = pack_dbb(torch.randn(k, n, generator=g, device=cuda) / k ** 0.5, 8,
                 4)
    bias = torch.randn(n, generator=g, device=cuda)
    before = dict(LAUNCHES)
    got = dbb_gemm(x, p.values, p.bitmask, bias, act=act)
    torch.cuda.synchronize()
    assert LAUNCHES["dbb_gemm"] == before["dbb_gemm"] + 1
    assert LAUNCHES["dbb_gemm_tc"] == before["dbb_gemm_tc"] + 1
    _gpu_close(got, dbb_gemm_ref(x, p.values, p.bitmask, bias, act=act),
               torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,act", [(8, 5120, 1024, "none"),
                                       (8, 6144, 512, "none"),
                                       (24, 7168, 1024, "none"),
                                       (8, 6144, 24576, "gelu"),
                                       (32, 6144, 24576, "gelu")])
def test_gpu_dbb_gemm_skinny_family_shapes(cuda, dtype, m, k, n, act):
    """The split-K body at the same shapes: decode (M8) and verify (M24,
    M32) rows, the bias and the GeLU added after the slices meet."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    p = pack_dbb(torch.randn(k, n, generator=g, device=cuda) / k ** 0.5, 8,
                 4)
    bias = torch.randn(n, generator=g, device=cuda)
    before = dict(LAUNCHES)
    got = dbb_gemm_skinny(x, p.values, p.bitmask, bias, act=act)
    torch.cuda.synchronize()
    assert LAUNCHES["dbb_gemm_skinny"] == before["dbb_gemm_skinny"] + 1
    assert (LAUNCHES["dbb_gemm_skinny_split"]
            == before["dbb_gemm_skinny_split"] + 1)
    _gpu_close(got, dbb_gemm_ref(x, p.values, p.bitmask, bias, act=act),
               dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(8, 5120, 152064), (24, 5120, 152064),
                                   (8, 7168, 64000), (8, 6144, 49152)])
def test_gpu_sta_gemm_skinny_untied_heads(cuda, m, k, n):
    """The untied f32 heads (qwen N 152064 at K 5120, yi, starcoder2) on
    the persistent float body: the f32 tolerance against torch.matmul with
    TF32 off, and a row the same bits in an M8 call as in the M24 one."""
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(m, k, generator=g, device=cuda)
    w = torch.randn(k, n, generator=g, device=cuda) / k ** 0.5
    got = sta_gemm_skinny(x, w)
    _gpu_close(got, sta_gemm_ref(x, w), torch.float32)
    assert torch.equal(got[:8], sta_gemm_skinny(x[:8].contiguous(), w))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 24])
def test_gpu_head_sample_fused_at_152064(cuda, m):
    """The fused sampling head at qwen's head (K 5120, N 152064): scores
    within the f32 tolerance of the plain version, indices equal where the
    top-2 margin decides them; temperature-0 rows equal the skinny head's
    argmax."""
    from repro_torch.kernels.sample import (head_sample_fused,
                                            head_sample_fused_ref,
                                            sample_scores)
    k, n = 5120, 152064
    h, w, counts, rows = _head_sample_case(cuda, m, k, n, m + 7)
    got_s, got_i = head_sample_fused(h, w, counts, *rows)
    torch.cuda.synchronize()
    want_s, want_i = head_sample_fused_ref(h, w, counts, *rows)
    tol = 1e-5 * max(want_s.abs().max().item(), 1.0)
    torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=tol)
    temp, rep, pres, freq, seed_, step = (a[:, None] for a in rows)
    scores = sample_scores(h @ w, counts, temp, rep, pres, freq, seed_, step,
                           torch.arange(n, device=cuda)[None, :])
    top2 = scores.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * tol
    assert bool((got_i == want_i)[decided].all())
    assert int(decided.sum()) >= m - 1


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "yi-34b", "starcoder2-15b"])
def test_gpu_family_generate_kernel_route_matches_plain_route(cuda, arch):
    """Smoke-width f32 qwen2.5-14b, yi-34b and starcoder2-15b (starcoder2
    with an 8-token window), packed, with seeded norm scales and biases and
    QKV biases: greedy generate and packed serve on the kernel route give
    the plain route's tokens, and every layer GEMM launches a DBB kernel
    (7 a layer gated, 6 not, each forward)."""
    from repro_torch.configs import get_config
    from repro_torch.core.dbb_linear import pack_tree
    from repro_torch.core.sparsity import apply_dbb_to_tree
    from repro_torch.kernels.common import reset_launches
    from repro_torch.models import registry
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config(arch, smoke=True).replace(remat="none",
                                               gemm_impl="pallas")
    if arch == "starcoder2-15b":
        cfg = cfg.replace(sliding_window=8)
    params = registry.init_params(cfg, seed=0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    params["embed"]["table"] *= 0.1
    lay = params["layers"]
    for name in ("ln_attn", "ln_mlp"):
        for key, leaf in lay[name].items():
            noise = 0.2 * torch.randn(leaf.shape, generator=gen, device=cuda)
            leaf.copy_(noise + (1.0 if key == "scale" else 0.0))
    for proj in ("q_proj", "k_proj", "v_proj"):
        if "b" in lay["attn"][proj]:
            b = lay["attn"][proj]["b"]
            b.copy_(0.2 * torch.randn(b.shape, generator=gen, device=cuda))
    for part in ("attn", "mlp"):
        for sub in lay[part].values():
            sub["w"] *= 3.0
    packed = pack_tree(apply_dbb_to_tree(params, cfg.dbb), cfg.dbb)
    r = np.random.default_rng(5)
    ps = [list(map(int, r.integers(2, 512, n))) for n in (12, 7, 40, 9)]
    eng = ServeEngine(cfg, packed, max_batch=4, device=cuda)
    reset_launches()
    out = eng.generate(ps, max_new_tokens=8)
    per_pass = (7 if cfg.mlp_gated else 6) * cfg.num_layers
    assert LAUNCHES["dbb_gemm"] == per_pass
    assert LAUNCHES["dbb_gemm_skinny"] == per_pass * eng.last_decode_steps
    xcfg = cfg.replace(gemm_impl="xla")
    assert out == ServeEngine(xcfg, packed, max_batch=4,
                              device=cuda).generate(ps, max_new_tokens=8)
    served = eng.serve(ps, max_new_tokens=[8, 5, 3, 6])
    assert served == ServeEngine(xcfg, packed, max_batch=4,
                                 device=cuda).serve(
                                     ps, max_new_tokens=[8, 5, 3, 6])


# ---------------------------------------------------------------------------
# the analysis package's kernel-route checks at edge shapes
# ---------------------------------------------------------------------------

def _analysis_clean(cuda, name, cases):
    from repro_torch.analysis import materialize as M
    chk = M.MaterializationCheck(name, "edge shapes", lambda dev: cases,
                                 needs_card=True)
    n, violations, rows = M.run_checks([chk], cuda)
    assert n == 1 and len(rows) == len(cases)
    assert not violations, [(v.subject, v.code, v.message)
                            for v in violations]
    return rows


@pytest.mark.gpu
def test_gpu_analysis_flash_at_ragged_edges(cuda):
    """No score tensor at T = S = 1000 (ragged tiles) on both bodies: the
    allocator's peak is the output and the front door's index vectors."""
    from repro_torch.analysis.materialize import _attn_case
    cases = [_attn_case(cuda, "flash", 3, 1000, 6, 2, 64, torch.bfloat16),
             _attn_case(cuda, "flash", 3, 1000, 6, 2, 72, torch.float32)]
    _analysis_clean(cuda, "attn-no-score-tensor", cases)


@pytest.mark.gpu
def test_gpu_analysis_dbb_at_ragged_edges(cuda):
    """No dense [K, N] (nor w4's slot plane) at M 13 and 300, N 200 off the
    tile, on every plane and both activation dtypes; the skinny split-K
    workspace is the Python rule's and the library's."""
    from repro_torch.analysis.materialize import _dbb_no_dense
    rows = _analysis_clean(cuda, "dbb-no-dense-weight",
                           _dbb_no_dense(cuda, (300, 13), 1280, 200))
    assert all(r["requested_peak"] <= r["allowed_bytes"] for r in rows)


@pytest.mark.gpu
def test_gpu_analysis_decode_head_and_conv_at_edges(cuda):
    """paged decode at G 7, page 16 (f32 and bf16), the sampling head at
    M 5, N 4224 (the cluster edge) and the convs on a 15x17 image of 16
    channels: no gathered K/V, no logits, no im2col."""
    from repro_torch.analysis import materialize as M
    _analysis_clean(cuda, "decode-no-gathered-kv", M._decode_no_gather(
        cuda, ((3, 2, 7, 128, 400, 16, torch.float32),
               (3, 2, 7, 128, 400, 16, torch.bfloat16))))
    _analysis_clean(cuda, "head-no-logits",
                    [M._head_no_logits(cuda, 5, 1024, 4224)])
    _analysis_clean(cuda, "conv-no-im2col", M._conv_no_im2col(
        cuda, dict(b=3, h=15, w=17, c=16, n=40, k=3)))


@pytest.mark.gpu
def test_gpu_analysis_workspace_and_smem_on_the_card(cuda):
    """Every Python split count equals the library's at the checks' shapes;
    every shared-memory contract fits the card's opt-in limit with
    ptxas's static bytes added."""
    from repro_torch.analysis import lint, smem
    from repro_torch.kernels import build
    n, v, rows = lint.workspace_pass(cuda)
    assert not v and any("library" in r for r in rows)
    build.build()
    assert smem.optin_limit() == smem.SMEM_LIMIT
    cs = smem.contracts()
    static, missing = smem.with_static(cs, smem.static_smem(build.BUILD_DIR))
    assert not missing
    _, v = smem.check_contracts(cs, static, smem.optin_limit())
    assert not v, [(x.subject, x.message) for x in v]
