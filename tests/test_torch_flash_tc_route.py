"""The route to the tensor-core body of flash_prefill and
flash_prefill_packed, on the CPU.

The CUDA launchers (csrc/flash_prefill.cu, csrc/flash_prefill_packed.cu)
pick one of two bodies by a rule on (dtype, D): the tensor-core body
(csrc/flash_tc.cuh) or the plain-FMA one (csrc/flash_tile.cuh). The
wrappers mirror that rule in ``attn.ops.tc_body`` to count
``flash_prefill_tc`` / ``flash_prefill_packed_tc`` launches and to size the
block's shared memory (``flash_ok``). Here the mirror is held against the
launchers' own source, shown never to read B, T, S or the segments and
never to send f32 to the tensor cores; the shared-memory formula against
the C constants; and the CPU route of the shapes the tensor-core body
takes on the card (bf16, D 128 and 64: T and S off the 64-row tile,
``start`` inside a tile, ``q_offset``, a window, a softcap, GQA g = 2, a
packed segment boundary inside a tile and a pad segment; D 256, which
the body takes on two consumer warpgroups: paligemma's MQA g = 8, a
ragged ``start``, a packed segment edge) against the Pallas kernels in
interpret mode.

Tolerance (bf16 outputs): |got - want| <= 2e-2 |want| + 1e-2 max |want|,
that of the card's bf16 attention tests: the Pallas kernel rounds each
tile's unnormalised probabilities to bf16, the plain version the
normalised ones (up to 2^-9 relative a term), and both round the output
to bf16. Rows that see no key (below a left-padded row's ``start``) are
garbage by contract and left out.

tests/test_torch_gpu.py holds the body itself against the plain versions
on the card.
"""
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attn.ops import flash_attention as jflash
from repro.kernels.attn.ops import packed_flash_attention as jpacked
from repro_torch.kernels import build
from repro_torch.kernels.attn import flash_attention, packed_flash_attention
from repro_torch.kernels.attn.ops import (FLASH_D_MAX, SMEM_LIMIT,
                                          _flash_smem_bytes, flash_ok,
                                          tc_body)
from repro_torch.kernels.common import LAUNCHES

from test_torch_tc_route import _c_rule

torch.set_num_threads(1)
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
LAUNCHERS = ("flash_prefill.cu", "flash_prefill_packed.cu")
DTYPES = (torch.float32, torch.bfloat16, torch.int8)
DS = (1, 8, 16, 32, 63, 64, 65, 72, 96, 120, 127, 128, 129, 192, 256)
BF = torch.bfloat16


def _c_int(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);",
                  (CSRC / source).read_text())
    assert m, f"no {name} in {source}"
    return int(m.group(1))


def _close_bf16(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = 2e-2 * np.abs(want) + 1e-2 * np.abs(want).max()
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


@pytest.mark.parametrize("source", LAUNCHERS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_rule_mirrors_the_launcher(source, dtype):
    params, rule = _c_rule(source)
    assert params == ["dtype", "D"]
    code = build.dtype_code(dtype)
    for d in DS:
        assert tc_body(dtype, d) == rule(dtype=code, D=d), (dtype, d)


def test_rules_never_read_b_t_s_or_segments():
    """The body a row runs on must not depend on how many rows, keys or
    requests share the call (serve's packed, chunked and padded
    prefills): neither rule has one to read, in Python or in C."""
    assert list(inspect.signature(tc_body).parameters) == ["dtype", "d"]
    for source in LAUNCHERS:
        params, _ = _c_rule(source)
        assert params == ["dtype", "D"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8], ids=str)
def test_f32_never_takes_the_tensor_cores(dtype):
    assert not any(tc_body(dtype, d) for d in DS)
    for source in LAUNCHERS:
        _, rule = _c_rule(source)
        assert not any(rule(dtype=build.dtype_code(dtype), D=d) for d in DS)


@pytest.mark.parametrize("d,want", [(64, True), (128, True), (72, False),
                                    (32, False), (96, False), (192, False),
                                    (256, True), (320, False), (0, False)])
def test_bf16_takes_the_tensor_cores_at_d_64_and_128(d, want):
    assert tc_body(BF, d) is want


def test_smem_formula_matches_the_c_constants():
    """_flash_smem_bytes mirrors smem_bytes of both bodies: the
    tensor-core body's bf16 Q tile, its kStages K and V tiles, 1 + 3
    kStages barriers and 1024 bytes of alignment slack; the FMA body's f32
    Qᵀ, Kᵀ (later P) and V."""
    bq = _c_int("flash_tile.cuh", "kBQ")
    bkv = _c_int("flash_tile.cuh", "kBKV")
    stages = _c_int("flash_tc.cuh", "kStages")
    tc_src = (CSRC / "flash_tc.cuh").read_text()
    assert "constexpr int kBarriers = 1 + 3 * kStages;" in tc_src
    for d in (64, 128, 256):
        want = 2 * bq * d + 2 * stages * 2 * bkv * d + 8 * (1 + 3 * stages) \
            + 1024
        assert _flash_smem_bytes(d, BF) == want
    assert _flash_smem_bytes(128, BF) == 83000     # two blocks an SM
    assert _flash_smem_bytes(256, BF) == 164920    # one block an SM
    assert 2 * _flash_smem_bytes(128, BF) + 2048 <= SMEM_LIMIT
    for d in (1, 64, 72, 128):
        for dt in (torch.float32,) + (() if tc_body(BF, d) else (BF,)):
            assert _flash_smem_bytes(d, dt) == 4 * (
                d * (bq + 1) + max(d, bq) * (bkv + 1) + bkv * d)


@pytest.mark.parametrize("d", [1, 63, 64, 72, 128])
@pytest.mark.parametrize("dtype", [torch.float32, BF, None], ids=str)
def test_flash_ok_takes_every_d_up_to_128_in_either_body(d, dtype):
    assert flash_ok(d, dtype)
    assert _flash_smem_bytes(d, dtype or BF) <= SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.float32, BF, None], ids=str)
def test_flash_ok_refuses_d_outside_the_bodies(dtype):
    assert not flash_ok(0, dtype)
    assert not flash_ok(FLASH_D_MAX + 1, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, BF, None],
                         ids=str)
def test_flash_ok_takes_d_256_in_every_float_dtype(dtype):
    """paligemma's head dim: the reference's flash kernels take it (its
    flash_ok asks only that the smallest block pair fits VMEM), so the
    port's do too — bf16 on the tensor-core body (164,920 bytes), f32 and
    f16 on the FMA body with 32 output columns a thread (198,656 bytes).
    The FMA body's D limit is the C constant kDMax."""
    from repro.kernels.attn.ops import flash_ok as ref_flash_ok
    assert FLASH_D_MAX == _c_int("flash_tile.cuh", "kDMax") == 256
    assert flash_ok(256, dtype) and flash_ok(192, dtype)
    assert ref_flash_ok(512, 512, 256, 2) and ref_flash_ok(512, 512, 256, 4)
    assert _flash_smem_bytes(256, torch.float32) == 198656 <= SMEM_LIMIT


def test_flash_ok_reports_the_body_the_call_takes():
    """At D 128 a bf16 call takes the tensor-core body's 83,000 bytes, an
    f32 call the FMA body's 99,328; at D 72 both take the FMA body."""
    assert _flash_smem_bytes(128, BF) < _flash_smem_bytes(128, torch.float32)
    assert _flash_smem_bytes(72, BF) == _flash_smem_bytes(72, torch.float32)


def _bf16_operands(b, t, s, hq, hkv, d, seed):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal(shape).astype(np.float32)
                 for shape in ((b, t, hq, d), (b, s, hkv, d), (b, s, hkv, d)))


@pytest.mark.parametrize("b,t,s,hq,hkv,d,start,q_offset,window,softcap", [
    (2, 77, 77, 2, 2, 128, (0, 37), (0, 0), 0, 0.0),     # start mid-tile
    (2, 50, 190, 4, 2, 64, (5, 0), (120, 64), 0, 0.0),   # chunk, g 2, D 64
    (1, 130, 130, 2, 1, 128, (3,), (0,), 33, 20.0),      # window, softcap
    (1, 65, 129, 2, 2, 128, (70,), (64,), 0, 0.0),       # start past row 0
])
def test_flash_prefill_bf16_cpu_route_matches_pallas(b, t, s, hq, hkv, d,
                                                     start, q_offset, window,
                                                     softcap):
    """Shapes the card runs on the tensor-core body, held against the
    Pallas kernel (64 x 64 blocks, as the body's tiles) in interpret
    mode."""
    assert tc_body(BF, d)
    q, k, v = _bf16_operands(b, t, s, hq, hkv, d, seed=t + s + d)
    st, qo = np.asarray(start, np.int32), np.asarray(q_offset, np.int32)
    want = jflash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                  jnp.asarray(st), q_offset=jnp.asarray(qo), window=window,
                  softcap=softcap, block_q=64, block_kv=64)
    before = dict(LAUNCHES)
    got = flash_attention(*(torch.from_numpy(a).to(BF) for a in (q, k, v)),
                          torch.from_numpy(st), q_offset=torch.from_numpy(qo),
                          window=window, softcap=softcap)
    assert LAUNCHES == before              # the CPU path launches nothing
    assert got.dtype == BF
    real = (np.arange(t)[None, :] + qo[:, None]) >= st[:, None]   # [B, T]
    _close_bf16(got.float().numpy()[real],
                np.asarray(want.astype(jnp.float32))[real])


@pytest.mark.parametrize("lens,pad,hq,hkv,d,window,softcap", [
    ((70, 90, 7, 150), 45, 4, 2, 128, 0, 0.0),   # tile [64,128) meets seg 1
    ((100, 7, 150, 40), 36, 2, 2, 64, 50, 30.0),
    ((1, 1, 130), 12, 2, 1, 128, 0, 0.0),
])
def test_packed_prefill_bf16_cpu_route_matches_pallas(lens, pad, hq, hkv, d,
                                                      window, softcap):
    """Segment boundaries inside the 64-row tiles and a pad segment (id
    len(lens), as serve labels the bucket's tail)."""
    assert tc_body(BF, d)
    t = sum(lens) + pad
    q, k, v = (a[0] for a in _bf16_operands(1, t, t, hq, hkv, d,
                                            seed=t + d))
    seg = np.repeat(np.arange(len(lens) + 1, dtype=np.int32),
                    list(lens) + [pad])
    want = jpacked(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                   jnp.asarray(seg), window=window, softcap=softcap,
                   block_q=64, block_kv=64)
    before = dict(LAUNCHES)
    got = packed_flash_attention(
        *(torch.from_numpy(a).to(BF) for a in (q, k, v)),
        torch.from_numpy(seg), window=window, softcap=softcap)
    assert LAUNCHES == before
    assert got.dtype == BF
    real = seg < len(lens)       # the pad segment's rows are never read
    _close_bf16(got.float().numpy()[real],
                np.asarray(want.astype(jnp.float32))[real])


@pytest.mark.parametrize("b,t,s,hq,hkv,start,q_offset", [
    (1, 130, 130, 8, 1, (0,), (0,)),              # MQA g 8, T off the tile
    (2, 70, 70, 8, 1, (0, 23), (0, 0)),           # a ragged start
    (1, 40, 150, 4, 1, (3,), (110,)),             # a continuation chunk
])
def test_flash_prefill_bf16_d256_cpu_route_matches_pallas(b, t, s, hq, hkv,
                                                          start, q_offset):
    """paligemma's head dim on the route the card runs on the tensor-core
    body's two warpgroups, held against the Pallas kernel (64 x 64
    blocks)."""
    d = 256
    assert tc_body(BF, d) and flash_ok(d, BF)
    q, k, v = _bf16_operands(b, t, s, hq, hkv, d, seed=t + s + d)
    st, qo = np.asarray(start, np.int32), np.asarray(q_offset, np.int32)
    want = jflash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                  jnp.asarray(st), q_offset=jnp.asarray(qo),
                  block_q=64, block_kv=64)
    before = dict(LAUNCHES)
    got = flash_attention(*(torch.from_numpy(a).to(BF) for a in (q, k, v)),
                          torch.from_numpy(st), q_offset=torch.from_numpy(qo))
    assert LAUNCHES == before
    real = (np.arange(t)[None, :] + qo[:, None]) >= st[:, None]
    _close_bf16(got.float().numpy()[real],
                np.asarray(want.astype(jnp.float32))[real])


@pytest.mark.parametrize("lens,pad,hq,hkv", [
    ((70, 90, 7), 25, 8, 1),     # segment edges inside the 64-row tiles
    ((1, 64, 3), 4, 2, 1),       # an edge on a tile boundary
])
def test_packed_prefill_bf16_d256_cpu_route_matches_pallas(lens, pad, hq,
                                                           hkv):
    d = 256
    assert tc_body(BF, d)
    t = sum(lens) + pad
    q, k, v = (a[0] for a in _bf16_operands(1, t, t, hq, hkv, d,
                                            seed=t + d))
    seg = np.repeat(np.arange(len(lens) + 1, dtype=np.int32),
                    list(lens) + [pad])
    want = jpacked(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                   jnp.asarray(seg), block_q=64, block_kv=64)
    before = dict(LAUNCHES)
    got = packed_flash_attention(
        *(torch.from_numpy(a).to(BF) for a in (q, k, v)),
        torch.from_numpy(seg))
    assert LAUNCHES == before
    real = seg < len(lens)
    _close_bf16(got.float().numpy()[real],
                np.asarray(want.astype(jnp.float32))[real])
