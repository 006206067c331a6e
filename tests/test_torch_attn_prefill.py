"""The plain versions of the two flash prefill kernels against the JAX
package's Pallas kernels (interpret mode, as the reference's own tests run
them), and the attention routes the port picks against the reference's.

Same numpy-seeded inputs on both sides; f32, rtol = atol = 1e-5 (the two
sum in different orders). Query rows that see no key (below a left-padded
row's ``start``) are garbage by contract — the Pallas kernel averages its
masked tile, the quadratic version all S keys — and are left out.
tests/test_torch_gpu.py holds each CUDA kernel against its plain version
on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jd
from repro.kernels.attn.ops import flash_attention as jflash
from repro.kernels.attn.ops import packed_flash_attention as jpacked
from repro_torch.kernels import dispatch as td
from repro_torch.kernels.attn import (flash_attention, flash_prefill_ref,
                                      packed_flash_attention,
                                      packed_prefill_ref)
from repro_torch.kernels.common import LAUNCHES

from test_torch_fixtures import configs

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _operands(b, t, s, hq, hkv, d, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, t, hq, d)).astype(np.float32),
            r.standard_normal((b, s, hkv, d)).astype(np.float32),
            r.standard_normal((b, s, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("start,q_offset,window,softcap", [
    ((0, 0), (0, 0), 0, 0.0),            # plain causal, T < S
    ((0, 11), (0, 0), 0, 0.0),           # a left-padded row
    ((3, 0), (8, 5), 0, 0.0),            # chunk continuation offsets
    ((0, 6), (4, 0), 7, 0.0),            # sliding window
    ((2, 9), (0, 8), 0, 30.0),           # logit softcap
])
def test_flash_prefill_plain_matches_pallas(start, q_offset, window,
                                            softcap):
    b, t, s, hq, hkv, d = 2, 40, 48, 4, 2, 32
    q, k, v = _operands(b, t, s, hq, hkv, d, seed=sum(start) + window)
    st, qo = np.asarray(start, np.int32), np.asarray(q_offset, np.int32)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(st), q_offset=jnp.asarray(qo),
                             window=window, softcap=softcap,
                             block_q=8, block_kv=16))
    before = dict(LAUNCHES)
    got = flash_attention(*map(torch.from_numpy, (q, k, v, st)),
                          q_offset=torch.from_numpy(qo), window=window,
                          softcap=softcap).numpy()
    assert LAUNCHES == before              # the CPU path launches nothing
    real = (np.arange(t)[None, :] + qo[:, None]) >= st[:, None]   # [B, T]
    np.testing.assert_allclose(got[real], want[real], **TOL)
    # the wrapper is the plain version in the reference's head-major layout
    ref = flash_prefill_ref(
        *(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)),
        torch.from_numpy(st), torch.from_numpy(qo), sm_scale=d ** -0.5,
        window=window, softcap=softcap).transpose(1, 2).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("lens,window,softcap", [
    ((13, 11, 9), 0, 0.0),   # 8-blocks: [8,16) sees a tile of segment 0 only
    ((5, 20, 6), 4, 0.0),
    ((17, 3, 12), 0, 25.0),
])
def test_packed_prefill_plain_matches_pallas(lens, window, softcap):
    """Three segments plus bucket padding (id n_items, as serve labels
    it). With 8-wide blocks the first computed KV tile of a query tile
    can hold only an earlier segment for some of its rows — the case the
    probability mask keeps exact."""
    t, hq, hkv, d = 40, 4, 2, 32
    q, k, v = (a[0] for a in _operands(1, t, t, hq, hkv, d, seed=sum(lens)))
    seg = np.full((t,), len(lens), np.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[off:off + n] = i
        off += n
    want = np.asarray(jpacked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(seg), window=window,
                              softcap=softcap, block_q=8, block_kv=8))
    got = packed_flash_attention(*map(torch.from_numpy, (q, k, v, seg)),
                                 window=window, softcap=softcap).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    ref = packed_prefill_ref(
        *(torch.from_numpy(a).transpose(0, 1) for a in (q, k, v)),
        torch.from_numpy(seg), sm_scale=d ** -0.5, window=window,
        softcap=softcap).transpose(0, 1).numpy()
    np.testing.assert_array_equal(got, ref)


def test_packed_equals_each_segment_alone():
    """A packed batch attends like each request prefilled by itself."""
    hq, hkv, d = 4, 4, 16
    lens = (7, 12, 5)
    t = sum(lens)
    q, k, v = (torch.from_numpy(a[0]) for a in _operands(1, t, t, hq, hkv, d,
                                                         seed=3))
    seg = torch.repeat_interleave(torch.arange(3, dtype=torch.int32),
                                  torch.tensor(lens))
    got = packed_flash_attention(q, k, v, seg)
    off = 0
    for n in lens:
        sl = slice(off, off + n)
        solo = flash_attention(q[None, sl].contiguous(),
                               k[None, sl].contiguous(),
                               v[None, sl].contiguous())[0]
        torch.testing.assert_close(got[sl], solo, rtol=1e-6, atol=1e-6)
        off += n


def test_prefill_wrappers_raise_on_what_the_kernels_do_not_take():
    q, k, v = (torch.from_numpy(a) for a in _operands(1, 8, 8, 3, 2, 16, 0))
    with pytest.raises(ValueError):
        flash_attention(q, k, v)                        # Hq % Hkv != 0
    q4 = torch.zeros(1, 8, 4, 16)
    with pytest.raises(TypeError):
        flash_attention(q4.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        flash_attention(q4, k[:, :, :, ::2], v[:, :, :, ::2])   # strided
    with pytest.raises(TypeError):
        packed_flash_attention(q4[0], k[0], v[0],
                               torch.zeros(8, dtype=torch.int64))


def _attn_spec_pair(jcfg, tcfg, *, t, s, d, packed=False, ragged=False):
    return (jd.OpSpec(domain="attention", m=t, k=d, n=s, ragged=ragged,
                      packed_seq=packed, chunk=jcfg.attn_chunk, itemsize=4,
                      out_itemsize=4,
                      flash_active=jd.flash_backend_active(jcfg)),
            td.OpSpec(domain="attention", m=t, k=d, n=s, packed_seq=packed,
                      flash_active=td.flash_backend_active(tcfg)))


@pytest.mark.parametrize("gemm_impl", ["pallas", "xla"])
@pytest.mark.parametrize("pin", [False, True])
@pytest.mark.parametrize("t,s,packed,ragged", [
    (6, 6, False, False), (6, 6, False, True), (40, 40, True, False),
    (8, 48, False, True)])
def test_attention_routes_match_reference(gemm_impl, pin, t, s, packed,
                                          ragged):
    """Unpinned, the flash kernels wherever the reference takes its Pallas
    ones; pinned (or on the plain route), the naive / packed plain
    versions. Packed calls map a padded pin to its packed variant."""
    jcfg, tcfg = configs(gemm_impl, pin=pin)
    jspec, tspec = _attn_spec_pair(jcfg, tcfg, t=t, s=s, d=32,
                                   packed=packed, ragged=ragged)
    routes = dict(jd.routes_from_cfg(jcfg))
    if packed and routes.get("attention") in jd._ATTN_TO_PACKED:
        routes["attention"] = jd._ATTN_TO_PACKED[routes["attention"]]
    want, _ = jd.select(jspec, routes)
    got, _ = td.select(tspec, routes)
    assert got == want
    if gemm_impl == "pallas" and not pin:
        assert got == ("attn_packed_flash" if packed else "attn_flash")
    else:
        assert got == ("attn_packed_ref" if packed else "attn_naive")


@pytest.mark.parametrize("attn_impl,want", [
    ("auto", "attn_flash"), ("flash", "attn_flash"),
    ("naive", "attn_naive"), ("chunked", "attn_naive")])
def test_chunk_continuation_route_matches_reference(attn_impl, want):
    jcfg, tcfg = configs(attn_impl=attn_impl)
    got = td.chunk_attention_route(tcfg, t=8, s=48, d=32)
    assert got == want == jd.chunk_attention_route(jcfg, t=8, s=48, d=32,
                                                   itemsize=4)


@pytest.mark.parametrize("front_door", ["select", "chunk_continuation"])
def test_chunked_pin_warns_and_takes_naive(front_door):
    """A pin to attn_chunked where it cannot run takes attn_naive, as in
    the reference: through `select` on a call its guard refuses (S = 6 not
    a multiple of the chunk, no flash backend) with the reference's "not
    applicable" warning; on a chunked-prefill continuation, which has no
    chunked route, without a warning (the reference's continuation maps
    the pin to naive)."""
    import warnings
    jcfg, tcfg = configs(kernel_routes=(("attention", "attn_chunked"),))
    td._warned.discard(("attention", "attn_chunked"))
    if front_door == "select":
        spec = td.OpSpec(domain="attention", m=6, k=32, n=6,
                         flash_active=False)
        with pytest.warns(UserWarning, match="not applicable"):
            name, _ = td.select(spec, td.routes_from_cfg(tcfg))
        jspec = jd.OpSpec(domain="attention", m=6, k=32, n=6, itemsize=4,
                          out_itemsize=4, flash_active=False)
        jd._warned_forced.discard(("attention", "attn_chunked"))
        with pytest.warns(UserWarning, match="not applicable"):
            assert name == jd.select(jspec, jd.routes_from_cfg(jcfg))[0]
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            name = td.chunk_attention_route(tcfg, t=8, s=48, d=32)
        assert name == jd.chunk_attention_route(jcfg, t=8, s=48, d=32,
                                                itemsize=4)
    assert name == "attn_naive"
