"""The dense_lm family's packed prefill and chunked-prefill continuation
against the reference (qwen2.5-14b, yi-34b, starcoder2-15b at smoke width
in f32, the same packed weights as tests/test_torch_dense_family.py), on
both routes (``gemm_impl`` "pallas": the Pallas kernels in interpret mode
against the port's wrappers' plain versions; "xla"), on the contiguous
cache; tests/test_torch_dense_family_verify.py runs the page pool's case
and `verify_step`. Hidden states and cache contents within atol 1e-4 (rtol
1e-4), as tests/test_torch_model.py holds olmo-1b.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dense_family import ARCHS, TOL, trees
from test_torch_fixtures import configs
from repro.models import registry as jreg
from repro_torch.models import registry as treg

torch.set_num_threads(1)


def _packed_batch(lens, tp, pad_row, addr):
    """Packed tokens of requests ``lens`` in a ``tp`` bucket, with serve's
    metadata: seg ids (pad = n_items), positions, scatter rows/cols."""
    rng = np.random.default_rng(sum(lens))
    toks = np.zeros((1, tp), np.int32)
    seg = np.full((tp,), len(lens), np.int32)
    pos = np.zeros((1, tp), np.int32)
    rows = np.full((tp,), pad_row, np.int32)
    cols = np.zeros((tp,), np.int32)
    off = 0
    for i, n in enumerate(lens):
        toks[0, off:off + n] = rng.integers(2, 512, n)
        seg[off:off + n] = i
        pos[0, off:off + n] = np.arange(n)
        rows[off:off + n], cols[off:off + n] = addr(i, np.arange(n))
        off += n
    return toks, seg, pos, rows, cols


@pytest.mark.parametrize("gemm_impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", ARCHS)
def test_packed_prefill_and_continuation_match_reference(arch, gemm_impl):
    """On the contiguous cache (slots 1..3); the page pool's case is in
    tests/test_torch_dense_family_verify.py."""
    packed_case(arch, gemm_impl, paged=False)


def packed_case(arch, gemm_impl, paged):
    """prefill_packed of three requests into a contiguous cache (slots
    1..3) or a page pool (pages in shuffled order), then one
    prefill_continue chunk of request 0 and two decode steps."""
    jcfg, tcfg = configs(gemm_impl, arch=arch)
    jp, tp = trees(arch)
    lens, smax, page = (5, 3, 6), 16, 8
    n_log = smax // page
    table = np.array([[7, 2], [5, 4], [1, 6], [3, 8]], np.int32)
    if paged:
        from repro.serve.kv_cache import init_paged_cache as jinit
        from repro_torch.serve.kv_cache import init_paged_cache as tinit
        jcache = jinit(jcfg, 4, 9, page, n_log)
        tcache = tinit(tcfg, 4, 9, page, n_log, device="cpu")

        def addr(i, p):
            return table[i][p // page], p % page
        pad_row, kv_sel = 9, table[0]
    else:
        jcache = jreg.init_cache(jcfg, 4, smax)
        tcache = treg.init_cache(tcfg, 4, smax, device="cpu")

        def addr(i, p):
            return np.full(p.shape, i, np.int32), p
        pad_row, kv_sel = 4, 0
    toks, seg, pos, rows, cols = _packed_batch(lens, 16, pad_row, addr)
    jh, jcache = jreg.prefill_packed(jp, jcfg, *map(jnp.asarray, (
        toks, seg, pos, rows, cols)), jcache)
    th, tcache = treg.prefill_packed(tp, tcfg, *map(torch.from_numpy, (
        toks, seg, pos, rows, cols)), tcache)
    real = seg < len(lens)
    np.testing.assert_allclose(th.numpy()[0, real], np.asarray(jh)[0, real],
                               **TOL)
    kk = "k_pages" if paged else "k"
    np.testing.assert_allclose(tcache[kk].numpy(), np.asarray(jcache[kk]),
                               **TOL)

    # request 0 continues with 4 more tokens at slots 5..8 (bucket 8)
    c_toks = np.zeros((1, 8), np.int32)
    c_toks[0, :4] = [11, 12, 13, 14]
    c_pos = 5 + np.arange(8, dtype=np.int32)[None]
    c_rows = np.full((8,), pad_row, np.int32)
    c_cols = np.zeros((8,), np.int32)
    c_rows[:4], c_cols[:4] = addr(0, np.arange(5, 9))
    jsel = jnp.asarray(kv_sel) if paged else jnp.int32(kv_sel)
    jh, jcache = jreg.prefill_continue(jp, jcfg, *map(jnp.asarray, (
        c_toks, c_pos, c_rows, c_cols)), jsel, jcache)
    tsel = torch.from_numpy(kv_sel) if paged else kv_sel
    th, tcache = treg.prefill_continue(tp, tcfg, *map(torch.from_numpy, (
        c_toks, c_pos, c_rows, c_cols)), tsel, tcache)
    np.testing.assert_allclose(th.numpy()[:, :4], np.asarray(jh)[:, :4],
                               **TOL)

    lengths = np.array([9, 3, 6, 0], np.int32)
    for cache, lib in ((jcache, jnp.asarray), (tcache, torch.from_numpy)):
        cache["length"] = lib(lengths)
        cache["start"] = lib(np.zeros(4, np.int32))
        if paged:
            cache["block_table"] = lib(table.copy())
    nxt = np.array([20, 21, 22, 23], np.int32)
    for step in range(2):
        jh, jcache = jreg.decode_step(jp, jcfg, jnp.asarray(nxt + step),
                                      jcache)
        th, tcache = treg.decode_step(tp, tcfg, torch.from_numpy(nxt + step),
                                      tcache)
        np.testing.assert_allclose(th.numpy()[:3], np.asarray(jh)[:3], **TOL)
