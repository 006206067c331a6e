"""The port's `prefill`, `prefill_packed`, `prefill_continue` and
`decode_step` (contiguous and paged caches) against the reference's, at
smoke width in f32, on the same packed weights. Both routes:
``gemm_impl="pallas"`` (the reference's Pallas kernels in interpret mode
against the port's kernel wrappers, which run their plain versions on the
CPU) and ``"xla"``; prefill attention pinned to the naive route, and
unpinned (the flash kernels under "pallas").

Tolerances: hidden states and cache contents atol 1e-4 (rtol 1e-4). On
the flash route a left-padded row's pad positions are garbage by contract
(the Pallas kernel and the plain version fill them differently), so there
only real positions and the cache slots real rows read are compared.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fixtures import configs, packed_params
from repro.models import registry as jreg
from repro_torch.models import registry as treg

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def params():
    return packed_params()


def _inputs(ragged: bool):
    rng = np.random.default_rng(3)
    b, s = 8, 6
    tokens = rng.integers(2, 512, (b, s)).astype(np.int32)
    start = np.zeros(b, np.int32)
    if ragged:
        start = np.array([0, 2, 5, 1, 0, 3, 4, 0], np.int32)
        for i in range(b):
            tokens[i, :start[i]] = 0
    nxt = rng.integers(2, 512, b).astype(np.int32)
    return tokens, (start if ragged else None), nxt


def _prefill_and_decode(params, gemm_impl, ragged, pin):
    jcfg, tcfg = configs(gemm_impl, pin=pin)
    jp, tp = params
    tokens, start, nxt = _inputs(ragged)
    total = tokens.shape[1] + 2
    # positions real rows produce and read: all of them unless the flash
    # route fills pad positions with its own garbage
    real = np.ones((8, total), bool)
    if start is not None and not pin and gemm_impl == "pallas":
        real = np.arange(total)[None, :] >= start[:, None]
    s = tokens.shape[1]
    jcache = jreg.init_cache(jcfg, 8, total)
    jh, jcache = jreg.prefill(
        jp, jcfg, tokens=jnp.asarray(tokens), cache=jcache,
        start=None if start is None else jnp.asarray(start))
    tcache = treg.init_cache(tcfg, 8, total, device="cpu")
    th, tcache = treg.prefill(
        tp, tcfg, torch.from_numpy(tokens), tcache,
        start=None if start is None else torch.from_numpy(start))
    np.testing.assert_allclose(th.numpy()[real[:, :s]],
                               np.asarray(jh)[real[:, :s]], **TOL)
    np.testing.assert_allclose(tcache["k"].numpy()[:, real],
                               np.asarray(jcache["k"])[:, real], **TOL)
    np.testing.assert_array_equal(tcache["length"].numpy(),
                                  np.asarray(jcache["length"]))

    for step in range(2):
        jh, jcache = jreg.decode_step(jp, jcfg, jnp.asarray(nxt + step),
                                      jcache)
        th, tcache = treg.decode_step(tp, tcfg, torch.from_numpy(nxt + step),
                                      tcache)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tcache["v"].numpy()[:, real],
                               np.asarray(jcache["v"])[:, real], **TOL)


@pytest.mark.parametrize("gemm_impl", ["pallas", "xla"])
@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_and_decode_match_reference(params, gemm_impl, ragged):
    """Attention pinned to the naive route: every position compared."""
    _prefill_and_decode(params, gemm_impl, ragged, pin=True)


@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_and_decode_match_reference_unpinned(params, ragged):
    """Unpinned: the flash prefill route (the plain route is the pinned
    test's naive one)."""
    _prefill_and_decode(params, "pallas", ragged, pin=False)


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


@pytest.mark.parametrize("paged", [False, True])
def test_packed_prefill_and_continuation_match_reference(params, paged):
    """prefill_packed of three requests into a contiguous cache (slots
    1..3) or a page pool (pages in shuffled order), then one
    prefill_continue chunk of request 0 and two decode steps."""
    jcfg, tcfg = configs()
    jp, tp = params
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


def test_init_params_tree_matches_reference_layout():
    """The port's own seeded init builds the reference's tree: same keys,
    shapes and dtypes."""
    import jax

    from repro.models import registry
    jcfg, tcfg = configs()
    jt = jax.eval_shape(lambda k: registry.init_params(k, jcfg),
                        jax.random.PRNGKey(0))
    tt = treg.init_params(tcfg, seed=0, device="cpu")

    def walk(j, t, path=""):
        assert isinstance(t, dict) == isinstance(j, dict), path
        if isinstance(j, dict):
            assert set(j) == set(t), path
            for k in j:
                walk(j[k], t[k], f"{path}/{k}")
        else:
            assert tuple(t.shape) == tuple(j.shape), path
            assert str(t.dtype).split(".")[-1] == str(j.dtype), path
    walk(jt, tt)
    # fan-in scales as in the reference
    wi = tt["layers"]["mlp"]["wi"]["w"]
    assert abs(wi.std().item() * tcfg.d_model ** 0.5 - 1.0) < 0.05
