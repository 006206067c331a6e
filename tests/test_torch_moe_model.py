"""The moe_lm family's model entry points against the reference, at smoke
width in f32: arctic-480b smoke (top-2 of 8 experts, the dense residual
MLP) and a kimi-shaped config (top-8 of 32 experts: the batched expert
route), on DBB-packed and dense weights (tests/test_torch_moe.py's
`moe_trees`), on both routes (``gemm_impl="pallas"``: the reference's
Pallas kernels in interpret mode against the port's wrappers' plain
versions, the MoE layers expanded to dense as the reference expands them;
"xla").

`forward` (hidden states and the summed aux loss), `prefill` of a batch
then two `decode_step`s on the contiguous cache and on the same slots as a
shuffled page pool, `prefill_packed` of three requests then a
`prefill_continue` chunk and decode steps, and `verify_step` on both
caches. Each mode routes its own token count against its own capacity, as
the reference's same mode does; on the packed trees the prefill test
checks that some expert overflowed its capacity, so drops are compared
too. Tolerances, as the
dense family's: hidden states and cache contents atol / rtol 1e-4, the aux
loss rtol 1e-5.

Left-padded prefill on the flash route runs with no-drop capacity
(``capacity_factor=16``, as the reference's own prefill-vs-decode test
sets it). A pad query row attends no key, and the flash kernels leave its
output unspecified: the Pallas kernel averages the values of its block's
key tile, the port's plain version the row's S keys. Those rows still
route and take capacity, so under drops a real row's output depends on
them, in the reference too (its flash and plain routes disagree the same
way). Left-padded prefill on the plain route (both packages average the
row's S keys) and unpadded prefill on both routes run at the config's
capacity.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dense_family import paged_copy
from test_torch_dense_family_packed import _packed_batch
from test_torch_moe import moe_cfgs, moe_trees
from repro.models import registry as jreg
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as treg

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
GRID = [(kind, weights, gemm_impl) for kind in ("arctic", "kimi")
        for weights in ("packed", "dense") for gemm_impl in ("pallas", "xla")]


@pytest.mark.parametrize("kind,weights,gemm_impl", GRID)
def test_forward_matches_reference(kind, weights, gemm_impl):
    jcfg, tcfg = moe_cfgs(gemm_impl, kind=kind)
    jp, tp = moe_trees(kind, weights)
    toks = np.random.default_rng(5).integers(2, 512, (2, 9)).astype(np.int32)
    want, jaux = jreg.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, taux = treg.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(taux) > 0.0
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5)


def _overflowed(routes, capacity: int) -> bool:
    """Whether some recorded routing put more pairs on an expert than
    ``capacity``."""
    return any(torch.bincount(i.reshape(-1)).max().item() > capacity
               for i in routes)


@pytest.mark.parametrize("ragged", [True, False])
@pytest.mark.parametrize("kind,weights,gemm_impl", GRID)
def test_prefill_and_decode_match_reference(kind, weights, gemm_impl, ragged,
                                            monkeypatch):
    """Prefill 8 rows of 6 tokens (48 tokens share a capacity; ``ragged``:
    left-padded), then two decode steps (8 tokens) on the contiguous cache
    and on a shuffled pool of 8-slot pages holding the same slots."""
    nodrop = ragged and gemm_impl == "pallas"     # see the module doc
    jcfg, tcfg = moe_cfgs(gemm_impl, kind=kind)
    if nodrop:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                    capacity_factor=16.0))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe,
                                                    capacity_factor=16.0))
    jp, tp = moe_trees(kind, weights)
    rng = np.random.default_rng(3)
    tokens = rng.integers(2, 512, (8, 6)).astype(np.int32)
    start = np.array([0, 2, 5, 1, 0, 3, 4, 0] if ragged else [0] * 8,
                     np.int32)
    for i in range(8):
        tokens[i, :start[i]] = 0
    nxt = rng.integers(2, 512, 8).astype(np.int32)
    real = np.ones((8, 16), bool)
    if gemm_impl == "pallas":        # the flash prefill's pad rows: garbage
        real = np.arange(16)[None, :] >= start[:, None]
    routes = []
    route = tmoe._route

    def recording(x, w, cfg):
        out = route(x, w, cfg)
        routes.append(out[0])
        return out
    monkeypatch.setattr(tmoe, "_route", recording)
    jcache = jreg.init_cache(jcfg, 8, 16)
    jh, jcache = jreg.prefill(jp, jcfg, tokens=jnp.asarray(tokens),
                              cache=jcache,
                              start=jnp.asarray(start) if ragged else None)
    tcache = treg.init_cache(tcfg, 8, 16, device="cpu")
    th, tcache = treg.prefill(tp, tcfg, torch.from_numpy(tokens), tcache,
                              start=(torch.from_numpy(start) if ragged
                                     else None))
    over = _overflowed(routes, tmoe._capacity(48, tcfg))
    if nodrop:
        assert not over
    elif weights == "packed":
        assert over                   # drops happen, and are compared
    np.testing.assert_allclose(th.numpy()[real[:, :6]],
                               np.asarray(jh)[real[:, :6]], **TOL)
    np.testing.assert_allclose(tcache["k"].numpy()[:, real],
                               np.asarray(jcache["k"])[:, real], **TOL)
    pcache = paged_copy(tcache, 8, seed=7)
    for step in range(2):
        jh, jcache = jreg.decode_step(jp, jcfg, jnp.asarray(nxt + step),
                                      jcache)
        th, tcache = treg.decode_step(tp, tcfg, torch.from_numpy(nxt + step),
                                      tcache)
        ph, pcache = treg.decode_step(tp, tcfg, torch.from_numpy(nxt + step),
                                      pcache)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        np.testing.assert_allclose(ph.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tcache["v"].numpy()[:, real],
                               np.asarray(jcache["v"])[:, real], **TOL)


@pytest.mark.parametrize("kind,weights,gemm_impl", GRID)
def test_packed_prefill_continue_and_decode_match_reference(kind, weights,
                                                            gemm_impl):
    """prefill_packed of three requests (one capacity for the 16-token
    pack, padding included) into cache slots 0..2, a 4-token
    prefill_continue chunk of request 0 (bucket 8), then two decode
    steps."""
    jcfg, tcfg = moe_cfgs(gemm_impl, kind=kind)
    jp, tp = moe_trees(kind, weights)
    lens = (5, 3, 6)
    jcache = jreg.init_cache(jcfg, 4, 16)
    tcache = treg.init_cache(tcfg, 4, 16, device="cpu")

    def addr(i, p):
        return np.full(p.shape, i, np.int32), p
    toks, seg, pos, rows, cols = _packed_batch(lens, 16, 4, addr)
    jh, jcache = jreg.prefill_packed(jp, jcfg, *map(jnp.asarray, (
        toks, seg, pos, rows, cols)), jcache)
    th, tcache = treg.prefill_packed(tp, tcfg, *map(torch.from_numpy, (
        toks, seg, pos, rows, cols)), tcache)
    real = seg < len(lens)
    np.testing.assert_allclose(th.numpy()[0, real], np.asarray(jh)[0, real],
                               **TOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               **TOL)
    c_toks = np.zeros((1, 8), np.int32)
    c_toks[0, :4] = [11, 12, 13, 14]
    c_pos = 5 + np.arange(8, dtype=np.int32)[None]
    c_rows = np.full((8,), 4, np.int32)
    c_cols = np.zeros((8,), np.int32)
    c_rows[:4], c_cols[:4] = addr(0, np.arange(5, 9))
    jh, jcache = jreg.prefill_continue(jp, jcfg, *map(jnp.asarray, (
        c_toks, c_pos, c_rows, c_cols)), jnp.int32(0), jcache)
    th, tcache = treg.prefill_continue(tp, tcfg, *map(torch.from_numpy, (
        c_toks, c_pos, c_rows, c_cols)), 0, tcache)
    np.testing.assert_allclose(th.numpy()[:, :4], np.asarray(jh)[:, :4],
                               **TOL)
    lengths = np.array([9, 3, 6, 0], np.int32)
    for cache, lib in ((jcache, jnp.asarray), (tcache, torch.from_numpy)):
        cache["length"] = lib(lengths)
        cache["start"] = lib(np.zeros(4, np.int32))
    nxt = np.array([20, 21, 22, 23], np.int32)
    for step in range(2):
        jh, jcache = jreg.decode_step(jp, jcfg, jnp.asarray(nxt + step),
                                      jcache)
        th, tcache = treg.decode_step(tp, tcfg, torch.from_numpy(nxt + step),
                                      tcache)
        np.testing.assert_allclose(th.numpy()[:3], np.asarray(jh)[:3], **TOL)


@pytest.mark.parametrize("kind,weights,gemm_impl", GRID)
def test_verify_step_matches_reference(kind, weights, gemm_impl):
    """Prefill 4 rows of 5 tokens, then verify 3 candidates a row at
    slots 5..7 (12 tokens share a capacity) on the contiguous cache and on
    a shuffled page pool; ``length`` stays as it was."""
    jcfg, tcfg = moe_cfgs(gemm_impl, kind=kind)
    jp, tp = moe_trees(kind, weights)
    rng = np.random.default_rng(11)
    tokens = rng.integers(2, 512, (4, 5)).astype(np.int32)
    cand = rng.integers(2, 512, (4, 3)).astype(np.int32)
    jcache = jreg.init_cache(jcfg, 4, 16)
    _, jcache = jreg.prefill(jp, jcfg, tokens=jnp.asarray(tokens),
                             cache=jcache)
    tcache = treg.init_cache(tcfg, 4, 16, device="cpu")
    _, tcache = treg.prefill(tp, tcfg, torch.from_numpy(tokens), tcache)
    pcache = paged_copy(tcache, 8, seed=3)
    jh, jcache = jreg.verify_step(jp, jcfg, jnp.asarray(cand), jcache)
    th, tcache = treg.verify_step(tp, tcfg, torch.from_numpy(cand), tcache)
    ph, pcache = treg.verify_step(tp, tcfg, torch.from_numpy(cand), pcache)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tcache["k"].numpy()[:, :, :8],
                               np.asarray(jcache["k"])[:, :, :8], **TOL)
    assert tcache["length"].tolist() == [5] * 4
