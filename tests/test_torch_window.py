"""starcoder2-15b's sliding window against the reference: the smoke config
(which ships with ``sliding_window=0``) with a 4-token window, prompts of
6-12 tokens, so every path masks keys that fell out of the window — prefill
on the flash route (the flash kernels' plain versions against the Pallas
kernels in interpret mode) and on the naive and plain routes, decode on the
contiguous cache and on a shuffled page pool, the packed prefill and the
speculative verify pass; and `forward` with ``window_override`` on the
chunked route (``attn_chunk`` 4). Hidden states within atol / rtol 1e-4;
on the flash route pad positions of left-padded rows are garbage by
contract and are not compared."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dense_family import TOL, paged_copy, trees
from test_torch_fixtures import configs, prompts
from repro.models import registry as jreg
from repro.models import transformer as jtf
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttf

torch.set_num_threads(1)
ARCH = "starcoder2-15b"
WINDOW = 4
LENS = [12, 6, 9, 11]


def _cfgs(route, **kw):
    gemm_impl, pin = {"flash": ("pallas", False), "naive": ("pallas", True),
                      "xla": ("xla", False)}[route]
    return configs(gemm_impl, pin=pin, arch=ARCH, sliding_window=WINDOW,
                   **kw)


def _left_padded(lens, seed):
    ps = prompts(lens, seed=seed)
    s = max(lens)
    toks = np.zeros((len(lens), s), np.int32)
    start = np.array([s - n for n in lens], np.int32)
    for i, p in enumerate(ps):
        toks[i, start[i]:] = p
    return toks, start


@pytest.mark.parametrize("route", ["flash", "naive", "xla"])
def test_prefill_and_decode_with_window_match_reference(route):
    """Four left-padded prompts of 6-12 tokens, then three decode steps
    on the contiguous cache and on the pool."""
    jcfg, tcfg = _cfgs(route)
    jp, tp = trees(ARCH)
    toks, start = _left_padded(LENS, seed=2)
    s, total = toks.shape[1], 16
    real = np.ones((4, total), bool)
    if route == "flash":
        real = np.arange(total)[None, :] >= start[:, None]
    jcache = jreg.init_cache(jcfg, 4, total)
    jh, jcache = jreg.prefill(jp, jcfg, tokens=jnp.asarray(toks),
                              cache=jcache, start=jnp.asarray(start))
    tcache = treg.init_cache(tcfg, 4, total, device="cpu")
    th, tcache = treg.prefill(tp, tcfg, torch.from_numpy(toks), tcache,
                              start=torch.from_numpy(start))
    np.testing.assert_allclose(th.numpy()[real[:, :s]],
                               np.asarray(jh)[real[:, :s]], **TOL)
    pcache = paged_copy(tcache, 8, seed=3)
    nxt = np.array([20, 21, 22, 23], np.int32)
    for step in range(3):
        jh, jcache = jreg.decode_step(jp, jcfg, jnp.asarray(nxt + step),
                                      jcache)
        th, tcache = treg.decode_step(tp, tcfg, torch.from_numpy(nxt + step),
                                      tcache)
        ph, pcache = treg.decode_step(tp, tcfg, torch.from_numpy(nxt + step),
                                      pcache)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        np.testing.assert_allclose(ph.numpy(), np.asarray(jh), **TOL)


@pytest.mark.parametrize("gemm_impl", ["pallas", "xla"])
def test_packed_prefill_with_window_matches_reference(gemm_impl):
    """Three requests of 12, 6 and 9 tokens packed into one 32-token
    bucket (the packed flash kernel against the Pallas kernel, or the
    packed plain route), scattered into a contiguous cache."""
    jcfg, tcfg = configs(gemm_impl, arch=ARCH, sliding_window=WINDOW)
    jp, tp = trees(ARCH)
    lens, tpad = (12, 6, 9), 32
    rng = np.random.default_rng(4)
    toks = np.zeros((1, tpad), np.int32)
    seg = np.full((tpad,), len(lens), np.int32)
    pos = np.zeros((1, tpad), np.int32)
    rows = np.full((tpad,), 3, np.int32)
    cols = np.zeros((tpad,), np.int32)
    off = 0
    for i, n in enumerate(lens):
        toks[0, off:off + n] = rng.integers(2, 512, n)
        seg[off:off + n] = i
        pos[0, off:off + n] = np.arange(n)
        rows[off:off + n], cols[off:off + n] = i, np.arange(n)
        off += n
    args = (toks, seg, pos, rows, cols)
    jh, jcache = jreg.prefill_packed(jp, jcfg, *map(jnp.asarray, args),
                                     jreg.init_cache(jcfg, 3, 16))
    th, tcache = treg.prefill_packed(
        tp, tcfg, *map(torch.from_numpy, args),
        treg.init_cache(tcfg, 3, 16, device="cpu"))
    real = seg < len(lens)
    np.testing.assert_allclose(th.numpy()[0, real], np.asarray(jh)[0, real],
                               **TOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               **TOL)


@pytest.mark.parametrize("paged", [False, True])
def test_verify_with_window_matches_reference(paged):
    """Three candidates per row after ragged prompts of 6-11 tokens: the
    window masks the oldest slots of every candidate."""
    jcfg, tcfg = _cfgs("naive")
    jp, tp = trees(ARCH)
    toks, start = _left_padded([11, 6, 9], seed=5)
    cand = np.array([[7, 8, 9], [10, 11, 12], [13, 14, 15]], np.int32)
    jc = jreg.init_cache(jcfg, 3, 16)
    _, jc = jreg.prefill(jp, jcfg, tokens=jnp.asarray(toks), cache=jc,
                         start=jnp.asarray(start))
    want, _ = jreg.verify_step(jp, jcfg, jnp.asarray(cand), jc)
    tc = treg.init_cache(tcfg, 3, 16, device="cpu")
    _, tc = treg.prefill(tp, tcfg, torch.from_numpy(toks), tc,
                         start=torch.from_numpy(start))
    if paged:
        tc = paged_copy(tc, 8, seed=6)
    got, _ = treg.verify_step(tp, tcfg, torch.from_numpy(cand), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window_override", [None, 3])
def test_forward_chunked_with_window_matches_reference(window_override):
    """`forward` on the plain route with attn_chunk 4 at S 12 (the chunked
    route: S > 2 · chunk), the config's window or ``window_override``."""
    jcfg, tcfg = _cfgs("xla", attn_chunk=4)
    jp, tp = trees(ARCH)
    toks = np.random.default_rng(8).integers(2, 512, (2, 12)).astype(
        np.int32)
    want, _ = jtf.forward(jp, jcfg, tokens=jnp.asarray(toks),
                          window_override=window_override)
    got, _ = ttf.forward(tp, tcfg, tokens=torch.from_numpy(toks),
                         window_override=window_override)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the window matters: without it the hidden states differ
    full, _ = ttf.forward(tp, tcfg.replace(sliding_window=0),
                          tokens=torch.from_numpy(toks))
    assert not torch.allclose(full, got, rtol=1e-3, atol=1e-3)
