"""The chunked prefill attention (`attn_chunked`: query chunks walk their
key chunks with a running-softmax combine, skipping chunks wholly outside
the sliding window) against the reference's `_chunked_causal_attention`,
and the attention domain's route choice against the reference's `select`.

Operands from numpy with a fixed seed, f32 (rtol / atol 1e-5) and bf16
(outputs within one bf16 rounding: rtol 1e-2 of the f32 products' values,
atol 1e-2)."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fixtures import configs
from repro.kernels import dispatch as jd
from repro.models import attention as ja
from repro_torch.kernels import dispatch as td
from repro_torch.models import attention as ta


def _qkv(b, s, hkv, g, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hkv * g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("window", [0, 5])
def test_chunked_matches_reference(window, softcap, g):
    """chunk 4, S 16 (four query chunks; the window skips the first key
    chunks of the later ones), Hkv 2."""
    jcfg, tcfg = configs("xla", sliding_window=window,
                         attn_logit_softcap=softcap)
    q, k, v = _qkv(2, 16, 2, g, 8, seed=window + g)
    want = ja._chunked_causal_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jcfg, 4)
    got = ta._chunked_causal_attention(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), tcfg, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # and it is causal attention: the naive route's result
    pos = torch.arange(16)
    naive = ta._naive_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), pos, pos, tcfg)
    torch.testing.assert_close(got, naive, rtol=1e-5, atol=1e-5)


def test_chunked_bf16_matches_reference():
    jcfg, tcfg = configs("xla", sliding_window=5, dtype="bfloat16")
    q, k, v = _qkv(1, 16, 2, 2, 16, seed=11)
    want = ja._chunked_causal_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)), jcfg, 4)
    got = ta._chunked_causal_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), tcfg,
        4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_chunked_refuses_a_ragged_length():
    _, tcfg = configs("xla")
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 10, 1, 1, 8, seed=0))
    with pytest.raises(ValueError, match="multiple"):
        ta._chunked_causal_attention(q, k, v, tcfg, 4)


GRID = list(itertools.product(
    [(6, 6), (16, 16), (24, 24), (48, 48), (64, 64), (8, 48)],
    [4, 8, 16, 1024], [False, True], [False, True]))


@pytest.mark.parametrize("ts,chunk,ragged,flash", GRID)
def test_attention_route_matches_reference(ts, chunk, ragged, flash):
    """The spec dispatch.attention builds, chosen as the reference's
    `select` chooses: flash when active, then chunked (S > 2 · chunk, S a
    multiple of it, T = S, one shared ladder), then naive."""
    t, s = ts
    jspec = jd.OpSpec(domain="attention", m=t, k=32, n=s, itemsize=4,
                      out_itemsize=4, ragged=ragged, chunk=chunk, batch=2,
                      flash_active=flash)
    tspec = td.OpSpec(domain="attention", m=t, k=32, n=s, ragged=ragged,
                      chunk=chunk, batch=2, flash_active=flash)
    want, _ = jd.select(jspec, {})
    got, _ = td.select(tspec, {})
    assert got == want


@pytest.mark.parametrize("attn_impl", ["auto", "chunked", "naive", "flash"])
@pytest.mark.parametrize("gemm_impl", ["pallas", "xla"])
@pytest.mark.parametrize("s,ragged", [(16, False), (16, True), (8, False),
                                      (12, False)])
def test_front_door_takes_the_reference_route(monkeypatch, attn_impl,
                                              gemm_impl, s, ragged):
    """dispatch.attention (attn_chunk 4) runs the route the reference's
    `select` picks for the spec its own front door builds, and its output
    equals the reference front door's (rtol / atol 1e-5)."""
    jcfg, tcfg = configs(gemm_impl, attn_impl=attn_impl, attn_chunk=4)
    q, k, v = _qkv(2, s, 2, 2, 16, seed=s)
    start = np.array([0, 3], np.int32) if ragged else np.zeros(2, np.int32)
    pos = np.arange(s)[None, :] - start[:, None]
    if not ragged:
        pos = pos[:1]
    jspec = jd.OpSpec(domain="attention", m=s, k=16, n=s, itemsize=4,
                      out_itemsize=4, ragged=ragged, chunk=4, batch=2,
                      flash_active=jd.flash_backend_active(jcfg))
    routes = dict(jd.routes_from_cfg(jcfg))
    routes.setdefault("attention", jd._ATTN_IMPL_ROUTE.get(attn_impl))
    want_route, _ = jd.select(jspec, {k_: r for k_, r in routes.items()
                                      if r})
    taken = []

    def spy(name, fn):
        def run(*a, **kw):
            taken.append(name)
            return fn(*a, **kw)
        return run
    monkeypatch.setattr(ta, "_chunked_causal_attention",
                        spy("attn_chunked", ta._chunked_causal_attention))
    monkeypatch.setattr(ta, "_naive_attention",
                        spy("attn_naive", ta._naive_attention))
    import repro_torch.kernels.attn.ops as aops
    monkeypatch.setattr(aops, "flash_attention",
                        spy("attn_flash", aops.flash_attention))
    got = td.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                       torch.from_numpy(pos), tcfg, ragged=ragged)
    assert taken == [want_route]
    want = jd.attention(*(jnp.asarray(a) for a in (q, k, v)),
                        jnp.asarray(pos), jcfg, ragged=ragged)
    real = (np.arange(s)[None, :] >= start[:, None])
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pin", ["attn_chunked", "attn_naive"])
def test_continuation_pins_take_naive_as_the_reference(pin):
    """A chunked-prefill continuation has no chunked route: a pin to it
    takes attn_naive without a warning, as the reference's does."""
    import warnings
    jcfg, tcfg = configs(kernel_routes=(("attention", pin),))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = td.chunk_attention_route(tcfg, t=8, s=48, d=32)
    assert got == "attn_naive" == jd.chunk_attention_route(
        jcfg, t=8, s=48, d=32, itemsize=4)
