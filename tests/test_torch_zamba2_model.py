"""The zamba2 family's model entry points against the reference, at smoke
width in f32 (zamba2-1.2b smoke: 4 Mamba2 layers, the shared block after
every 2, a 64-token shared window), on the reference's weights with
seeded norms (tests/test_torch_zamba2.py's `ztrees`), dense and
DBB-packed.

`forward` on both trees and the plain route, with a window override, and
on the packed tree against the reference's Pallas kernels in interpret
mode (the port's wrappers' plain versions: the shared block streams the
packed planes); `prefill` of an 80-token prompt (the chunked scan; the
ring past the 64-slot window wraps) and of a 62-token one (the
recurrence), every hybrid-cache leaf held, then decode steps across the
ring's wrap with every leaf held again; decode of token t against the
prefill of t + 1 (the reference's own test, at its tolerance); and the
entry points the reference refuses for zamba2.

Tolerance: hidden states and cache leaves within 1e-4 of max |value|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_zamba2 import _close, zcfgs, ztrees
from repro.models import registry as jreg
from repro.models import transformer as jtf
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttf

torch.set_num_threads(1)
MODEL_TOL = 1e-4        # of max |value|, model level


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(2, 512, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("weights,gemm_impl,t", [
    ("dense", "xla", 32), ("packed", "xla", 9), ("packed", "pallas", 32)])
def test_forward_matches_reference(weights, gemm_impl, t):
    """B2 x 32 tokens (the chunked scan) or x 9 (the recurrence)."""
    jcfg, tcfg = zcfgs(gemm_impl)
    jp, tp = ztrees(weights)
    toks = _tokens(5, 2, t)
    want, _ = jreg.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = treg.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert float(aux) == 0.0
    _close(got.numpy(), want, MODEL_TOL)


def test_forward_window_override_matches_reference():
    """`forward`'s ``window_override`` reaches the shared block."""
    jcfg, tcfg = zcfgs()
    jp, tp = ztrees()
    toks = _tokens(6, 2, 24)
    want, _ = jtf.forward(jp, jcfg, tokens=jnp.asarray(toks),
                          window_override=5)
    got, _ = ttf.forward(tp, tcfg, tokens=torch.from_numpy(toks),
                         window_override=5)
    full, _ = ttf.forward(tp, tcfg, tokens=torch.from_numpy(toks))
    _close(got.numpy(), want, MODEL_TOL)
    assert not torch.allclose(got, full)


def _cache_close(tc, jc):
    assert set(tc) == set(jc)
    for k in jc:
        assert tc[k].dtype == getattr(torch, str(jc[k].dtype)), k
        if k == "length":
            assert np.array_equal(tc[k].numpy(), np.asarray(jc[k]))
        else:
            _close(tc[k].numpy(), jc[k], MODEL_TOL)


@pytest.mark.parametrize("weights,gemm_impl,s,steps", [
    ("dense", "xla", 80, 2), ("dense", "xla", 62, 4),
    ("packed", "xla", 80, 2), ("packed", "xla", 62, 4),
    ("packed", "pallas", 80, 2)])
def test_prefill_and_decode_match_reference(weights, gemm_impl, s, steps):
    """Prefill B2 x s into a cache of s + 4 slots (a 64-slot ring: 80
    tokens wrap it in the prefill, 62 in the decode steps), then ``steps``
    decode steps; hidden states and every cache leaf after each call."""
    jcfg, tcfg = zcfgs(gemm_impl)
    jp, tp = ztrees(weights)
    toks = _tokens(7, 2, s + steps)
    jc = jreg.init_cache(jcfg, 2, s + 4)
    tc = treg.init_cache(tcfg, 2, s + 4, device="cpu")
    assert tc["shared_k"].shape == (2, 2, 64, 4, 32)
    jh, jc = jreg.prefill(jp, jcfg, tokens=jnp.asarray(toks[:, :s]),
                          cache=jc)
    th, tc = treg.prefill(tp, tcfg, torch.from_numpy(toks[:, :s]), tc)
    _close(th.numpy(), jh, MODEL_TOL)
    _cache_close(tc, jc)
    for i in range(steps):
        jh, jc = jreg.decode_step(jp, jcfg, jnp.asarray(toks[:, s + i]), jc)
        th, tc = treg.decode_step(tp, tcfg, torch.from_numpy(toks[:, s + i]),
                                  tc)
        _close(th.numpy(), jh, MODEL_TOL)
        _cache_close(tc, jc)


def test_decode_matches_prefill():
    """Prefill on t tokens + decode of token t equals the prefill of t + 1
    tokens at the last position (the reference's test_decode_matches_
    prefill, at its tolerance, 2e-2)."""
    _, tcfg = zcfgs()
    _, tp = ztrees()
    b, t = 2, 12
    toks = torch.from_numpy(_tokens(8, b, t + 1))
    cache = treg.init_cache(tcfg, b, t + 8, device="cpu")
    _, cache = treg.prefill(tp, tcfg, toks[:, :t], cache)
    h_dec, _ = treg.decode_step(tp, tcfg, toks[:, t], cache)
    h_full, _ = treg.prefill(tp, tcfg, toks,
                             treg.init_cache(tcfg, b, t + 8, device="cpu"))
    torch.testing.assert_close(h_dec[:, 0], h_full[:, t], rtol=2e-2,
                               atol=2e-2)


def test_kv_entry_points_refuse_zamba2():
    """`prefill_packed`, `prefill_continue` and `verify_step` need a
    slot-addressed K/V cache; the reference asserts its family gate
    there."""
    jcfg, tcfg = zcfgs()
    jp, tp = ztrees()
    cache = treg.init_cache(tcfg, 2, 8, device="cpu")
    z = torch.zeros((1, 4), dtype=torch.int32)
    zi = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError, match="slot-addressed K/V cache"):
        treg.prefill_packed(tp, tcfg, z, zi, z, zi, zi, cache)
    with pytest.raises(ValueError, match="slot-addressed K/V cache"):
        treg.prefill_continue(tp, tcfg, z, z, zi, zi, 0, cache)
    with pytest.raises(ValueError, match="slot-addressed K/V cache"):
        treg.verify_step(tp, tcfg, torch.zeros((2, 3), dtype=torch.int32),
                         cache)
    with pytest.raises(AssertionError):
        jreg.verify_step(jp, jcfg, jnp.zeros((2, 3), jnp.int32),
                         jreg.init_cache(jcfg, 2, 8))
