"""The rwkv6 family's model entry points against the reference, at smoke
width in f32 (rwkv6-1.6b smoke: 2 layers, d 128, two WKV heads of 64,
chunk 16), on the seeded reference weights of tests/test_torch_rwkv6.py
(`rtrees`), dense and DBB-packed, on both routes (``gemm_impl`` "xla" and
"pallas": rwkv6's layers run expanded in plain matmuls on either, as the
reference runs them in plain XLA).

`forward` (a chunked T and a T the chunk does not divide); `prefill` of
a 32-token and a 20-token prompt into a cache that already holds a state
(the reference's prefill starts from zeros whatever the cache holds),
every cache leaf held, then decode steps with every leaf held again;
decode of token t against the prefill of t + 1 (the reference's
test_decode_matches_prefill, at its tolerance); the entry points the
reference refuses for rwkv6; `init_params_by_layer` on an rwkv6 config.

Tolerance: hidden states and cache leaves within 1e-4 of max |value|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_rwkv6 import _close, rcfgs, rtrees
from repro.models import registry as jreg
from repro_torch.core.dbb import DbbWeight
from repro_torch.models import registry as treg

torch.set_num_threads(1)
MODEL_TOL = 1e-4


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(2, 512, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("weights,gemm_impl,t", [
    ("dense", "xla", 32), ("dense", "pallas", 20), ("packed", "xla", 20),
    ("packed", "pallas", 32)])
def test_forward_matches_reference(weights, gemm_impl, t):
    jcfg, tcfg = rcfgs(gemm_impl)
    jp, tp = rtrees(weights)
    toks = _tokens(5, 2, t)
    want, _ = jreg.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = treg.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert float(aux) == 0.0
    _close(got.numpy(), want, MODEL_TOL)


def _cache_close(tc, jc):
    assert set(tc) == set(jc)
    for k in jc:
        assert tc[k].dtype == getattr(torch, str(jc[k].dtype)), k
        if k == "length":
            assert np.array_equal(tc[k].numpy(), np.asarray(jc[k]))
        else:
            _close(tc[k].numpy(), jc[k], MODEL_TOL)


@pytest.mark.parametrize("weights,gemm_impl,s,steps", [
    ("dense", "xla", 32, 2), ("dense", "pallas", 20, 3),
    ("packed", "xla", 20, 3), ("packed", "pallas", 32, 2)])
def test_prefill_and_decode_match_reference(weights, gemm_impl, s, steps):
    """Prefill B2 x s into a cache whose state is not zero (a decode step
    ran into it first), then ``steps`` decode steps; hidden states and
    every cache leaf after each call."""
    jcfg, tcfg = rcfgs(gemm_impl)
    jp, tp = rtrees(weights)
    toks = _tokens(7, 2, s + steps + 1)
    jc = jreg.init_cache(jcfg, 2, s + 4)
    tc = treg.init_cache(tcfg, 2, s + 4, device="cpu")
    assert tc["wkv"].shape == (2, 2, 2, 64, 64)
    _, jc = jreg.decode_step(jp, jcfg, jnp.asarray(toks[:, -1]), jc)
    _, tc = treg.decode_step(tp, tcfg, torch.from_numpy(toks[:, -1]), tc)
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


def test_prefill_without_a_cache_makes_one():
    """``cache=None`` makes a cache at S slots, as the reference's does."""
    _, tcfg = rcfgs()
    _, tp = rtrees()
    toks = torch.from_numpy(_tokens(8, 2, 12))
    h, cache = treg.prefill(tp, tcfg, toks)
    h2, cache2 = treg.prefill(tp, tcfg, toks, treg.init_cache(
        tcfg, 2, 12, device="cpu"))
    assert torch.equal(h, h2)
    assert all(torch.equal(cache[k], cache2[k]) for k in cache2)


def test_decode_matches_prefill():
    """Prefill on t tokens + decode of token t equals the prefill of t + 1
    tokens at the last position (the reference's test_decode_matches_
    prefill, at its tolerance, 2e-2)."""
    _, tcfg = rcfgs()
    _, tp = rtrees()
    b, t = 2, 12
    toks = torch.from_numpy(_tokens(8, b, t + 1))
    cache = treg.init_cache(tcfg, b, t + 8, device="cpu")
    _, cache = treg.prefill(tp, tcfg, toks[:, :t], cache)
    h_dec, _ = treg.decode_step(tp, tcfg, toks[:, t], cache)
    h_full, _ = treg.prefill(tp, tcfg, toks,
                             treg.init_cache(tcfg, b, t + 8, device="cpu"))
    torch.testing.assert_close(h_dec[:, 0], h_full[:, t], rtol=2e-2,
                               atol=2e-2)


def test_kv_entry_points_refuse_rwkv6():
    """`prefill_packed`, `prefill_continue` and `verify_step` need a
    slot-addressed K/V cache; the reference asserts its family gate
    there."""
    jcfg, tcfg = rcfgs()
    jp, tp = rtrees()
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


def test_init_params_by_layer_builds_rwkv6():
    """The CLI's builder: every projection of the time and channel mix
    packed, the LoRAs, decays and norms dense, equal to packing the
    unpacked tree of the same seed."""
    _, tcfg = rcfgs()
    dense = treg.init_params_by_layer(tcfg, seed=3, device="cpu")
    packed = treg.init_params_by_layer(tcfg, seed=3, device="cpu", pack=True)
    tm, cm = packed["layers"]["time_mix"], packed["layers"]["channel_mix"]
    for p in [tm[k] for k in ("r_proj", "k_proj", "v_proj", "g_proj",
                              "o_proj")] + [cm[k] for k in ("wk", "wv",
                                                            "wr")]:
        assert isinstance(p["w"], DbbWeight)
        assert p["w"].values.shape[0] == tcfg.num_layers
    for k in ("lora_a", "lora_b", "w0", "w_lora_a", "w_lora_b", "u", "mu"):
        assert isinstance(tm[k], torch.Tensor)
        assert torch.equal(tm[k], dense["layers"]["time_mix"][k])
    toks = torch.from_numpy(_tokens(9, 2, 16))
    from repro_torch.core.dbb_linear import pack_tree
    from repro_torch.core.sparsity import apply_dbb_to_tree
    want = pack_tree(apply_dbb_to_tree(dense, tcfg.dbb,
                                       straight_through=False), tcfg.dbb)
    h1, _ = treg.forward(packed, tcfg, {"tokens": toks})
    h2, _ = treg.forward(want, tcfg, {"tokens": toks})
    assert torch.equal(h1, h2)
