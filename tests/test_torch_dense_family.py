"""The rest of the dense_lm family against the reference, at smoke width in
f32 on the same packed weights: qwen2.5-14b (RMSNorm, GQA G 2, QKV bias),
yi-34b (RMSNorm, GQA G 4) and starcoder2-15b (LayerNorm, GQA G 4, QKV
bias, a non-gated GeLU MLP). Norm scales and biases and the QKV biases are
seeded random values (tests/test_torch_fixtures.py).

Both routes: ``gemm_impl="pallas"`` (the reference's Pallas kernels in
interpret mode against the port's kernel wrappers, which run their plain
versions on the CPU; prefill attention on the flash kernels) and "xla".
`forward`, and `prefill` followed by `decode_step` on the contiguous cache
and on a shuffled page pool holding the same slots, ragged and not. The
packed prefill, its continuation and `verify_step` are in
tests/test_torch_dense_family_packed.py.

Tolerances, as tests/test_torch_model.py holds olmo-1b: hidden states and
cache contents atol 1e-4 (rtol 1e-4); on the flash route a left-padded
row's pad positions are garbage by contract, so only real positions and the
cache slots real rows read are compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fixtures import FAMILY, configs, packed_params
from repro.models import registry as jreg
from repro_torch.models import registry as treg

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = FAMILY[1:]
_TREES = {}


def trees(arch):
    """(reference packed tree, the port's), built once per arch."""
    if arch not in _TREES:
        _TREES[arch] = packed_params(arch=arch)
    return _TREES[arch]


@pytest.mark.parametrize("gemm_impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, gemm_impl):
    jcfg, tcfg = configs(gemm_impl, arch=arch)
    jp, tp = trees(arch)
    toks = np.random.default_rng(5).integers(2, 512, (2, 9)).astype(np.int32)
    want, _ = jreg.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = treg.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_refuses_embeds():
    """`forward` takes ``embeds`` (in place of the tokens) and
    ``prefix_embeds`` (in front of them) on a dense_lm config too, as the
    reference's does: the vlm and audio families' inputs are ported (the
    name is kept from when the port refused them)."""
    jcfg, tcfg = configs(arch="qwen2.5-14b")
    jp, tp = trees("qwen2.5-14b")
    rng = np.random.default_rng(6)
    toks = rng.integers(2, 512, (1, 4)).astype(np.int32)
    for key in ("embeds", "prefix_embeds"):
        e = rng.standard_normal((1, 4, 128)).astype(np.float32)
        want, _ = jreg.forward(jp, jcfg, {"tokens": jnp.asarray(toks),
                                          key: jnp.asarray(e)})
        got, _ = treg.forward(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                         key: torch.from_numpy(e)})
        assert got.shape[1] == (8 if key == "prefix_embeds" else 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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


def paged_copy(cache, page: int, seed: int):
    """The contiguous cache's slots as a pool of ``page``-slot pages in
    shuffled physical order, with the block table that maps them back."""
    n_l, b, s = cache["k"].shape[:3]
    n_log = s // page
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(
        b * n_log)).long()
    inv = torch.argsort(perm)

    def pool(a):
        return a.reshape(n_l, b * n_log, page, *a.shape[3:])[:, inv].clone()
    out = {"k_pages": pool(cache["k"]), "v_pages": pool(cache["v"]),
           "block_table": perm.reshape(b, n_log).to(torch.int32),
           "length": cache["length"].clone()}
    if "start" in cache:
        out["start"] = cache["start"].clone()
    return out


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("gemm_impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, gemm_impl, ragged):
    """Prefill 8 rows of 6 tokens, then two decode steps on the contiguous
    cache and on the same slots as a shuffled pool of 8-slot pages."""
    jcfg, tcfg = configs(gemm_impl, arch=arch)
    jp, tp = trees(arch)
    tokens, start, nxt = _inputs(ragged)
    s, total = tokens.shape[1], 16
    real = np.ones((8, total), bool)
    if start is not None and gemm_impl == "pallas":
        real = np.arange(total)[None, :] >= start[:, None]
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


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference_layout(arch):
    """The port's own seeded init builds the reference's tree for the rest
    of the dense_lm family (olmo-1b's is tests/test_torch_model.py's): same
    keys, shapes and dtypes (the stacked [L, d] norm parameters, the QKV
    biases and the untied head among them)."""
    jcfg, tcfg = configs(arch=arch)
    jt = jax.eval_shape(lambda k: jreg.init_params(k, jcfg),
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
    assert torch.equal(tt["layers"]["ln_attn"]["scale"],
                       torch.ones(tcfg.num_layers, tcfg.d_model))
    if tcfg.qkv_bias:
        assert not tt["layers"]["attn"]["k_proj"]["b"].any()


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_linear_helpers_match_reference(fused, packed):
    """`linear_apply` (a dense `linear_init` dict) and `dbb_linear_apply`
    (a dense or packed weight, bias and GeLU) against the reference's on
    the same operands, f32."""
    from repro.core import dbb_linear as jdl
    from repro.core.dbb import pack_dbb as jpack
    from repro.models import common as jcm
    from repro_torch.core import dbb_linear as tdl
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import common as tcm
    rng = np.random.default_rng(9)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32) / 8
    b = rng.standard_normal(48).astype(np.float32)
    impl = "pallas" if fused else "xla"
    jw = jpack(jnp.asarray(w), 8, 4) if packed else jnp.asarray(w)
    tw = params_from_numpy(jw) if packed else torch.from_numpy(w)
    want = jdl.dbb_linear_apply(jnp.asarray(x), jw, jnp.asarray(b),
                                act="gelu", impl=impl)
    got = tdl.dbb_linear_apply(torch.from_numpy(x), tw, torch.from_numpy(b),
                               act="gelu", impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if not packed:
        want = jcm.linear_apply({"w": jw, "b": jnp.asarray(b)},
                                jnp.asarray(x), act="silu", fused=fused)
        got = tcm.linear_apply({"w": tw, "b": torch.from_numpy(b)},
                               torch.from_numpy(x), act="silu", fused=fused)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
