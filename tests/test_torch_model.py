"""The port's `prefill` and `decode_step` against the reference's, at smoke
width in f32 with the attention domain pinned to the naive route, on the
same packed weights. Both routes: ``gemm_impl="pallas"`` (the reference's
Pallas kernels in interpret mode against the port's kernel wrappers, which
run their plain versions on the CPU) and ``"xla"``.

Tolerances: hidden states and cache contents atol 1e-4 (rtol 1e-4).
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


@pytest.mark.parametrize("gemm_impl", ["pallas", "xla"])
@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_and_decode_match_reference(params, gemm_impl, ragged):
    jcfg, tcfg = configs(gemm_impl)
    jp, tp = params
    tokens, start, nxt = _inputs(ragged)
    total = tokens.shape[1] + 2
    jcache = jreg.init_cache(jcfg, 8, total)
    jh, jcache = jreg.prefill(
        jp, jcfg, tokens=jnp.asarray(tokens), cache=jcache,
        start=None if start is None else jnp.asarray(start))
    tcache = treg.init_cache(tcfg, 8, total, device="cpu")
    th, tcache = treg.prefill(
        tp, tcfg, torch.from_numpy(tokens), tcache,
        start=None if start is None else torch.from_numpy(start))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               **TOL)
    np.testing.assert_array_equal(tcache["length"].numpy(),
                                  np.asarray(jcache["length"]))

    for step in range(2):
        jh, jcache = jreg.decode_step(jp, jcfg, jnp.asarray(nxt + step),
                                      jcache)
        th, tcache = treg.decode_step(tp, tcfg, torch.from_numpy(nxt + step),
                                      tcache)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tcache["v"].numpy(), np.asarray(jcache["v"]),
                               **TOL)


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
