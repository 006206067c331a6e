"""The dense_lm family's packed prefill into a page pool and speculative
`verify_step` against the reference (qwen2.5-14b, yi-34b, starcoder2-15b
at smoke width in f32, the weights of tests/test_torch_dense_family.py), on
both routes. Hidden states and cache contents within atol 1e-4 (rtol
1e-4).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dense_family import ARCHS, TOL, paged_copy, trees
from test_torch_dense_family_packed import packed_case
from test_torch_fixtures import configs, prompts
from repro.models import registry as jreg
from repro_torch.models import registry as treg

torch.set_num_threads(1)


@pytest.mark.parametrize("gemm_impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_packed_prefill_and_continuation_match_reference(arch,
                                                               gemm_impl):
    """The packed prefill, continuation and decode of
    tests/test_torch_dense_family_packed.py into a shuffled page pool."""
    packed_case(arch, gemm_impl, paged=True)


@pytest.mark.parametrize("gemm_impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", ARCHS)
def test_verify_step_matches_reference(arch, gemm_impl):
    """Three candidates per row on a ragged (left-padded) cache, on the
    contiguous cache and on the same slots as a shuffled page pool: hidden
    states within tolerance of the reference's; the cache keeps its length
    and holds the candidates' K/V at slots length .. length+2."""
    jcfg, tcfg = configs(gemm_impl, pin=True, arch=arch)
    jp, tp = trees(arch)
    ps = prompts([5, 2, 4], seed=3)
    toks = np.zeros((3, 5), np.int32)
    start = np.array([0, 3, 1], np.int32)
    for i, p in enumerate(ps):
        toks[i, 5 - len(p):] = p
    cand = np.array([[7, 8, 9], [10, 11, 12], [13, 14, 15]], np.int32)
    jc = jreg.init_cache(jcfg, 3, 16)
    _, jc = jreg.prefill(jp, jcfg, tokens=jnp.asarray(toks), cache=jc,
                         start=jnp.asarray(start))
    want, jc2 = jreg.verify_step(jp, jcfg, jnp.asarray(cand), jc)
    tc = treg.init_cache(tcfg, 3, 16, device="cpu")
    _, tc = treg.prefill(tp, tcfg, torch.from_numpy(toks), tc,
                         start=torch.from_numpy(start))
    pc = paged_copy(tc, 8, seed=5)
    got, tc2 = treg.verify_step(tp, tcfg, torch.from_numpy(cand), tc)
    pgot, pc2 = treg.verify_step(tp, tcfg, torch.from_numpy(cand), pc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(pgot.numpy(), np.asarray(want), **TOL)
    assert tc2["length"].tolist() == pc2["length"].tolist() == [5, 5, 5]
    np.testing.assert_allclose(tc2["k"][:, :, 5:8].numpy(),
                               np.asarray(jc2["k"])[:, :, 5:8], **TOL)
