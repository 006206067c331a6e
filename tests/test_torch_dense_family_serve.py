"""`ServeEngine.generate` and `ServeEngine.serve` of the port against the
JAX engine for qwen2.5-14b, yi-34b and starcoder2-15b at smoke width in
f32 (``gemm_impl="pallas"``: the Pallas kernels in interpret mode against
the port's wrappers' plain versions), on DBB-packed weights and on the same
weights unpacked: greedy token streams must be equal, and so must serve's
``serve_stats`` apart from the wall-clock ``ttft_s``.

generate: a ragged (left-padded) batch of six prompts, 8 new tokens each.
serve: the README's six requests through 4 slots with packed prefill into
the contiguous cache, budgets [4, 8, 2, 6, 3, 5], so retirements free slots
and queued requests are admitted between decode chunks
(tests/test_torch_dense_family_spec.py runs the speculative serve). No step
needed a top-2-margin exclusion at these seeds: the streams are compared
whole.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_fixtures import FAMILY, configs, dense_params, packed_params
from test_torch_fixtures import prompts
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.kernels.common import LAUNCHES
from repro_torch.serve.engine import ServeEngine

torch.set_num_threads(1)
ARCHS = FAMILY[1:]
README_PROMPTS = [[5, 17, 3], [9, 9, 9], [42, 7], [4, 8, 15, 16], [23, 42],
                  [7, 7, 7]]
README_BUDGETS = [4, 8, 2, 6, 3, 5]
_TREES = {}


def _trees(arch, weights):
    key = (arch, weights)
    if key not in _TREES:
        if weights == "packed":
            _TREES[key] = packed_params(seed=1, arch=arch)
        else:
            jp, tp = dense_params(seed=1, arch=arch)
            _TREES[key] = jax.tree_util.tree_map(jnp.asarray, jp), tp
    return _TREES[key]


@pytest.mark.parametrize("weights", ["packed", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_equal_reference(arch, weights):
    jcfg, tcfg = configs(arch=arch)
    jp, tp = _trees(arch, weights)
    ps = prompts([6, 3, 6, 2, 5, 4], seed=len(arch))
    want = JEngine(jcfg, jp, max_batch=8).generate(ps, max_new_tokens=8)
    before = dict(LAUNCHES)
    got = ServeEngine(tcfg, tp, max_batch=8, device="cpu").generate(
        ps, max_new_tokens=8)
    assert got == want
    assert LAUNCHES == before             # plain versions on the CPU


@pytest.mark.parametrize("weights", ["packed", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_and_stats_equal_reference(arch, weights):
    jcfg, tcfg = configs(arch=arch)
    jp, tp = _trees(arch, weights)
    jeng = JEngine(jcfg, jp, max_batch=4)
    want = jeng.serve(README_PROMPTS, max_new_tokens=README_BUDGETS)
    teng = ServeEngine(tcfg, tp, max_batch=4, device="cpu")
    got = teng.serve(README_PROMPTS, max_new_tokens=README_BUDGETS)
    assert got == want
    assert ({k: v for k, v in teng.serve_stats.items() if k != "ttft_s"}
            == {k: v for k, v in jeng.serve_stats.items() if k != "ttft_s"})

