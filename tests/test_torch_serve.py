"""`ServeEngine.serve` of the port against the reference's on the same
packed weights (smoke width, f32, prefill attention on the flash kernels'
plain versions against the Pallas kernels in interpret mode): greedy token
streams and ``serve_stats`` (apart from the wall-clock ``ttft_s``) must be
equal.

The README's serving quickstart: 6 requests through 4 slots, budgets
[4, 8, 2, 6, 3, 5], so retirements free slots and queued requests are
admitted between decode chunks. Modes: packed prefill into the contiguous
cache (the default), into the paged pool, padded (per-request left-padded)
admission, and packed prefill split into 2-token chunks (continuations
of the longer prompts); plus a paged pool too small for every request at
once, which defers admissions, and longer prompts whose 8-token chunks
continue across pages of the pool.
"""
import pytest
import torch

from test_torch_fixtures import configs, packed_params, prompts
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.kernels.common import LAUNCHES
from repro_torch.serve.engine import ServeEngine

torch.set_num_threads(1)

README_PROMPTS = [[5, 17, 3], [9, 9, 9], [42, 7], [4, 8, 15, 16], [23, 42],
                  [7, 7, 7]]
README_BUDGETS = [4, 8, 2, 6, 3, 5]


@pytest.fixture(scope="module")
def params():
    return packed_params(seed=1)


def _stats(eng):
    return {k: v for k, v in eng.serve_stats.items() if k != "ttft_s"}


LONG_PROMPTS = prompts([19, 5, 12, 27, 3, 9], seed=4)
LONG_BUDGETS = [11, 17, 4, 9, 13, 6]


@pytest.mark.parametrize("cfg_kw,eng_kw,long", [
    ({}, {}, False),                                  # packed, contiguous
    (dict(kv_page_size=8), {}, False),                # packed, paged
    ({}, dict(prefill_mode="padded"), False),         # padded admission
    ({}, dict(prefill_chunk=2), False),               # chunked prefill
    (dict(kv_page_size=8), dict(kv_pool_pages=5), False),  # deferrals
    (dict(kv_page_size=8), dict(prefill_chunk=8), True),
], ids=["packed", "paged", "padded", "chunked", "paged-deferred",
        "chunked-paged-long"])
def test_serve_tokens_and_stats_equal_reference(params, cfg_kw, eng_kw,
                                                long):
    jcfg, tcfg = configs(**cfg_kw)
    jp, tp = params
    ps, bud = ((LONG_PROMPTS, LONG_BUDGETS) if long
               else (README_PROMPTS, README_BUDGETS))
    jeng = JEngine(jcfg, jp, max_batch=4, **eng_kw)
    want = jeng.serve(ps, max_new_tokens=bud)
    before = dict(LAUNCHES)
    teng = ServeEngine(tcfg, tp, max_batch=4, device="cpu", **eng_kw)
    continued = []
    step = teng._prefill_continue
    teng._prefill_continue = lambda *a: continued.append(1) or step(*a)
    got = teng.serve(ps, max_new_tokens=bud)
    assert LAUNCHES == before             # plain versions on the CPU
    assert got == want
    assert _stats(teng) == _stats(jeng)
    if "kv_pool_pages" in eng_kw:
        assert teng.serve_stats["deferred_admissions"] > 0
    assert bool(continued) == ("prefill_chunk" in eng_kw)


def test_serve_paged_equals_contiguous_with_long_prompts(params):
    """Prompts longer than a page and budgets past the chunk: the paged
    pool and the contiguous cache decoding through the same kernel (page
    8) give equal streams, packed and chunked."""
    _, tcfg = configs(kv_page_size=8)
    _, tp = params
    ps, bud = LONG_PROMPTS, LONG_BUDGETS
    outs = {}
    for paged in (False, True):
        for chunk in (0, 8):
            eng = ServeEngine(tcfg, tp, max_batch=4, paged=paged,
                              prefill_chunk=chunk, device="cpu")
            outs[paged, chunk] = eng.serve(ps, max_new_tokens=bud)
            assert ("pool_pages" in eng.serve_stats) == paged
    assert len(set(map(str, outs.values()))) == 1
    assert [len(o) for o in outs[True, 0]] == bud


def test_serve_stats_carry_ttft_per_request(params):
    _, tcfg = configs()
    _, tp = params
    eng = ServeEngine(tcfg, tp, max_batch=4, device="cpu")
    eng.serve(README_PROMPTS, max_new_tokens=README_BUDGETS)
    ttft = eng.serve_stats["ttft_s"]
    assert len(ttft) == len(README_PROMPTS)
    assert all(0 < t < 60 for t in ttft)
    assert eng.serve_stats["prompt_tokens"] == sum(map(len, README_PROMPTS))


def test_serve_refuses_what_is_not_ported(params):
    """Sampling and speculation are ported (tests/test_torch_sample.py,
    tests/test_torch_spec.py); what serve still refuses: a sampling list
    of the wrong length, a draft as deep as the model, an unknown prefill
    mode. ``draft_k`` on a greedy call is ignored, as in the reference."""
    from repro_torch.serve.sampling import SamplingParams
    _, tcfg = configs()
    _, tp = params
    eng = ServeEngine(tcfg, tp, max_batch=4, device="cpu")
    with pytest.raises(ValueError, match="SamplingParams"):
        eng.serve(README_PROMPTS, sampling=[SamplingParams()] * 5)
    deep = ServeEngine(tcfg, tp, max_batch=4, device="cpu",
                       draft_layers=tcfg.num_layers)
    with pytest.raises(ValueError, match="draft_layers"):
        deep.serve(README_PROMPTS, sampling=[SamplingParams()] * 6,
                   draft_k=2)
    assert eng.serve(README_PROMPTS, draft_k=2) == eng.serve(README_PROMPTS)
    with pytest.raises(ValueError, match="prefill_mode"):
        eng.serve(README_PROMPTS, prefill_mode="ragged")
    assert eng.serve([]) == []
