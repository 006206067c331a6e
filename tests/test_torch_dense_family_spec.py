"""Self-speculative serve of the dense_lm family against the JAX engine:
starcoder2-15b at smoke width in f32 (4 query heads over one KV head),
packed weights, ``draft_k=2`` with the first of its two layers drafting,
per-request sampling, the README's six requests through 4 slots
(``gemm_impl="pallas"``: the Pallas kernels in interpret mode against the
port's wrappers' plain versions). Streams and ``serve_stats`` must equal
the JAX engine's on the contiguous cache, and the paged pool must give the
same streams.
"""
import torch

from test_torch_dense_family_serve import (README_BUDGETS, README_PROMPTS,
                                           _trees)
from test_torch_fixtures import configs
from repro.serve import sampling as jsampling
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.serve import sampling as tsampling
from repro_torch.serve.engine import ServeEngine

torch.set_num_threads(1)
SP_KW = [dict(temperature=0.8, seed=11),
         dict(temperature=1.2, seed=-5, repetition_penalty=1.3),
         dict(),
         dict(temperature=0.5, seed=7, presence_penalty=0.4,
              frequency_penalty=0.2),
         dict(temperature=0.9, seed=3),
         dict(temperature=0.0, seed=3, frequency_penalty=0.5)]


def test_spec_serve_equals_reference_at_gqa_4():
    """starcoder2 (4 query heads over one KV head), packed weights:
    serve(..., draft_k=2) with per-request sampling equals the JAX
    engine's streams and serve_stats on the contiguous cache, and the
    paged pool gives the same streams."""
    arch = "starcoder2-15b"
    jcfg, tcfg = configs(arch=arch, kv_page_size=8)
    jp, tp = _trees(arch, "packed")
    jeng = JEngine(jcfg, jp, max_batch=4, paged=False)
    want = jeng.serve(README_PROMPTS, max_new_tokens=README_BUDGETS,
                      sampling=[jsampling.SamplingParams(**k)
                                for k in SP_KW], draft_k=2)
    outs = {}
    for paged in (False, True):
        teng = ServeEngine(tcfg, tp, max_batch=4, paged=paged, device="cpu")
        outs[paged] = teng.serve(
            README_PROMPTS, max_new_tokens=README_BUDGETS,
            sampling=[tsampling.SamplingParams(**k) for k in SP_KW],
            draft_k=2)
        if not paged:
            assert ({k: v for k, v in teng.serve_stats.items()
                     if k != "ttft_s"}
                    == {k: v for k, v in jeng.serve_stats.items()
                        if k != "ttft_s"})
    assert outs[False] == want
    assert outs[True] == outs[False]
