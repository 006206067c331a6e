"""`ServeEngine.generate` / `ServeEngine.serve` and the serve CLI of the
moe_lm family against the reference, at smoke width in f32 with
``gemm_impl="pallas"`` (the reference's Pallas kernels in interpret mode
against the port's wrappers' plain versions; the MoE layers expanded to
dense, the experts through `dispatch.matmul`): greedy streams equal to the
JAX engine's for generate (six prompts in 8 slots: the two idle rows
route and take capacity too) and for serve with packed
prefill into the contiguous cache, chunked prefill and the paged pool
(arctic-480b smoke on packed and dense weights, the kimi-shaped config on
packed weights), with equal ``serve_stats`` apart from ``ttft_s``; sampled
generate and serve, and ``draft_k=2`` serve with per-request sampling.

generate's left-padded (ragged) batch runs with no-drop capacity
(``capacity_factor=16``); its equal-length batch, where some expert
overflows, at the config's. A left pad's query row attends no key and the
flash kernels leave its output unspecified (the Pallas kernel and the
port's plain version average different key sets); the pad still routes
and takes capacity, and it precedes later rows' tokens in the dispatch
order, so under drops it can displace their pairs
(tests/test_torch_moe_model.py's module doc). Packed prefill has no such
rows: its pad tokens attend each other in both packages.

The serve CLI on arctic-480b smoke (``--packed``) against the reference's
(its engine faked): the prompts, the routes its tables choose, and its
streams against direct engine calls on the tree `init_params_by_layer`
gives. The CLI's family gate is the reference's: MoE runs, a CNN exits.
"""
import dataclasses

import pytest
import torch

from test_torch_fixtures import prompts
from test_torch_moe import moe_cfgs, moe_trees
from test_torch_serve_cli import RUNS, _chosen, _port_run, _reference_run
from repro.serve import sampling as jsampling
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import get_config as tget
from repro_torch.kernels.common import LAUNCHES
from repro_torch.launch import serve as tserve
from repro_torch.models import moe as tmoe
from repro_torch.models.registry import init_params_by_layer
from repro_torch.serve import sampling as tsampling
from repro_torch.serve.engine import ServeEngine

torch.set_num_threads(1)
README_PROMPTS = [[5, 17, 3], [9, 9, 9], [42, 7], [4, 8, 15, 16], [23, 42],
                  [7, 7, 7]]
README_BUDGETS = [4, 8, 2, 6, 3, 5]
SP_KW = [dict(temperature=0.8, seed=11),
         dict(temperature=1.2, seed=-5, repetition_penalty=1.3),
         dict(),
         dict(temperature=0.5, seed=7, presence_penalty=0.4,
              frequency_penalty=0.2),
         dict(temperature=0.9, seed=3),
         dict(temperature=0.0, seed=3, frequency_penalty=0.5)]
TREES = [("arctic", "packed"), ("arctic", "dense"), ("kimi", "packed")]


def _trees(kind, weights):
    return moe_trees(kind, weights, seed=1)


def _stats(eng):
    return {k: v for k, v in eng.serve_stats.items() if k != "ttft_s"}


@pytest.mark.parametrize("ragged", [True, False])
@pytest.mark.parametrize("kind,weights", TREES)
def test_generate_tokens_equal_reference(kind, weights, ragged, monkeypatch):
    jcfg, tcfg = moe_cfgs(kind=kind)
    if ragged:                                   # see the module doc
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                    capacity_factor=16.0))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe,
                                                    capacity_factor=16.0))
    jp, tp = _trees(kind, weights)
    ps = prompts([6, 3, 6, 2, 5, 4] if ragged else [6] * 6, seed=7)
    want = JEngine(jcfg, jp, max_batch=8).generate(ps, max_new_tokens=8)
    routes = []
    route = tmoe._route

    def recording(x, w, cfg):
        out = route(x, w, cfg)
        routes.append(out[0])
        return out
    monkeypatch.setattr(tmoe, "_route", recording)
    before = dict(LAUNCHES)
    got = ServeEngine(tcfg, tp, max_batch=8, device="cpu").generate(
        ps, max_new_tokens=8)
    assert got == want
    assert LAUNCHES == before             # plain versions on the CPU
    prefill = routes[:tcfg.num_layers]    # [8 rows x 6 positions] each
    over = any(torch.bincount(i.reshape(-1)).max().item()
               > tmoe._capacity(48, tcfg) for i in prefill)
    assert over == (not ragged)


@pytest.mark.parametrize("mode", ["packed", "chunked", "paged"])
@pytest.mark.parametrize("kind,weights", TREES)
def test_serve_tokens_and_stats_equal_reference(kind, weights, mode):
    """The README's six requests through 4 slots: packed prefill into the
    contiguous cache, chunked prefill (4-token chunks), or the paged pool
    (8-slot pages)."""
    kw = dict(kv_page_size=8) if mode == "paged" else {}
    jcfg, tcfg = moe_cfgs(kind=kind, **kw)
    jp, tp = _trees(kind, weights)
    ekw = dict(prefill_chunk=4) if mode == "chunked" else {}
    jeng = JEngine(jcfg, jp, max_batch=4, **ekw)
    want = jeng.serve(README_PROMPTS, max_new_tokens=README_BUDGETS)
    teng = ServeEngine(tcfg, tp, max_batch=4, device="cpu", **ekw)
    got = teng.serve(README_PROMPTS, max_new_tokens=README_BUDGETS)
    assert got == want
    assert _stats(teng) == _stats(jeng)


def test_sampled_generate_and_serve_equal_reference():
    jcfg, tcfg = moe_cfgs()
    jp, tp = _trees("arctic", "packed")
    jsp = [jsampling.SamplingParams(**k) for k in SP_KW]
    tsp = [tsampling.SamplingParams(**k) for k in SP_KW]
    ps = prompts([6] * 6, seed=7)
    want = JEngine(jcfg, jp, max_batch=8).generate(
        ps, max_new_tokens=8, sampling=jsp)
    got = ServeEngine(tcfg, tp, max_batch=8, device="cpu").generate(
        ps, max_new_tokens=8, sampling=tsp)
    assert got == want
    jeng = JEngine(jcfg, jp, max_batch=4)
    want = jeng.serve(README_PROMPTS, max_new_tokens=README_BUDGETS,
                      sampling=jsp)
    teng = ServeEngine(tcfg, tp, max_batch=4, device="cpu")
    assert teng.serve(README_PROMPTS, max_new_tokens=README_BUDGETS,
                      sampling=tsp) == want
    assert _stats(teng) == _stats(jeng)


def test_spec_serve_equals_reference():
    """``draft_k=2`` with the first of the two layers drafting, per-request
    sampling: the JAX engine's streams and serve_stats on the contiguous
    cache; the paged pool gives the same streams."""
    jcfg, tcfg = moe_cfgs(kv_page_size=8)
    jp, tp = _trees("arctic", "packed")
    jeng = JEngine(jcfg, jp, max_batch=4, paged=False)
    want = jeng.serve(README_PROMPTS, max_new_tokens=README_BUDGETS,
                      sampling=[jsampling.SamplingParams(**k)
                                for k in SP_KW], draft_k=2)
    for paged in (False, True):
        teng = ServeEngine(tcfg, tp, max_batch=4, paged=paged, device="cpu")
        got = teng.serve(README_PROMPTS, max_new_tokens=README_BUDGETS,
                         sampling=[tsampling.SamplingParams(**k)
                                   for k in SP_KW], draft_k=2)
        assert got == want
        if not paged:
            assert _stats(teng) == _stats(jeng)


@pytest.mark.parametrize("run", ["generate", "serve", "sampled", "draft"])
def test_cli_prompts_routes_and_streams(monkeypatch, capsys, run):
    """``--arch arctic-480b --packed``: the reference CLI's prompts and
    table routes, and the streams of the ServeEngine call the run makes,
    made directly on the tree `init_params_by_layer` gives."""
    argv = ["--arch", "arctic-480b", "--packed"] + RUNS[run]
    jprompts, jout = _reference_run(monkeypatch, capsys, argv)
    rep, tout = _port_run(capsys, argv)
    assert rep["prompts"] == jprompts
    got, want = _chosen(tout), _chosen(jout)
    if run != "serve" and run != "sampled":
        # a generate run prints the padded prefill table (its prefill is
        # padded), the reference the packed one
        got.pop("prefill attention")
        want.pop("prefill attention")
    assert got == want
    cfg = tget("arctic-480b", smoke=True).replace(gemm_impl="pallas")
    assert rep["cfg"] == cfg
    seed = 3 if run == "sampled" else 0
    tree = init_params_by_layer(cfg, seed=seed, device="cpu", pack=True)
    sampling = None
    if run in ("sampled", "draft"):
        sampling = [tsampling.SamplingParams(temperature=0.8, seed=seed + i)
                    for i in range(len(rep["prompts"]))]
    eng = ServeEngine(cfg, tree, max_batch=4, device="cpu",
                      draft_k=2 if run == "draft" else 0)
    call = eng.serve if len(rep["prompts"]) > 4 else eng.generate
    assert rep["outs"] == call(rep["prompts"], max_new_tokens=6,
                               sampling=sampling)


def test_cli_family_gate_is_the_reference_rule(capsys):
    """MoE configs serve through the CLI; the CNN exits as the reference's
    CLI exits."""
    rep, _ = _port_run(capsys, ["--arch", "kimi-k2-1t-a32b", "--batch", "2",
                                "--prompt-len", "4", "--max-new", "2"])
    assert rep["cfg"].family == "moe_lm"
    assert [len(o) for o in rep["outs"]] == [2, 2]
    with pytest.raises(SystemExit, match="token-decoder serving only"):
        tserve.main(["--arch", "convnet-dbb"], device="cpu")
