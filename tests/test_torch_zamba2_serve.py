"""Serving the zamba2 family against the reference, at smoke width in f32
with ``gemm_impl="pallas"`` (the reference's Pallas kernels in interpret
mode against the port's wrappers' plain versions) on the DBB-packed tree
of tests/test_torch_zamba2.py's `ztrees`: `ServeEngine.generate` greedy
and sampled, on equal-length and ragged (left-padded) batches, `serve`
with more requests than ``max_batch`` (static waves through `generate`,
each output cut to its budget), and ``draft_k`` refused — tokens and
warnings equal to the JAX engine's. A ragged batch's pads feed the
recurrent state in both packages alike, and both warn of it on the greedy
path.

The serve CLI on zamba2-1.2b smoke (``--packed``): the reference CLI's
prompts and table routes, and its streams against direct engine calls on
the tree `init_params_by_layer` gives, which packs the shared block
as `pack_tree(apply_dbb_to_tree(...))` of the unpacked tree does.
"""
import dataclasses
import warnings

import pytest
import torch

from test_torch_fixtures import prompts
from test_torch_serve_cli import RUNS, _chosen, _port_run, _reference_run
from test_torch_zamba2 import zcfgs, ztrees
from repro.serve import sampling as jsampling
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import get_config as tget
from repro_torch.core.dbb import DbbWeight
from repro_torch.core.dbb_linear import iter_leaves, pack_tree
from repro_torch.core.sparsity import apply_dbb_to_tree
from repro_torch.models.registry import init_params_by_layer
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
EQUAL = prompts([12] * 6, seed=3)
RAGGED = prompts([5, 12, 9, 3, 12, 7], seed=4)
SERVE_PROMPTS = prompts([6, 11, 4, 9, 7, 13, 5], seed=5)
SERVE_BUDGETS = [4, 8, 2, 6, 3, 5, 7]


def _warned(fn):
    """(fn's result, the messages of the warnings it raised)."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in seen]


def _engines(max_batch):
    jcfg, tcfg = zcfgs("pallas")
    jp, tp = ztrees("packed")
    return (JEngine(jcfg, jp, max_batch=max_batch),
            ServeEngine(tcfg, tp, max_batch=max_batch, device="cpu"))


@pytest.mark.parametrize("batch", ["equal", "ragged"])
@pytest.mark.parametrize("sampled", [False, True])
def test_generate_equals_reference(batch, sampled):
    """Six prompts in 8 slots, 8 new tokens: greedy, or sampled with
    per-request temperatures, seeds and penalties; the ragged greedy batch
    warns that pads feed the recurrent state, as the reference does."""
    jeng, teng = _engines(8)
    ps = EQUAL if batch == "equal" else RAGGED
    jkw = tkw = {}
    if sampled:
        jkw = dict(sampling=[jsampling.SamplingParams(**k) for k in SP_KW])
        tkw = dict(sampling=[tsampling.SamplingParams(**k) for k in SP_KW])
    want, jw = _warned(lambda: jeng.generate(ps, max_new_tokens=8, **jkw))
    got, tw = _warned(lambda: teng.generate(ps, max_new_tokens=8, **tkw))
    assert got == want
    assert tw == jw
    assert bool(tw) == (batch == "ragged" and not sampled)
    assert len(set(map(tuple, got))) == len(got)


@pytest.mark.parametrize("sampled", [False, True])
def test_serve_waves_equal_reference(sampled):
    """Seven ragged requests through 3 slots: three static waves through
    `generate`, outputs cut to their budgets; the fallback's warning (and
    the waves' own) as the reference's; ``draft_k=2`` on the sampled call
    is refused with the reference's warning."""
    jeng, teng = _engines(3)
    jkw = tkw = {}
    if sampled:
        jkw = dict(sampling=[jsampling.SamplingParams(**k)
                             for k in SP_KW + SP_KW[:1]], draft_k=2)
        tkw = dict(sampling=[tsampling.SamplingParams(**k)
                             for k in SP_KW + SP_KW[:1]], draft_k=2)
    want, jw = _warned(lambda: jeng.serve(
        SERVE_PROMPTS, max_new_tokens=SERVE_BUDGETS, **jkw))
    got, tw = _warned(lambda: teng.serve(
        SERVE_PROMPTS, max_new_tokens=SERVE_BUDGETS, **tkw))
    assert got == want
    assert [len(o) for o in got] == SERVE_BUDGETS
    assert tw == jw
    assert tw[0].startswith("zamba2: continuous batching needs")
    spec = [w for w in tw if w.startswith("speculative decode disabled")]
    assert len(spec) == (3 if sampled else 0)
    assert all("family 'zamba2' has no slot-addressed K/V cache" in w
               for w in spec)


def test_draft_k_engine_default_is_refused():
    """An engine built with ``draft_k=2`` samples plainly (with the
    warning): its streams equal a ``draft_k=0`` engine's."""
    _, tcfg = zcfgs("pallas")
    _, tp = ztrees("packed")
    sp = [tsampling.SamplingParams(**k) for k in SP_KW]
    plain = ServeEngine(tcfg, tp, max_batch=8, device="cpu").generate(
        EQUAL, max_new_tokens=6, sampling=sp)
    spec, tw = _warned(lambda: ServeEngine(
        tcfg, tp, max_batch=8, device="cpu", draft_k=2).generate(
            EQUAL, max_new_tokens=6, sampling=sp))
    assert spec == plain
    assert tw == ["speculative decode disabled (family 'zamba2' has no "
                  "slot-addressed K/V cache for batched verify) — serving "
                  "with plain sampling"]


@pytest.mark.parametrize("run", ["generate", "serve", "sampled", "draft"])
def test_cli_prompts_routes_and_streams(monkeypatch, capsys, run):
    """``--arch zamba2-1.2b --packed``: the reference CLI's prompts and
    table routes (the tables describe an attention + MLP layer, as the
    reference prints them), and the streams of the ServeEngine call the
    run makes, made directly on the tree `init_params_by_layer` gives."""
    argv = ["--arch", "zamba2-1.2b", "--packed"] + RUNS[run]
    jprompts, jout = _reference_run(monkeypatch, capsys, argv)
    rep, tout = _port_run(capsys, argv)
    assert rep["prompts"] == jprompts
    got, want = _chosen(tout), _chosen(jout)
    if run not in ("serve", "sampled"):
        # a generate run prints the padded prefill table (its prefill is
        # padded), the reference the packed one
        got.pop("prefill attention")
        want.pop("prefill attention")
    assert got == want
    cfg = tget("zamba2-1.2b", smoke=True).replace(gemm_impl="pallas")
    assert rep["cfg"] == cfg
    seed = 3 if run == "sampled" else 0
    tree = init_params_by_layer(cfg, seed=seed, device="cpu", pack=True)
    assert isinstance(tree["shared_block"]["mlp"]["wi"]["w"], DbbWeight)
    sampling = None
    if run in ("sampled", "draft"):
        sampling = [tsampling.SamplingParams(temperature=0.8, seed=seed + i)
                    for i in range(len(rep["prompts"]))]
    eng = ServeEngine(cfg, tree, max_batch=4, device="cpu",
                      draft_k=2 if run == "draft" else 0)
    call = eng.serve if len(rep["prompts"]) > 4 else eng.generate
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = call(rep["prompts"], max_new_tokens=6, sampling=sampling)
    assert rep["outs"] == want


@pytest.mark.parametrize("bits", [8, 4])
def test_init_params_by_layer_packs_as_pack_tree(bits):
    """``pack=True`` (the shared block included) is bit-equal to
    ``pack_tree(apply_dbb_to_tree(...))`` of the ``pack=False`` tree of
    the same seed; the hook sees each layer, the final norm and the
    shared block."""
    cfg = tget("zamba2-1.2b", smoke=True)
    cfg = cfg.replace(dbb=dataclasses.replace(cfg.dbb, weight_bits=bits,
                                              quant_group=32))
    seen = []

    def hook(tree, gen):
        seen.append(sorted(tree))
        return tree
    dense = init_params_by_layer(cfg, seed=5, device="cpu", layer_hook=hook)
    assert seen == [["ln", "mamba"]] * cfg.num_layers + [
        ["scale"], ["attn", "ln_attn", "ln_mlp", "mlp"]]
    packed = init_params_by_layer(cfg, seed=5, device="cpu", pack=True)
    want = pack_tree(apply_dbb_to_tree(dense, cfg.dbb), cfg.dbb)
    la, lb = list(iter_leaves(packed)), list(iter_leaves(want))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert type(x) is type(y)
        if isinstance(x, DbbWeight):
            for f in ("values", "bitmask", "scale"):
                u, v = getattr(x, f), getattr(y, f)
                assert (u is None and v is None) or torch.equal(u, v), f
            assert (x.bits, x.k_dim) == (y.bits, y.k_dim)
        else:
            assert torch.equal(x, y)
    w = packed["shared_block"]["attn"]["q_proj"]["w"]
    assert isinstance(w, DbbWeight) and w.bits == bits
    assert isinstance(packed["layers"]["mamba"]["in_proj"]["w"], DbbWeight)
    assert not isinstance(packed["layers"]["mamba"]["conv_w"], DbbWeight)
