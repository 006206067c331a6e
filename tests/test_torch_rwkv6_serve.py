"""Serving and training the rwkv6 family against the reference, at smoke
width in f32, on the DBB-packed seeded tree of tests/test_torch_rwkv6.py
(`rtrees`).

* `ServeEngine.generate` greedy and sampled (per-request temperatures,
  seeds and penalties), on equal-length and ragged (left-padded) batches,
  with ``gemm_impl="pallas"`` (the reference's Pallas heads in interpret
  mode against the port's plain versions): tokens and warnings equal to
  the JAX engine's. A ragged batch's pads feed the recurrent state in
  both packages alike, and both warn of it on the greedy path;
* `serve` with more requests than ``max_batch``: static waves through
  `generate`, each output cut to its budget, the fallback's warning and,
  on a sampled call, ``draft_k=2`` refused — equal to the JAX engine's;
* the serve CLI on rwkv6-1.6b smoke (``--packed``): the reference CLI's
  prompts and table routes, and its streams against the engine run on
  the tree `init_params_by_layer` gives;
* one training step: the loss and every leaf's gradient at the projected
  params against ``jax.grad`` of the reference's loss (loss rtol 1e-6,
  gradients within 1e-4 of each leaf's max |grad|: the layer-level
  tolerance, since the seeded LoRAs and the decays at the clip carry the
  two packages' different summation orders into the gradients at up to
  ~2.4e-5), under remat "none" and "full"; two steps of the training
  CLI.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fixtures import prompts
from test_torch_rwkv6 import _close, rcfgs, rtrees
from test_torch_serve_cli import RUNS, _chosen, _port_run, _reference_run
from repro.core.sparsity import apply_dbb_to_tree as japply
from repro.serve import sampling as jsampling
from repro.serve.engine import ServeEngine as JEngine
from repro.train.loop import make_loss_fn as j_loss_fn
from repro_torch.config import ShapeSpec
from repro_torch.configs import get_config as tget
from repro_torch.data.pipeline import make_pipeline
from repro_torch.interop import params_from_numpy
from repro_torch.launch import train as ttrain
from repro_torch.models.registry import init_params_by_layer
from repro_torch.serve import sampling as tsampling
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.loop import loss_and_grads, make_loss_fn
from repro_torch.train.tree import tree_leaves

torch.set_num_threads(1)
SP_KW = [dict(temperature=0.8, seed=11),
         dict(temperature=1.2, seed=-5, repetition_penalty=1.3),
         dict(),
         dict(temperature=0.5, seed=7, presence_penalty=0.4,
              frequency_penalty=0.2),
         dict(temperature=0.9, seed=3),
         dict(temperature=0.0, seed=3, frequency_penalty=0.5)]
EQUAL = prompts([16] * 6, seed=3)          # 16: the chunked WKV
RAGGED = prompts([5, 12, 9, 3, 12, 7], seed=4)
SERVE_PROMPTS = prompts([6, 11, 4, 9, 7, 13, 5], seed=5)
SERVE_BUDGETS = [4, 8, 2, 6, 3, 5, 7]


def _warned(fn):
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in seen]


def _engines(max_batch):
    jcfg, tcfg = rcfgs("pallas")
    jp, tp = rtrees("packed")
    return (JEngine(jcfg, jp, max_batch=max_batch),
            ServeEngine(tcfg, tp, max_batch=max_batch, device="cpu"))


def _sampling(mod, n):
    return [mod.SamplingParams(**k) for k in (SP_KW * 2)[:n]]


@pytest.mark.parametrize("batch", ["equal", "ragged"])
@pytest.mark.parametrize("sampled", [False, True])
def test_generate_equals_reference(batch, sampled):
    """Six prompts in 8 slots, 8 new tokens."""
    jeng, teng = _engines(8)
    ps = EQUAL if batch == "equal" else RAGGED
    jkw = dict(sampling=_sampling(jsampling, 6)) if sampled else {}
    tkw = dict(sampling=_sampling(tsampling, 6)) if sampled else {}
    want, jw = _warned(lambda: jeng.generate(ps, max_new_tokens=8, **jkw))
    got, tw = _warned(lambda: teng.generate(ps, max_new_tokens=8, **tkw))
    assert got == want
    assert tw == jw
    assert bool(tw) == (batch == "ragged" and not sampled)
    assert len(set(map(tuple, got))) == len(got)


@pytest.mark.parametrize("sampled", [False, True])
def test_serve_waves_equal_reference(sampled):
    """Seven ragged requests through 3 slots: three static waves, outputs
    cut to their budgets; the warnings (the fallback's, the waves', and
    on the sampled call ``draft_k=2`` refused) as the reference's."""
    jeng, teng = _engines(3)
    jkw = dict(sampling=_sampling(jsampling, 7), draft_k=2) if sampled \
        else {}
    tkw = dict(sampling=_sampling(tsampling, 7), draft_k=2) if sampled \
        else {}
    want, jw = _warned(lambda: jeng.serve(
        SERVE_PROMPTS, max_new_tokens=SERVE_BUDGETS, **jkw))
    got, tw = _warned(lambda: teng.serve(
        SERVE_PROMPTS, max_new_tokens=SERVE_BUDGETS, **tkw))
    assert got == want
    assert [len(o) for o in got] == SERVE_BUDGETS
    assert tw == jw
    assert tw[0].startswith("rwkv6: continuous batching needs")
    spec = [w for w in tw if w.startswith("speculative decode disabled")]
    assert len(spec) == (3 if sampled else 0)
    assert all("family 'rwkv6' has no slot-addressed K/V cache" in w
               for w in spec)


@pytest.mark.parametrize("run", ["generate", "serve", "sampled"])
def test_cli_prompts_routes_and_streams(monkeypatch, capsys, run):
    """``--arch rwkv6-1.6b --packed``: the reference CLI's prompts and
    table routes (the tables describe an attention + MLP layer, as the
    reference prints them for every family), and the streams the run
    prints equal the engine's on the tree `init_params_by_layer` gives."""
    argv = ["--arch", "rwkv6-1.6b", "--packed"] + RUNS[run]
    jprompts, jout = _reference_run(monkeypatch, capsys, argv)
    rep, tout = _port_run(capsys, argv)
    assert rep["prompts"] == jprompts
    got, want = _chosen(tout), _chosen(jout)
    if run != "serve" and run != "sampled":
        got.pop("prefill attention")
        want.pop("prefill attention")
    assert got == want
    cfg = tget("rwkv6-1.6b", smoke=True).replace(gemm_impl="pallas")
    assert rep["cfg"] == cfg
    seed = 3 if run == "sampled" else 0
    tree = init_params_by_layer(cfg, seed=seed, device="cpu", pack=True)
    eng = ServeEngine(cfg, tree, max_batch=4, device="cpu")
    sampling = None
    if run == "sampled":
        sampling = [tsampling.SamplingParams(temperature=0.8, seed=seed + i)
                    for i in range(len(rep["prompts"]))]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fn = eng.serve if run in ("serve", "sampled") else eng.generate
        assert fn(rep["prompts"], max_new_tokens=6,
                  sampling=sampling) == rep["outs"]


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_gradients_match_jax_grad(remat):
    """S 32 (two chunks of the chunked WKV under autograd), B2."""
    jcfg, tcfg = rcfgs(remat=remat)
    jp, _ = rtrees()
    p = jax.tree_util.tree_map(np.asarray, japply(
        jp, jcfg.dbb, nnz=4, straight_through=False))
    b = make_pipeline(tcfg, ShapeSpec("t", 32, 2, "train"),
                      seed=1).batch_at(0)
    (_, jm), jg = jax.value_and_grad(
        j_loss_fn(jcfg, project_dbb=False), has_aux=True)(
        p, {k: jnp.asarray(v) for k, v in b.items()})
    tg, tm = loss_and_grads(make_loss_fn(tcfg, project_dbb=False),
                            params_from_numpy(p),
                            {k: torch.from_numpy(v) for k, v in b.items()})
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-6)
    jleaves = jax.tree_util.tree_leaves(jg)
    tleaves = tree_leaves(tg)
    assert len(tleaves) == len(jleaves)
    for g, w in zip(tleaves, jleaves):
        assert np.abs(np.asarray(w)).max() > 0.0
        _close(np.asarray(g), w, 1e-4)


def test_train_cli_runs_rwkv6():
    lines, rep = [], {}
    assert ttrain.main(["--arch", "rwkv6-1.6b", "--steps", "2", "--seq-len",
                        "32", "--batch", "2"], device="cpu",
                       log=lines.append, report=rep) == 0
    assert rep["state"].step == 2
    assert all(bool(torch.isfinite(a).all())
               for a in tree_leaves(rep["state"].params))
