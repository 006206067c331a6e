"""Training the moe_lm family against the reference, on the CPU in f32:
arctic-480b smoke from the reference's `init_params` (carried into the
port through numpy), the reference's synthetic batches.

* the loss, the summed aux loss and every leaf's gradient at the projected
  params against ``jax.grad`` of the reference's loss (loss rtol 1e-6,
  aux rtol 1e-5, gradients within 1e-5 of each leaf's max |grad|), with
  the config's aux weight and with a weight of 1 (so the aux loss's own
  gradient, through the router's mean gates, is held too);
* three steps of `train_loop` (AdamW, the bound ramping 8 → 4): the logged
  losses, grad norms and learning rates within rtol 1e-4;
* the loss reads ``cfg.moe.aux_loss_weight``; the remat policies ("full",
  "dots", "auto" at d_model 1024, where a MoE layer keeps only its dense
  MLP's up-projections) give "none"'s loss and gradients; the training CLI
  runs an MoE config.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_moe import moe_cfgs
from repro.config import RunConfig as JRun, ShapeSpec as JShape
from repro.config import TrainConfig as JTrain
from repro.launch.train import train_loop as j_train_loop
from repro.models import registry as jreg
from repro.train.loop import make_loss_fn as j_loss_fn
from repro_torch.config import RunConfig, ShapeSpec, TrainConfig
from repro_torch.configs import get_config as tget
from repro_torch.data.pipeline import make_pipeline
from repro_torch.interop import params_from_numpy
from repro_torch.launch import train as ttrain
from repro_torch.launch.train import train_loop
from repro_torch.train.loop import (init_train_state, loss_and_grads,
                                    make_loss_fn)
from repro_torch.train.tree import tree_leaves

torch.set_num_threads(1)
SHAPE = (16, 4)                     # seq_len, batch


def _cfgs(**moe):
    jcfg, tcfg = moe_cfgs("xla")
    if moe:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, **moe))
    return jcfg, tcfg


def _ref_params(jcfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jreg.init_params(jax.random.PRNGKey(seed), jcfg))


def _batch(tcfg, step=0):
    return make_pipeline(tcfg, ShapeSpec("t", *SHAPE, "train"),
                         seed=1).batch_at(step)


@pytest.mark.parametrize("aux_weight", [0.01, 1.0])
def test_loss_aux_and_gradients_match_jax_grad(aux_weight):
    jcfg, tcfg = _cfgs(aux_loss_weight=aux_weight)
    from repro.core.sparsity import apply_dbb_to_tree as j_apply
    p = jax.tree_util.tree_map(np.asarray, j_apply(
        _ref_params(jcfg), jcfg.dbb, nnz=4, straight_through=False))
    b = _batch(tcfg)
    (jt, jm), jg = jax.value_and_grad(
        j_loss_fn(jcfg, project_dbb=False), has_aux=True)(
        p, {k: jnp.asarray(v) for k, v in b.items()})
    tg, tm = loss_and_grads(make_loss_fn(tcfg, project_dbb=False),
                            params_from_numpy(p),
                            {k: torch.from_numpy(v) for k, v in b.items()})
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-6)
    assert float(tm["aux"]) > 0.0
    assert float(tm["aux"]) == pytest.approx(float(jm["aux"]), rel=1e-5)
    for g, w in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= 1e-5 * scale, (
            np.abs(g - w).max() / scale)


def test_loss_reads_the_configured_aux_weight():
    """total = CE + cfg.moe.aux_loss_weight · aux, for any weight."""
    _, tcfg = _cfgs()
    p = init_train_state(RunConfig(model=tcfg), seed=0, device="cpu").params
    b = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    for w in (0.0, 0.01, 0.5):
        cfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe,
                                                   aux_loss_weight=w))
        with torch.no_grad():
            total, m = make_loss_fn(cfg, nnz=4)(p, b)
        assert float(total) == pytest.approx(
            float(m["loss"]) + w * float(m["aux"]), rel=1e-6)
        assert float(m["aux"]) > 0.0


def test_three_steps_track_the_reference():
    jcfg, tcfg = _cfgs()
    kw = dict(steps=3, learning_rate=3e-3, optimizer="adamw", log_every=1,
              warmup_steps=1, dbb_prune_start=0, dbb_prune_ramp=2, seed=1)
    jrc = JRun(model=jcfg, train=JTrain(**kw))
    trc = RunConfig(model=tcfg, train=TrainConfig(**kw))
    p = _ref_params(jcfg, seed=1)
    _, jh = j_train_loop(jrc, JShape("t", *SHAPE, "train"),
                         log=lambda *_: None)
    _, th = train_loop(trc, ShapeSpec("t", *SHAPE, "train"),
                       log=lambda *_: None, device="cpu",
                       params=params_from_numpy(p))
    assert [h["nnz"] for h in th] == [h["nnz"] for h in jh] == [8, 6, 4]
    for a, b in zip(th, jh):
        assert set(a) == set(b)
        for key in ("loss", "grad_norm", "lr"):
            assert a[key] == pytest.approx(b[key], rel=1e-4), (key, a, b)


@pytest.mark.parametrize("remat", ["full", "dots", "auto"])
def test_remat_keeps_values_and_gradients(remat):
    """Every remat policy gives "none"'s loss and gradients on a MoE model
    at d_model 1024 (where "auto" splits the layer around the dense MLP's
    up-projections)."""
    _, tcfg = _cfgs()
    base = tcfg.replace(d_model=1024, num_heads=8, num_kv_heads=8,
                        d_ff=256, num_layers=2, vocab_size=256,
                        moe=dataclasses.replace(tcfg.moe, num_experts=4,
                                                dense_residual_ff=256))
    params = init_train_state(RunConfig(model=base.replace(remat="none")),
                              seed=0, device="cpu").params
    g = torch.Generator().manual_seed(0)
    b = {"tokens": torch.randint(0, 256, (2, 8), generator=g),
         "labels": torch.randint(0, 256, (2, 8), generator=g)}
    (g0, m0), (g1, m1) = [
        loss_and_grads(make_loss_fn(base.replace(remat=r)), params, b)
        for r in ("none", remat)]
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["aux"], m1["aux"])
    for a, c in zip(tree_leaves(g0), tree_leaves(g1)):
        assert (a - c).abs().max() <= 1e-6 * a.abs().max()


def test_train_cli_runs_a_moe_config():
    lines, rep = [], {}
    assert ttrain.main(["--arch", "arctic-480b", "--steps", "2",
                        "--seq-len", "16", "--batch", "2"], device="cpu",
                       log=lines.append, report=rep) == 0
    logged = [json.loads(x) for x in lines if x.startswith("{")]
    assert logged[0]["step"] == 0 and np.isfinite(logged[0]["loss"])
    assert rep["state"].step == 2 and rep["cfg"].family == "moe_lm"
    assert tget("arctic-480b", smoke=True).moe.aux_loss_weight == 0.01
