"""Training the zamba2 family against the reference, on the CPU in f32:
zamba2-1.2b smoke from the reference's weights (tests/test_torch_zamba2.py's
`ztrees`, DBB-projected at k 4), the port's synthetic batches.

* the loss and every leaf's gradient at the projected params against
  ``jax.grad`` of the reference's loss, under remat "none", "full" and
  "auto" in both packages (loss rtol 1e-6, gradients within 1e-5 of each
  leaf's max |grad|); the sequence length, 32, is a multiple of the
  chunk, so the chunked scan runs under autograd;
* at d_model 1024, where "auto" checkpoints each Mamba layer whole (it
  has no ``mlp_wi`` / ``mlp_wg`` to keep) and the shared block by the
  attention layer's rule, "full", "dots" and "auto" give "none"'s loss
  and gradients;
* the training CLI runs a zamba2 config.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_zamba2 import _close, zcfgs, ztrees
from repro.core.sparsity import apply_dbb_to_tree as japply
from repro.train.loop import make_loss_fn as j_loss_fn
from repro_torch.config import RunConfig, ShapeSpec
from repro_torch.data.pipeline import make_pipeline
from repro_torch.interop import params_from_numpy
from repro_torch.launch import train as ttrain
from repro_torch.train.loop import (init_train_state, loss_and_grads,
                                    make_loss_fn)
from repro_torch.train.tree import tree_leaves

torch.set_num_threads(1)
SHAPE = (32, 2)                     # seq_len, batch


@pytest.mark.parametrize("remat", ["none", "full", "auto"])
def test_loss_and_gradients_match_jax_grad(remat):
    jcfg, tcfg = zcfgs(remat=remat)
    jp, _ = ztrees()
    p = jax.tree_util.tree_map(np.asarray, japply(
        jp, jcfg.dbb, nnz=4, straight_through=False))
    b = make_pipeline(tcfg, ShapeSpec("t", *SHAPE, "train"),
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
        _close(np.asarray(g), w, 1e-5)


@pytest.mark.parametrize("remat", ["full", "dots", "auto"])
def test_remat_keeps_values_and_gradients(remat):
    """Every remat policy gives "none"'s loss and gradients at d_model
    1024 (3 layers: the shared block after the second and the third)."""
    _, tcfg = zcfgs()
    base = tcfg.replace(d_model=1024, num_heads=8, num_kv_heads=8,
                        d_ff=256, num_layers=3, vocab_size=256)
    params = init_train_state(RunConfig(model=base.replace(remat="none")),
                              seed=0, device="cpu").params
    g = torch.Generator().manual_seed(0)
    b = {"tokens": torch.randint(0, 256, (1, 16), generator=g),
         "labels": torch.randint(0, 256, (1, 16), generator=g)}
    (g0, m0), (g1, m1) = [
        loss_and_grads(make_loss_fn(base.replace(remat=r)), params, b)
        for r in ("none", remat)]
    assert torch.equal(m0["loss"], m1["loss"])
    for a, c in zip(tree_leaves(g0), tree_leaves(g1)):
        assert (a - c).abs().max() <= 1e-6 * a.abs().max()


def test_train_cli_runs_a_zamba2_config():
    lines, rep = [], {}
    assert ttrain.main(["--arch", "zamba2-1.2b", "--steps", "2",
                        "--seq-len", "16", "--batch", "2"], device="cpu",
                       log=lines.append, report=rep) == 0
    logged = [json.loads(x) for x in lines if x.startswith("{")]
    assert logged[0]["step"] == 0 and np.isfinite(logged[0]["loss"])
    assert rep["state"].step == 2 and rep["cfg"].family == "zamba2"
    assert "shared_block" in rep["state"].params
