"""The straight-through pieces of the paper's pipeline against the JAX
package's: `ste_dbb` and `fake_quant` (forward bit-equal, gradient equal
to the upstream gradient exactly and to ``jax.grad`` of the reference's
custom VJP), `dbb_schedule_nnz` over a grid of steps, `apply_dbb_to_tree`
with and without the straight-through gradient, `tree_sparsity_report`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import DbbConfig as JDbb
from repro.core import quant as jq
from repro.core import sparsity as js
from repro_torch.config import DbbConfig
from repro_torch.core import quant as tq
from repro_torch.core import sparsity as ts
from repro_torch.core.dbb import dbb_project


def _w(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("nnz", [1, 2, 4, 7, 8])
def test_ste_dbb_forward_and_gradient(nnz):
    w = _w((64, 24))
    g = _w((64, 24), seed=1)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = ts.ste_dbb(wt, 8, nnz)
    assert torch.equal(y.detach(), dbb_project(torch.from_numpy(w), 8, nnz))
    jy = js.ste_dbb(jnp.asarray(w), 8, nnz)
    assert y.detach().numpy().tobytes() == np.asarray(jy).tobytes()
    (gt,) = torch.autograd.grad(y, wt, torch.from_numpy(g))
    assert torch.equal(gt, torch.from_numpy(g))        # straight through
    _, vjp = jax.vjp(lambda a: js.ste_dbb(a, 8, nnz), jnp.asarray(w))
    assert gt.numpy().tobytes() == np.asarray(vjp(jnp.asarray(g))[0]).tobytes()


def test_fake_quant_forward_and_gradient():
    w = _w((48, 16)) * np.linspace(0.1, 3, 16, dtype=np.float32)
    w[:, 3] = 0.0                                    # an all-zero channel
    g = _w((48, 16), seed=2)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = tq.fake_quant(wt)
    jy = jq.fake_quant(jnp.asarray(w))
    assert y.dtype == torch.float32
    assert y.detach().numpy().tobytes() == np.asarray(jy).tobytes()
    (gt,) = torch.autograd.grad(y, wt, torch.from_numpy(g))
    assert torch.equal(gt, torch.from_numpy(g))
    _, vjp = jax.vjp(jq.fake_quant, jnp.asarray(w))
    assert gt.numpy().tobytes() == np.asarray(vjp(jnp.asarray(g))[0]).tobytes()


@pytest.mark.parametrize("start,ramp", [(0, 0), (5, 0), (3, 7), (10, 40),
                                        (0, 1)])
@pytest.mark.parametrize("nnz,enabled", [(4, True), (2, True), (3, True),
                                         (4, False)])
def test_dbb_schedule_nnz_matches(start, ramp, nnz, enabled):
    tc = DbbConfig(nnz=nnz, enabled=enabled)
    jc = JDbb(nnz=nnz, enabled=enabled)
    for step in range(0, 60):
        assert ts.dbb_schedule_nnz(tc, step, start, ramp) == \
            js.dbb_schedule_nnz(jc, step, start, ramp)


def _tree():
    return {"conv0": {"w": _w((72, 16)), "b": _w((16,), 1)},
            "layers": {"mlp": {"wi": {"w": _w((3, 32, 24), 2)},
                               "wo": {"w": _w((3, 24, 32), 3)}},
                       "attn": {"q_proj": {"w": _w((3, 32, 32), 4),
                                           "b": _w((3, 32), 5)}}},
            "embed": {"table": _w((40, 32), 6)}}


@pytest.mark.parametrize("apply_to", [("mlp", "attn_proj"), ("conv",)])
def test_apply_dbb_to_tree_both_modes(apply_to):
    """Equal projections with and without the STE; the STE's gradient into
    the tree is the upstream gradient on every leaf, projected or not."""
    jt = _tree()
    tt = jax.tree_util.tree_map(torch.from_numpy, jt)
    jc = JDbb(enabled=True, apply_to=apply_to)
    tc = DbbConfig(enabled=True, apply_to=apply_to)
    want = js.apply_dbb_to_tree(jt, jc, nnz=3, straight_through=False)
    for st in (False, True):
        got = ts.apply_dbb_to_tree(tt, tc, nnz=3, straight_through=st)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert a.detach().numpy().tobytes() == np.asarray(b).tobytes()
    leaves = [t.requires_grad_(True) for t in jax.tree_util.tree_leaves(tt)]
    got = ts.apply_dbb_to_tree(tt, tc, nnz=3)
    loss = sum((x * x).sum() for x in jax.tree_util.tree_leaves(got))
    grads = torch.autograd.grad(loss, leaves)
    for g, x in zip(grads, jax.tree_util.tree_leaves(got)):
        assert torch.equal(g, 2 * x.detach())
    no_graph = ts.apply_dbb_to_tree(tt, tc, nnz=3, straight_through=False)
    proj = [x for x, p in zip(jax.tree_util.tree_leaves(no_graph), leaves)
            if x is not p]
    assert proj and not any(x.requires_grad for x in proj)


def test_tree_sparsity_report_matches():
    jt = _tree()
    tt = jax.tree_util.tree_map(torch.from_numpy, jt)
    jc = JDbb(enabled=True, apply_to=("mlp", "attn_proj", "conv"))
    tc = DbbConfig(enabled=True, apply_to=("mlp", "attn_proj", "conv"))
    jp = js.apply_dbb_to_tree(jt, jc, nnz=2, straight_through=False)
    tp = ts.apply_dbb_to_tree(tt, tc, nnz=2, straight_through=False)
    got, want = ts.tree_sparsity_report(tp, tc), js.tree_sparsity_report(jp, jc)
    assert list(got) == list(want)
    assert got == pytest.approx(want, abs=1e-7)
    assert got["layers/mlp/wi/w"] == 0.75
