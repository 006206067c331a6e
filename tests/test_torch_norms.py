"""`models.common.norm_apply` / `norm_init` of the port against the
reference's for RMSNorm, LayerNorm and the non-parametric LayerNorm: f32
inputs within rtol 1e-6, bf16 inputs equal (the statistics run in f32 and
the one rounding is the last). Inputs, scales and biases from numpy with a
fixed seed, at a few shapes and at stacked [L, d] parameters' rows."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jc
from repro_torch.models import common as tc

KINDS = ("rmsnorm", "layernorm", "nonparam_ln")


def _operands(kind, shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3 + 0.5).astype(np.float32)
    d = shape[-1]
    p = {}
    if kind != "nonparam_ln":
        p["scale"] = (1 + 0.3 * rng.standard_normal(d)).astype(np.float32)
    if kind == "layernorm":
        p["bias"] = (0.3 * rng.standard_normal(d)).astype(np.float32)
    return x, p


@pytest.mark.parametrize("shape", [(4, 128), (2, 5, 96), (1, 1, 7)])
@pytest.mark.parametrize("kind", KINDS)
def test_norm_f32_matches_reference(kind, shape):
    x, p = _operands(kind, shape, seed=len(shape) + shape[-1])
    want = jc.norm_apply(kind, {k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    got = tc.norm_apply(kind, {k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_norm_bf16_equals_reference(kind, param_dtype):
    """bf16 activations (and bf16 or f32 parameters): the outputs are the
    same bf16 values."""
    x, p = _operands(kind, (3, 6, 256), seed=7)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jdt = jnp.dtype(param_dtype)
    tdt = getattr(torch, param_dtype)
    want = jc.norm_apply(kind, {k: jnp.asarray(v).astype(jdt)
                                for k, v in p.items()}, jx)
    got = tc.norm_apply(kind, {k: torch.from_numpy(v).to(tdt)
                               for k, v in p.items()},
                        torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("kind", KINDS)
def test_norm_init_matches_reference_and_stacks(kind):
    """The reference's parameters at lead (), stacked [L, d] at lead (L,),
    whose row l normalizes as the unstacked parameters do."""
    want = jc.norm_init(kind, 64, jnp.float32)
    got = tc.norm_init(kind, (), 64, torch.float32, "cpu")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    stacked = tc.norm_init(kind, (3,), 64, torch.float32, "cpu")
    assert all(tuple(v.shape) == (3, 64) for v in stacked.values())
    x = torch.from_numpy(_operands(kind, (2, 64), seed=1)[0])
    row = {k: v[1] for k, v in stacked.items()}
    assert torch.equal(tc.norm_apply(kind, row, x),
                       tc.norm_apply(kind, got, x))


def test_norm_refuses_unknown_kinds():
    with pytest.raises(ValueError):
        tc.norm_init("batchnorm", (), 8, torch.float32, "cpu")
    with pytest.raises(ValueError):
        tc.norm_apply("batchnorm", {}, torch.zeros(2, 8))
