"""The port's CNN (`models/cnn.py`) against the reference's
`repro.models.cnn.cnn_apply`, on the CPU at smoke width: convnet-dbb and
lenet5-dbb, modes ``xla`` / ``sta`` / ``dbb``, with the kernel routes and
with ``use_kernel=False``. Weights come from the reference's
`init_params` through numpy (`params_from_numpy`); packed trees are the
reference's ``apply_dbb_to_tree(straight_through=False)`` + `pack_tree`.
The reference runs its Pallas conv kernels in interpret mode, the port its
kernels' plain versions.

Tolerance: logits rtol 1e-4, atol 1e-4 of the largest |logit| (the two
sum in different orders); predicted classes equal except in rows whose
top-2 margin is under that tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.dbb_linear import pack_tree as jpack_tree
from repro.core.sparsity import apply_dbb_to_tree as japply
from repro.models import cnn as jcnn
from repro.models import registry as jreg
from repro_torch.configs import get_config as tget
from repro_torch.core.dbb import DbbWeight
from repro_torch.core.dbb_linear import pack_tree
from repro_torch.core.sparsity import apply_dbb_to_tree
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.kernels.common import LAUNCHES
from repro_torch.models import cnn as tcnn
from repro_torch.models import registry as treg

torch.set_num_threads(1)
ARCHS = ("convnet-dbb", "lenet5-dbb")
TOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    """arch → (jax cfg, port cfg, jax dense, jax packed, port dense, port
    packed, images)."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jc, tc = jget(arch, smoke=True), tget(arch, smoke=True)
        jd = jreg.init_params(jax.random.PRNGKey(i), jc)
        jp = jpack_tree(japply(jd, jc.dbb, straight_through=False), jc.dbb)
        img = np.random.default_rng(i).standard_normal(
            (4, jc.cnn_img, jc.cnn_img, jc.cnn_in_ch)).astype(np.float32)
        out[arch] = (jc, tc, jd, jp, params_from_numpy(_np(jd)),
                     params_from_numpy(_np(jp)), img)
    return out


def _check_logits(got, want):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)
    top2 = np.sort(want, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > TOL * scale
    np.testing.assert_array_equal(got.argmax(-1)[decided],
                                  want.argmax(-1)[decided])


@pytest.mark.parametrize("arch", ARCHS)
def test_cnn_configs_match_reference(arch):
    for smoke in (False, True):
        jc, tc = jget(arch, smoke), tget(arch, smoke)
        for f in dataclasses.fields(tc):
            tv, jv = getattr(tc, f.name), getattr(jc, f.name)
            if f.name in ("moe", "ssm"):   # the sub-configs, field for field
                tv, jv = dataclasses.asdict(tv), dataclasses.asdict(jv)
            if f.name == "dbb":
                names = [g.name for g in dataclasses.fields(tv)]
                tv = [getattr(tv, g) for g in names]
                jv = [getattr(jv, g) for g in names]
            assert tv == jv, (arch, smoke, f.name)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["xla", "sta", "dbb"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_cnn_apply_matches_reference(trees, arch, mode, use_kernel):
    jc, tc, jd, jp, td, tp, img = trees[arch]
    jparams, tparams = (jp, tp) if mode == "dbb" else (jd, td)
    want = np.asarray(jcnn.cnn_apply(jparams, jc, jnp.asarray(img),
                                     matmul=mode, use_kernel=use_kernel))
    before = dict(LAUNCHES)
    got = tcnn.cnn_apply(tparams, tc, torch.from_numpy(img), matmul=mode,
                         use_kernel=use_kernel).numpy()
    assert LAUNCHES == before             # plain versions on the CPU
    assert got.shape == (4, tc.cnn_classes)
    _check_logits(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_packing_is_byte_equal_to_reference(trees, arch):
    """The port's own projection + packing of the carried-over dense tree
    gives the reference's planes; leaves whose K is not a multiple of 8
    stay dense, and biases are never packed."""
    jc, tc, _, jp, td, _, _ = trees[arch]
    mine = pack_tree(apply_dbb_to_tree(td, tc.dbb), tc.dbb)
    for layer, sub in mine.items():
        ref = jp[layer]
        assert isinstance(sub["b"], torch.Tensor)
        w, jw = sub["w"], ref["w"]
        if isinstance(jw, jnp.ndarray):
            assert isinstance(w, torch.Tensor), layer
            assert w.shape[0] % 8 != 0
            assert w.numpy().tobytes() == np.asarray(jw).tobytes()
            continue
        assert isinstance(w, DbbWeight), layer
        assert (w.k_dim, w.nnz, w.block, w.bits) == (jw.k_dim, jw.nnz,
                                                      jw.block, jw.bits)
        assert w.values.numpy().tobytes() == np.asarray(
            jw.values).tobytes()
        assert w.bitmask.numpy().tobytes() == np.asarray(
            jw.bitmask).view(np.int32).tobytes()
    dense = [k for k, v in mine.items() if not isinstance(v["w"], DbbWeight)]
    assert dense == (["conv0"] if arch == "convnet-dbb"
                     else ["conv0", "conv1"])


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_forward_matches_reference(trees, arch):
    jc, tc, jd, _, td, _, img = trees[arch]
    want, _ = jreg.forward(jd, jc, {"images": jnp.asarray(img)})
    got, aux = treg.forward(td, tc, {"images": torch.from_numpy(img)})
    assert float(aux) == 0.0
    _check_logits(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("h,w", [(6, 6), (7, 5), (5, 9)])
def test_max_pool_matches_reduce_window(h, w):
    x = np.random.default_rng(h * w).standard_normal(
        (2, h, w, 3)).astype(np.float32)
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                 (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
    got = tcnn.max_pool_2x2(torch.from_numpy(x))
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


def test_cnn_routes_per_layer(trees, monkeypatch):
    """At smoke width under ``matmul="dbb"`` convnet's conv0 (K = 27) takes
    the dense conv kernel and conv1 the DBB one; ``use_kernel=False`` pins
    the explicit route."""
    jc, tc, _, _, _, tp, img = trees["convnet-dbb"]
    seen = []
    real = dispatch.select

    def spy(spec, cfg_routes=None):
        name, reasons = real(spec, cfg_routes)
        seen.append((spec.domain, name))
        return name, reasons
    monkeypatch.setattr(dispatch, "select", spy)
    tcnn.cnn_apply(tp, tc, torch.from_numpy(img), matmul="dbb")
    assert seen == [("conv", "conv_sta"), ("conv", "conv_dbb"),
                    ("matmul", "skinny_dbb")]
    seen.clear()
    tcnn.cnn_apply(tp, tc, torch.from_numpy(img), matmul="dbb",
                   use_kernel=False)
    assert seen == [("conv", "conv_xla"), ("conv", "conv_xla"),
                    ("matmul", "skinny_dbb")]


def test_conv_front_door_refuses_w4():
    """The DBB conv kernel refuses a w4 leaf (it streams the bits=8 plane
    only); the front door decompresses the leaf to x's dtype and takes
    the dense routes instead, as the reference does
    (tests/test_torch_w4.py holds it against the reference's conv)."""
    from repro_torch.core.dbb import pack_dbb, unpack_dbb
    g = torch.Generator().manual_seed(0)
    p = pack_dbb(torch.randn((16, 24), generator=g), 8, 4, bits=4, group=16)
    x = torch.randn((1, 4, 4, 16), generator=g)
    spec = dispatch.OpSpec(domain="conv", m=16, k=16, n=24, packed=True,
                           bits=4, group=16, pallas=True,
                           conv_geom=(1, 4, 4, 16, 1, 1, 1))
    assert "bits=4" in dispatch.ROUTES["conv"][0][1](spec)
    for use_kernel in (True, False):
        got = dispatch.conv(x, p, kh=1, kw=1, use_kernel=use_kernel)
        want = dispatch.conv(x, unpack_dbb(p), kh=1, kw=1,
                             use_kernel=use_kernel)
        assert torch.equal(got, want)


def test_cnn_init_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tc = tget("convnet-dbb", smoke=True)
    with pytest.raises(RuntimeError, match="cuda"):
        treg.init_params(tc, seed=0)
    p = treg.init_params(tc, seed=0, device="cpu")
    assert p["conv0"]["w"].shape == (27, 16)
    assert p["fc"]["w"].shape == (32 * 4 * 4, 10)
