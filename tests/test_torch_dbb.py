"""The port's DBB format against the JAX reference: the same numpy-seeded
weights go through `repro.core` and `repro_torch.core`.

Tolerance: none — masks, values, bitmask, indices and decompressed planes
must be byte-equal (the bitmask is int32 in the port, uint32 in the
reference: the same bytes below bit 31).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import dbb as jdbb
from repro.core.dbb_linear import decompress_xla
from repro.core.dbb_linear import pack_tree as jpack_tree
from repro.core.dbb_linear import tree_footprint_bytes as jfootprint
from repro.core.sparsity import apply_dbb_to_tree as japply
from repro.models import registry as jregistry
from repro_torch.config import DbbConfig as TDbbConfig
from repro_torch.core import dbb as tdbb
from repro_torch.core.dbb_linear import decompress, pack_tree, tree_footprint_bytes
from repro_torch.core.sparsity import apply_dbb_to_tree
from repro_torch.interop import params_from_numpy

torch.set_num_threads(1)


def _weights(kind: str, k: int = 64, n: int = 24, seed: int = 0):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.standard_normal((k, n)).astype(np.float32)
    if kind == "ties":       # small integers: many equal magnitudes
        return rng.integers(-2, 3, (k, n)).astype(np.float32)
    # sparse: whole blocks with fewer than nnz non-zeros, and all-zero ones
    w = rng.standard_normal((k, n)).astype(np.float32)
    w[rng.random((k, n)) < 0.7] = 0.0
    w[:8] = 0.0
    return w


def _bytes(a) -> bytes:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return np.ascontiguousarray(a).tobytes()


KINDS = ("normal", "ties", "sparse")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nnz", [1, 2, 4, 8])
def test_mask_and_project_byte_equal(kind, nnz):
    w = _weights(kind)
    jm = jdbb.dbb_mask(jnp.asarray(w), 8, nnz)
    tm = tdbb.dbb_mask(torch.from_numpy(w), 8, nnz)
    assert _bytes(jm) == _bytes(tm.numpy())
    jp = jdbb.dbb_project(jnp.asarray(w), 8, nnz)
    tp = tdbb.dbb_project(torch.from_numpy(w), 8, nnz)
    assert _bytes(jp) == _bytes(tp.numpy())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nnz", [2, 4])
def test_pack_planes_byte_equal(kind, nnz):
    w = _weights(kind, seed=1)
    jp = jdbb.pack_dbb(jnp.asarray(w), 8, nnz)
    tp = tdbb.pack_dbb(torch.from_numpy(w), 8, nnz)
    assert tp.bitmask.dtype == torch.int32
    assert _bytes(jp.values) == _bytes(tp.values.numpy())
    assert _bytes(jp.bitmask) == _bytes(tp.bitmask.numpy())
    assert _bytes(jp.indices) == _bytes(tp.indices.numpy())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("stripped", [False, True])
def test_unpack_byte_equal(kind, stripped):
    """With indices (one-hot path) and stripped (bitmask-rank path)."""
    w = _weights(kind, seed=2)
    jp = jdbb.pack_dbb(jnp.asarray(w), 8, 4)
    tp = tdbb.pack_dbb(torch.from_numpy(w), 8, 4)
    if stripped:
        import dataclasses
        jp = dataclasses.replace(jp, indices=None)
        tp = dataclasses.replace(tp, indices=None)
    assert _bytes(jdbb.unpack_dbb(jp)) == _bytes(tdbb.unpack_dbb(tp).numpy())


@pytest.fixture(scope="module")
def smoke_trees():
    cfg = get_config("olmo-1b", smoke=True)
    params = jregistry.init_params(jax.random.PRNGKey(0), cfg)
    jproj = japply(params, cfg.dbb, straight_through=False)
    jpacked = jpack_tree(jproj, cfg.dbb)
    tcfg = TDbbConfig(enabled=True, block=8, nnz=4)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    return cfg, jproj, jpacked, tcfg, tparams


def test_tree_projection_and_packing_byte_equal(smoke_trees):
    """apply_dbb_to_tree → pack_tree on the smoke param tree: every leaf's
    planes byte-equal, including the stacked [L, K, N] layer leaves."""
    _, jproj, jpacked, tcfg, tparams = smoke_trees
    tproj = apply_dbb_to_tree(tparams, tcfg)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jproj):
        t = tproj
        for p in path:
            t = t[p.key]
        assert _bytes(leaf) == _bytes(t.numpy()), path
    tpacked = pack_tree(tproj, tcfg)
    jl = jax.tree_util.tree_leaves_with_path(
        jpacked, is_leaf=lambda x: isinstance(x, jdbb.DbbWeight))
    n_packed = 0
    for path, leaf in jl:
        keys = [p.key for p in path]
        t = tpacked
        for k in keys:
            t = t[k]
        if isinstance(leaf, jdbb.DbbWeight):
            n_packed += 1
            assert isinstance(t, tdbb.DbbWeight)
            assert leaf.indices is None and t.indices is None
            assert (t.block, t.nnz, t.k_dim) == (leaf.block, leaf.nnz,
                                                 leaf.k_dim)
            assert _bytes(leaf.values) == _bytes(t.values.numpy())
            assert _bytes(leaf.bitmask) == _bytes(t.bitmask.numpy())
            # decompressed stacked planes, byte-equal to decompress_xla
            assert _bytes(decompress_xla(leaf)) == _bytes(
                decompress(t).numpy())
        else:
            assert _bytes(leaf) == _bytes(t.numpy())
    assert n_packed == 7          # q/k/v/o + wi/wg/wo
    assert tree_footprint_bytes(tpacked) == jfootprint(jpacked)


def test_interop_reads_packed_leaves(smoke_trees):
    """params_from_numpy carries the reference's packed leaves over as
    they are (values, int32 bitmask, static fields)."""
    _, _, jpacked, _, _ = smoke_trees
    t = params_from_numpy(jax.tree_util.tree_map(np.asarray, jpacked))
    w = t["layers"]["mlp"]["wi"]["w"]
    j = jpacked["layers"]["mlp"]["wi"]["w"]
    assert isinstance(w, tdbb.DbbWeight)
    assert w.bitmask.dtype == torch.int32
    assert _bytes(j.bitmask) == _bytes(w.bitmask.numpy())
    assert (w.k_dim, w.bits, w.group) == (j.k_dim, j.bits, j.group)


def test_config_fields_match_reference():
    """Every field of the port's configs exists in the reference's under
    the same name and default, and the olmo-1b configs agree."""
    import dataclasses

    from repro import config as jc
    from repro_torch import config as tc
    from repro_torch.configs import get_config as tget
    for tcls, jcls in ((tc.ModelConfig, jc.ModelConfig),
                       (tc.DbbConfig, jc.DbbConfig),
                       (tc.MoeConfig, jc.MoeConfig),
                       (tc.SsmConfig, jc.SsmConfig)):
        jfields = {f.name: f for f in dataclasses.fields(jcls)}
        for f in dataclasses.fields(tcls):
            assert f.name in jfields, f.name
            tv, jv = getattr(tcls(), f.name), getattr(jcls(), f.name)
            if f.name in ("moe", "ssm"):   # the sub-configs, field for field
                tv, jv = dataclasses.asdict(tv), dataclasses.asdict(jv)
            if f.name != "dbb":
                assert tv == jv, f.name
    for smoke in (False, True):
        jcfg, tcfg = get_config("olmo-1b", smoke), tget("olmo-1b", smoke)
        for f in dataclasses.fields(tcfg):
            tv, jv = getattr(tcfg, f.name), getattr(jcfg, f.name)
            if f.name in ("moe", "ssm"):
                tv, jv = dataclasses.asdict(tv), dataclasses.asdict(jv)
            if f.name == "dbb":      # the port's DbbConfig fields
                names = [g.name for g in dataclasses.fields(tv)]
                tv = [getattr(tv, g) for g in names]
                jv = [getattr(jv, g) for g in names]
            assert tv == jv, f.name

