"""The moe_lm family's building blocks against the reference, on the CPU in
f32: routing (`_route`: ``top_idx`` exact, ``top_p`` within 1e-6, the aux
loss within 1e-6 relative — the reference counts ``f_e`` by adding
``1/size`` per pair, the port counts ones and divides once — and ties
going to the lower expert index as ``jax.lax.top_k`` orders them),
`_capacity` over a grid of token counts (exact), the sort-based dispatch
and combine with and without drops and with out-of-range experts,
`_expert_ffn` on both of its routes (8 experts: a per-expert loop of
`dispatch.matmul` calls on the kernel route; 32: batched products), and
`moe_apply` with the dense residual MLP (atol / rtol 1e-5).

Also: the configs (fields, `param_count`, `active_param_count`), the init
layout, `init_params_by_layer(pack=True)` against packing its unpacked
tree, the packing policy (experts packed, router and ``dense_mlp`` not),
`interop.params_from_numpy` on a packed MoE tree, the transformer's rule
that MoE layers are expanded to dense on the kernel route, and that
expand (`dbb_linear.decompress`) bit-equal to `unpack_dbb` of each matrix
of a stack.

`moe_cfgs` / `moe_trees` are the shared set-up of the other
tests/test_torch_moe_*.py files: arctic-480b smoke, and a kimi-shaped
config (kimi-k2 smoke with top-8 of 32 experts, so the expert FFN takes
the batched route on both gemm_impl routes); weights from the reference's
`init_params` with tests/test_torch_fixtures.py's scaling and seeded norm
scales, optionally DBB-projected and packed by the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fixtures import _seeded_norms_and_biases, configs
from repro.configs import get_config as jget
from repro.core.dbb_linear import pack_tree as jpack_tree
from repro.core.sparsity import apply_dbb_to_tree as japply
from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro_torch.config import MoeConfig
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import get_config as tget
from repro_torch.core.dbb import DbbWeight
from repro_torch.core.dbb_linear import iter_leaves, pack_tree
from repro_torch.core.sparsity import apply_dbb_to_tree, dbb_eligible
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttf

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = {"arctic": "arctic-480b", "kimi": "kimi-k2-1t-a32b"}
KIMI_MOE = dict(num_experts=32, top_k=8)


def moe_cfgs(gemm_impl="pallas", kind="arctic", **kw):
    """(reference config, port config): arctic-480b smoke, or kimi-k2
    smoke with top-8 of 32 experts (``kind="kimi"``), f32."""
    jcfg, tcfg = configs(gemm_impl, arch=ARCH[kind], **kw)
    if kind == "kimi":
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **KIMI_MOE))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, **KIMI_MOE))
    return jcfg, tcfg


_TREES = {}


def moe_trees(kind="arctic", weights="packed", seed=0):
    """(reference tree, the port's copy), built once per key: the
    reference's init with the embedding scaled by 0.1, the layers by 3 and
    seeded norm scales; ``weights="packed"`` projects and packs it with the
    reference's `apply_dbb_to_tree` / `pack_tree`."""
    key = (kind, weights, seed)
    if key not in _TREES:
        jcfg, _ = moe_cfgs(kind=kind)
        p = jax.tree_util.tree_map(
            np.asarray, jreg.init_params(jax.random.PRNGKey(seed), jcfg))
        p["embed"]["table"] = p["embed"]["table"] * np.float32(0.1)
        p["layers"] = jax.tree_util.tree_map(lambda a: a * np.float32(3.0),
                                             p["layers"])
        p = _seeded_norms_and_biases(p, seed)
        if weights == "packed":
            p = jpack_tree(japply(p, jcfg.dbb, straight_through=False),
                           jcfg.dbb)
        jp = jax.tree_util.tree_map(jnp.asarray, p)
        _TREES[key] = jp, params_from_numpy(
            jax.tree_util.tree_map(np.asarray, p))
    return _TREES[key]


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["arctic", "kimi"])
def test_route_matches_reference(kind):
    jcfg, tcfg = moe_cfgs(kind=kind)
    e = tcfg.moe.num_experts
    x, w = _np(1, 37, 64), _np(2, 64, e, scale=0.5)
    ji, jpp, jaux = jmoe._route(jnp.asarray(x), jnp.asarray(w), jcfg)
    ti, tpp, taux = tmoe._route(torch.from_numpy(x), torch.from_numpy(w),
                                tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tpp.numpy(), np.asarray(jpp), rtol=1e-6,
                               atol=1e-6)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)


def test_route_ties_take_the_lower_expert_first():
    """Equal router columns give bit-equal gates: the port picks the
    lower expert index first, as jax.lax.top_k does. All-equal gates
    (a zero router) pick experts 0..k-1 in order."""
    jcfg, tcfg = moe_cfgs(kind="kimi")
    x, w = _np(3, 20, 64), _np(4, 64, 32, scale=0.5)
    for a, b in ((3, 5), (1, 6), (0, 31), (7, 8), (9, 2)):
        w[:, b] = w[:, a]
    ji, _, _ = jmoe._route(jnp.asarray(x), jnp.asarray(w), jcfg)
    ti, _, _ = tmoe._route(torch.from_numpy(x), torch.from_numpy(w), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    zero = torch.zeros((64, 32))
    ti, tpp, _ = tmoe._route(torch.from_numpy(x), zero, tcfg)
    assert (ti == torch.arange(8)).all()
    np.testing.assert_allclose(tpp.numpy(), 1 / 8, rtol=1e-6)


@pytest.mark.parametrize("moe", [dict(num_experts=8, top_k=2),
                                 dict(num_experts=32, top_k=8),
                                 dict(num_experts=16, top_k=2,
                                      capacity_factor=1.0),
                                 dict(num_experts=128, top_k=2,
                                      capacity_factor=16.0),
                                 dict(num_experts=384, top_k=8)])
def test_capacity_matches_reference(moe):
    jcfg, tcfg = moe_cfgs()
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe))
    tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, **moe))
    for tokens in list(range(0, 300)) + [512, 1000, 4096, 5120, 16384]:
        assert tmoe._capacity(tokens, tcfg) == jmoe._capacity(tokens, jcfg)


# ---------------------------------------------------------------------------
# dispatch, experts, the block
# ---------------------------------------------------------------------------

def _experts(seed, e, d=64, f=48):
    return {"wi": _np(seed, e, d, f, scale=0.2),
            "wg": _np(seed + 1, e, d, f, scale=0.2),
            "wo": _np(seed + 2, e, f, d, scale=0.2)}


@pytest.mark.parametrize("gemm_impl", ["pallas", "xla"])
@pytest.mark.parametrize("case", ["no_drops", "drops", "out_of_range"])
def test_dispatch_compute_combine_matches_reference(case, gemm_impl):
    """64 tokens, top-2 of 8 experts. ``drops``: the router favours experts
    0 and 1 and capacity is 8, so most of their pairs drop; ``no_drops``:
    capacity 128 (every pair fits); ``out_of_range``: the local slice is
    experts 2..5 (the others sink to the trash slot)."""
    jcfg, tcfg = moe_cfgs(gemm_impl)
    x = _np(5, 64, 64)
    w = _np(6, 64, 8, scale=0.3)
    if case == "drops":
        w[:, :2] += 1.0
    ji, jpp, _ = jmoe._route(jnp.asarray(x), jnp.asarray(w), jcfg)
    ti, tpp, _ = tmoe._route(torch.from_numpy(x), torch.from_numpy(w), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    e0, e_loc, cap = {"no_drops": (0, 8, 128), "drops": (0, 8, 8),
                      "out_of_range": (2, 4, 16)}[case]
    ew = _experts(7, e_loc)
    if case == "drops":
        assert np.bincount(ti.numpy().ravel(), minlength=8).max() > 2 * cap
    want = jmoe._dispatch_compute_combine(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in ew.items()}, ji, jpp,
        e0, e_loc, cap, jcfg)
    got = tmoe._dispatch_compute_combine(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in ew.items()},
        ti, tpp, e0, e_loc, cap, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if case == "out_of_range":
        # a token none of whose experts is local gets exactly zero
        none_local = ~((ti >= 2) & (ti < 6)).any(1)
        assert none_local.any() and not got[none_local].any()


def test_combine_is_repeatable_bit_for_bit():
    """Two calls on the same inputs give the same bits (the combine adds a
    token's contributions in a fixed order, with no atomics)."""
    _, tcfg = moe_cfgs("xla", kind="kimi")
    x = torch.from_numpy(_np(8, 50, 64))
    ti, tpp, _ = tmoe._route(x, torch.from_numpy(_np(9, 64, 32)), tcfg)
    ew = {k: torch.from_numpy(v) for k, v in _experts(10, 32).items()}
    a = tmoe._dispatch_compute_combine(x, ew, ti, tpp, 0, 32, 16, tcfg)
    b = tmoe._dispatch_compute_combine(x, ew, ti, tpp, 0, 32, 16, tcfg)
    assert torch.equal(a, b)


def test_combine_order_ignores_the_order_of_a_tokens_top_k():
    """A token's k contributions are added in ascending expert order
    whatever order its (expert, weight) pairs come in: reversing or
    shuffling the k columns gives the same bits (bf16, top-8 of 32, with
    drops)."""
    _, tcfg = moe_cfgs("xla", kind="kimi")
    x = torch.from_numpy(_np(11, 50, 64)).to(torch.bfloat16)
    ti, tpp, _ = tmoe._route(x, torch.from_numpy(_np(12, 64, 32)), tcfg)
    ew = {k: torch.from_numpy(v).to(torch.bfloat16)
          for k, v in _experts(13, 32).items()}
    want = tmoe._dispatch_compute_combine(x, ew, ti, tpp, 0, 32, 8, tcfg)
    shuffle = torch.from_numpy(np.random.default_rng(14).permutation(8))
    for cols in (torch.arange(7, -1, -1), shuffle):
        got = tmoe._dispatch_compute_combine(x, ew, ti[:, cols],
                                             tpp[:, cols], 0, 32, 8, tcfg)
        assert torch.equal(got, want)


@pytest.mark.parametrize("gemm_impl", ["pallas", "xla"])
@pytest.mark.parametrize("e", [8, 32])
def test_expert_ffn_matches_reference(e, gemm_impl, monkeypatch):
    """Both routes of `_expert_ffn`: at 8 experts on the kernel route,
    3 `dispatch.matmul` calls an expert, every expert (the empty ones'
    zero rows included); at 32, and on the plain route, none."""
    jcfg, tcfg = moe_cfgs(gemm_impl)
    xs = _np(11, e, 16, 64)
    xs[1] = 0.0                                     # an empty expert
    ew = _experts(12, e)
    want = jmoe._expert_ffn({k: jnp.asarray(v) for k, v in ew.items()},
                            jnp.asarray(xs), jcfg)
    calls = []
    real = dispatch.matmul

    def counting(*a, **k):
        calls.append(tuple(a[0].shape))
        return real(*a, **k)
    monkeypatch.setattr(dispatch, "matmul", counting)
    got = tmoe._expert_ffn({k: torch.from_numpy(v) for k, v in ew.items()},
                           torch.from_numpy(xs), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    fused = gemm_impl == "pallas" and e <= tmoe._FUSED_EXPERT_MAX
    assert len(calls) == (3 * e if fused else 0)
    assert tmoe._FUSED_EXPERT_MAX == jmoe._FUSED_EXPERT_MAX == 16


@pytest.mark.parametrize("gemm_impl", ["pallas", "xla"])
@pytest.mark.parametrize("kind", ["arctic", "kimi"])
def test_moe_apply_with_dense_residual_matches_reference(kind, gemm_impl):
    """One layer's MoE block (router, experts, dense residual MLP) of the
    seeded tree on [2, 7, d]: output and aux loss."""
    jcfg, tcfg = moe_cfgs(gemm_impl, kind=kind)
    jp, tp = moe_trees(kind, "dense")
    jl = jax.tree_util.tree_map(lambda a: a[1], jp["layers"]["moe"])
    tl = ttf._layer(tp["layers"]["moe"], 1)
    assert "dense_mlp" in tl
    x = _np(13, 2, 7, 128)
    want, jaux = jmoe.moe_apply(jl, jcfg, jnp.asarray(x))
    got, taux = tmoe.moe_apply(tl, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)


def test_moe_impl_ep_raises_and_local_auto_agree():
    _, tcfg = moe_cfgs("xla")
    _, tp = moe_trees("arctic", "dense")
    lp = ttf._layer(tp["layers"]["moe"], 0)
    x = torch.from_numpy(_np(14, 1, 5, 128))
    outs = [tmoe.moe_apply(lp, tcfg.replace(moe=dataclasses.replace(
        tcfg.moe, impl=impl)), x)[0] for impl in ("auto", "local")]
    assert torch.equal(outs[0], outs[1])
    with pytest.raises(NotImplementedError, match="Queue 1, item 2"):
        tmoe.moe_apply(lp, tcfg.replace(moe=dataclasses.replace(
            tcfg.moe, impl="ep")), x)
    with pytest.raises(ValueError):
        tmoe.moe_apply(lp, tcfg.replace(moe=dataclasses.replace(
            tcfg.moe, impl="dense")), x)


# ---------------------------------------------------------------------------
# configs, init, packing, interop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["arctic-480b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("smoke", [True, False])
def test_configs_match_reference(arch, smoke):
    j, t = jget(arch, smoke=smoke), tget(arch, smoke=smoke)
    assert dataclasses.asdict(t.moe) == dataclasses.asdict(j.moe)
    for f in ("family", "num_layers", "d_model", "num_heads", "num_kv_heads",
              "resolved_head_dim", "d_ff", "vocab_size", "norm", "act",
              "mlp_gated", "qkv_bias", "rope", "rope_theta", "dtype",
              "remat", "tie_embeddings"):
        assert getattr(t, f) == getattr(j, f), f
    assert dataclasses.asdict(t.dbb) == {
        k: v for k, v in dataclasses.asdict(j.dbb).items()
        if k in dataclasses.asdict(t.dbb)}
    assert MoeConfig() == MoeConfig(**dataclasses.asdict(
        jget("olmo-1b").moe))


@pytest.mark.parametrize("arch", sorted(TARCHS))
def test_param_counts_match_reference(arch):
    for smoke in (True, False):
        j, t = jget(arch, smoke=smoke), tget(arch, smoke=smoke)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
    kimi = tget("kimi-k2-1t-a32b")
    assert 0.9e12 < kimi.param_count() < 1.2e12
    assert kimi.active_param_count() < 0.05 * kimi.param_count()


@pytest.mark.parametrize("kind", ["arctic", "kimi"])
def test_init_params_tree_matches_reference_layout(kind):
    jcfg, tcfg = moe_cfgs(kind=kind)
    jt = jax.eval_shape(lambda k: jreg.init_params(k, jcfg),
                        jax.random.PRNGKey(0))
    tt = treg.init_params(tcfg, seed=0, device="cpu")

    def walk(j, t, path=""):
        assert isinstance(t, dict) == isinstance(j, dict), path
        if isinstance(j, dict):
            assert set(j) == set(t), path
            for k in j:
                walk(j[k], t[k], f"{path}/{k}")
        else:
            assert tuple(t.shape) == tuple(j.shape), path
            assert str(t.dtype).split(".")[-1] == str(j.dtype), path
    walk(jt, tt)
    e = tcfg.moe.num_experts
    assert tuple(tt["layers"]["moe"]["experts"]["wi"].shape) == (
        2, e, 128, 128)
    # the router and experts at the reference's fan-in scales
    std = tt["layers"]["moe"]["router"]["w"].std().item()
    assert std == pytest.approx(1 / 128 ** 0.5, rel=0.1)


@pytest.mark.parametrize("bits", [8, 4])
def test_init_params_by_layer_packs_as_pack_tree(bits):
    """``pack=True`` equals `pack_tree(apply_dbb_to_tree(...))` of the
    unpacked tree of the same seed, leaf for leaf; the experts are packed
    ([L, E, Kc, N] planes), the router and the dense residual MLP stay
    dense f32, as the reference's patterns leave them."""
    _, tcfg = moe_cfgs()
    tcfg = tcfg.replace(dbb=dataclasses.replace(tcfg.dbb, weight_bits=bits))
    dense = treg.init_params_by_layer(tcfg, seed=3, device="cpu")
    packed = treg.init_params_by_layer(tcfg, seed=3, device="cpu",
                                       pack=True)
    want = pack_tree(apply_dbb_to_tree(dense, tcfg.dbb,
                                       straight_through=False), tcfg.dbb)
    for a, b in zip(iter_leaves(packed), iter_leaves(want)):
        assert type(a) is type(b)
        if isinstance(a, DbbWeight):
            assert (a.bits, a.k_dim, a.group) == (b.bits, b.k_dim, b.group)
            for f in ("values", "bitmask", "scale"):
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None)
                assert x is None or torch.equal(x, y)
        else:
            assert torch.equal(a, b)
    moe = packed["layers"]["moe"]
    assert isinstance(moe["experts"]["wi"], DbbWeight)
    assert moe["experts"]["wi"].bits == bits
    assert moe["experts"]["wi"].values.shape[:2] == (2, 8)
    assert isinstance(moe["router"]["w"], torch.Tensor)
    assert moe["router"]["w"].dtype == torch.float32
    assert isinstance(moe["dense_mlp"]["wi"]["w"], torch.Tensor)


def test_packing_policy_matches_reference():
    from repro.core.sparsity import dbb_eligible as j_eligible
    cfg = tget("arctic-480b").dbb
    jcfg = jget("arctic-480b").dbb
    for path in ("layers/moe/experts/wi", "layers/moe/experts/wg",
                 "layers/moe/experts/wo", "layers/moe/router/w",
                 "layers/moe/dense_mlp/wi/w", "layers/moe/dense_mlp/wo/w",
                 "layers/attn/q_proj/w"):
        assert dbb_eligible(path, cfg) == j_eligible(path, jcfg), path
    assert not dbb_eligible("layers/moe/dense_mlp/wi/w", cfg)
    assert dbb_eligible("layers/moe/experts/wi", cfg)


def test_params_from_numpy_carries_a_packed_moe_tree():
    jp, tp = moe_trees("arctic", "packed")
    jm, tm = jp["layers"]["moe"], tp["layers"]["moe"]
    for name in ("wi", "wg", "wo"):
        j, t = jm["experts"][name], tm["experts"][name]
        assert isinstance(t, DbbWeight)
        assert (t.block, t.nnz, t.k_dim, t.bits) == (
            j.block, j.nnz, j.k_dim, j.bits)
        np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
        np.testing.assert_array_equal(
            t.bitmask.numpy(), np.asarray(j.bitmask).view(np.int32))
        assert t.values.ndim == 4 and t.values.shape[:2] == (2, 8)
    np.testing.assert_array_equal(tm["router"]["w"].numpy(),
                                  np.asarray(jm["router"]["w"]))
    np.testing.assert_array_equal(tm["dense_mlp"]["wi"]["w"].numpy(),
                                  np.asarray(jm["dense_mlp"]["wi"]["w"]))


def test_moe_layers_expand_on_the_kernel_route():
    """The reference streams packed weights only for its stream families:
    on the kernel route a moe_lm layer is decompressed to the activation
    dtype (the experts then take the dense kernels), a dense_lm layer stays
    packed; on the plain route both are decompressed."""
    _, tcfg = moe_cfgs("pallas")
    _, tp = moe_trees("arctic", "packed")
    lp = ttf._layer(tp["layers"], 0)
    for cfg in (tcfg, tcfg.replace(gemm_impl="xla")):
        out = ttf._unpack_layer(lp, cfg)
        assert not any(isinstance(a, DbbWeight) for a in iter_leaves(out))
        assert out["moe"]["experts"]["wi"].shape == (8, 128, 128)
    dcfg = tcfg.replace(family="dense_lm")
    out = ttf._unpack_layer(lp, dcfg)
    assert isinstance(out["moe"]["experts"]["wi"], DbbWeight)
    assert ttf._STREAM_FAMILIES == ("dense_lm", "vlm_lm", "audio_lm")


@pytest.mark.parametrize("plane", ["f32", "bf16", "int8_scaled", "int8", "w4"])
@pytest.mark.parametrize("nnz", [2, 4, 8])
def test_decompress_equals_unpack_dbb_per_matrix(plane, nnz):
    """`decompress` (the MoE layers' per-layer expand: one scatter over a
    group of matrices) equals `unpack_dbb` of each matrix of an [L, E, K,
    N] stack bit for bit, in every output dtype, on every values plane,
    with dead slots (all-zero blocks) among the live ones."""
    from repro_torch.core.dbb import pack_dbb, unpack_dbb
    from repro_torch.core.dbb_linear import decompress
    from repro_torch.core.quant import quantize_weight
    g = torch.Generator().manual_seed(nnz)
    ws = [torch.randn((256, 48), generator=g) for _ in range(6)]
    ws[0][:, :5] = 0.0
    ws[3][8:40] = 0.0

    def pack(w):
        if plane == "w4":
            return pack_dbb(w, 8, nnz, bits=4, group=128)
        if plane.startswith("int8"):
            q = quantize_weight(w)
            return pack_dbb(q.q, 8, nnz,
                            scale=q.scale if plane == "int8_scaled" else None)
        return pack_dbb(w.to(torch.bfloat16) if plane == "bf16" else w, 8,
                        nnz)
    ps = [pack(w) for w in ws]
    stacked = DbbWeight(
        values=torch.stack([p.values for p in ps]).reshape(
            2, 3, *ps[0].values.shape),
        bitmask=torch.stack([p.bitmask for p in ps]).reshape(
            2, 3, *ps[0].bitmask.shape),
        scale=None if ps[0].scale is None else torch.stack(
            [p.scale for p in ps]).reshape(2, 3, *ps[0].scale.shape),
        indices=None, block=8, nnz=nnz, k_dim=256, bits=ps[0].bits,
        group=ps[0].group)
    for dtype in (None, torch.bfloat16, torch.float32):
        got = decompress(stacked, dtype=dtype)
        for i, p in enumerate(ps):
            want = unpack_dbb(dataclasses.replace(p, indices=None))
            want = want.to(dtype) if dtype is not None else want
            one = got.reshape(6, 256, 48)[i]
            assert one.dtype == want.dtype
            assert torch.equal(_bits(one), _bits(want))


def _bits(t):
    """The raw bits of ``t`` (so -0.0 and 0.0 differ)."""
    return t.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[t.element_size()])
