"""The port's tensor-parallel spec, cost and guard functions against the
reference's, in one process with fake meshes (as tests/test_tp_dispatch.py
holds the reference's): no rank is spawned.

* `param_specs`, `tp_spec_violations`, `serve_cache_specs` and
  `tp_serve_reason` over the 12 archs' smoke and full configs at tp 2, 4
  and 8, on the reference's own parameter shapes (``jax.eval_shape`` of
  its ``init_params`` and ``pack_tree``, carried as meta tensors): dense,
  packed, INT8-valued and w4 trees, plus a replicated row weight and a
  row-parallel bias. Specs equal entry for entry; the reasons equal but
  for the port's one refusal of its own, a w4 row-parallel leaf.
* `dispatch.explain(tp=, collective=)` against the reference's on the
  port's H100 figures: per-route flops, bytes, collective bytes and cost
  (rel 1e-12), the chosen route, the TP guard reasons and the mesh header.
* The tp-smem pass: clean on the port's registry, and it catches
  tests/fixtures/torch_bad_tp.py, a guard that reads global dims.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.dbb import DbbWeight as JDbb
from repro.core.dbb_linear import pack_tree as jpack
from repro.core.quant import QuantizedWeight as JQuant
from repro.dist import sharding as jsh
from repro.kernels import dispatch as jd
from repro.models import registry as jreg
from repro.roofline.analysis import Hardware as JHardware
from repro.serve import engine as jengine
from repro_torch.analysis import dispatch_check, lint, tp_smem
from repro_torch.configs import ARCHS, get_config as tget
from repro_torch.core.dbb import DbbWeight
from repro_torch.core.quant import QuantizedWeight
from repro_torch.dist import sharding as tsh
from repro_torch.dist.mesh_ctx import shard_tp_ctx, use_mesh
from repro_torch.kernels import dispatch as td
from repro_torch.roofline.analysis import HW_H100, Hardware
from repro_torch.serve import engine as tengine

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
TPS = (2, 4, 8)
# the port's H100 figures as a reference Hardware
J_H100 = JHardware(**dataclasses.asdict(HW_H100))
V5E = Hardware(name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
               ici_link_bw=50e9, ici_links=4)


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)

    def __hash__(self):
        return hash(tuple(self.shape.items()))


def _mesh(tp, data=1):
    return _FakeMesh({"data": data, "model": tp})


def _meta(tree):
    """The port's tree of meta tensors for a reference tree of shapes."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, JDbb):
        def m(a):
            return None if a is None else torch.empty(a.shape, device="meta")
        return DbbWeight(values=m(tree.values), indices=m(tree.indices),
                         bitmask=m(tree.bitmask), scale=m(tree.scale),
                         block=tree.block, nnz=tree.nnz, k_dim=tree.k_dim,
                         bits=tree.bits, group=tree.group)
    if isinstance(tree, JQuant):
        return QuantizedWeight(q=torch.empty(tree.q.shape, device="meta"),
                               scale=torch.empty(tree.scale.shape,
                                                 device="meta"))
    return torch.empty(tree.shape, device="meta")


_TREES = {}


def _trees(arch, smoke):
    """{kind: (reference shape tree, port meta tree)} for one config:
    dense, packed (f32 planes), INT8-valued planes and w4 planes."""
    key = (arch, smoke)
    if key not in _TREES:
        cfg = jget(arch, smoke=smoke)
        sds = jax.eval_shape(
            lambda: jreg.init_params(jax.random.PRNGKey(0), cfg))
        out = {"dense": sds}
        if cfg.dbb.enabled:
            w4 = dataclasses.replace(cfg.dbb, weight_bits=4)
            out["packed"] = jax.eval_shape(lambda p: jpack(p, cfg.dbb), sds)
            out["int8"] = jax.eval_shape(
                lambda p: jpack(p, cfg.dbb, quantize=True), sds)
            out["w4"] = jax.eval_shape(lambda p: jpack(p, w4), sds)
        _TREES[key] = {k: (v, _meta(v)) for k, v in out.items()}
    return _TREES[key]


def _flat(specs):
    """``{"a/b/field": entries}`` of a port spec tree."""
    return {"/".join(n): tuple(s) for n, s in tsh._flatten(specs)}


def _flat_ref(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(jsh._names(p)): tuple(s) for p, s in flat}


def _cases():
    return [(a, s) for a in ARCHS for s in (True, False)]


@pytest.mark.parametrize("arch,smoke", _cases())
def test_param_specs_and_violations_equal_reference(arch, smoke):
    jcfg, tcfg = jget(arch, smoke=smoke), tget(arch, smoke=smoke)
    for kind, (jt, tt) in _trees(arch, smoke).items():
        for tp in TPS:
            for data, fsdp in ((1, None), (2, 1 << 10)):
                mesh = _mesh(tp, data)
                js = jsh.param_specs(jt, mesh, jcfg,
                                     fsdp_min_shard_elems=fsdp)
                ts = tsh.param_specs(tt, mesh, tcfg,
                                     fsdp_min_shard_elems=fsdp)
                assert _flat(ts) == _flat_ref(js), \
                    (kind, tp, data, fsdp)
                assert (tsh.tp_spec_violations(tt, ts)
                        == jsh.tp_spec_violations(jt, js)), (kind, tp)


@pytest.mark.parametrize("arch,smoke", _cases())
def test_tp_serve_reason_equals_reference(arch, smoke):
    """The wrap's verdict and reason, config by config and tree by tree
    (the text after a " — " explains the cause in each package's terms);
    the port refuses w4 row leaves the reference would admit, and that is
    its only difference."""
    def cause(reason):
        return reason.split(" — ")[0]

    for impl in ("pallas", "xla"):
        jcfg = jget(arch, smoke=smoke).replace(gemm_impl=impl)
        tcfg = tget(arch, smoke=smoke).replace(gemm_impl=impl)
        for tp in TPS:
            mesh = _mesh(tp)
            assert (cause(tengine.tp_serve_reason(tcfg, mesh))
                    == cause(jengine.tp_serve_reason(jcfg, mesh)))
            for kind, (jt, tt) in _trees(arch, smoke).items():
                want = cause(jengine.tp_serve_reason(jcfg, mesh, jt))
                got = cause(tengine.tp_serve_reason(tcfg, mesh, tt))
                if kind == "w4" and want == "" and tsh.w4_row_leaves(tt):
                    assert got.startswith("bits=4 row-parallel leaves")
                else:
                    assert got == want, (kind, tp)


def test_tp_serve_reason_conditions_and_w4():
    """The reference's test_tp_serve_reason_conditions on the port, a
    replicated row weight, a row-parallel bias and a w4 row leaf."""
    from repro_torch.config import ModelConfig
    tp4 = _mesh(4)
    cfg = ModelConfig(family="dense_lm", d_model=64, d_ff=256,
                      num_layers=1, num_heads=8, num_kv_heads=4,
                      vocab_size=128, gemm_impl="pallas")
    r = tengine.tp_serve_reason
    assert "no live mesh" in r(cfg, None)
    assert "gemm_impl" in r(cfg.replace(gemm_impl="xla"), tp4)
    assert "moe" in r(cfg.replace(family="moe_lm"), tp4).lower()
    assert "heads" in r(cfg.replace(num_kv_heads=3), tp4)
    assert "d_ff" in r(cfg.replace(d_ff=130), tp4)
    assert "vocab" in r(cfg.replace(vocab_size=130), tp4)
    assert r(cfg, tp4) == ""
    meta = lambda *s: torch.empty(s, device="meta")         # noqa: E731
    bad = {"layers": {"o_proj": {"w": meta(126, 64)},
                      "q_proj": {"w": meta(64, 128)}}}
    assert "o_proj/w" in r(cfg, tp4, bad)
    bias = {"layers": {"wo": {"w": meta(256, 64), "b": meta(64)}}}
    assert "row-parallel bias" in r(cfg, tp4, bias)
    w4 = DbbWeight(values=meta(64, 64), indices=None, bitmask=meta(32, 64),
                   scale=meta(2, 64), block=8, nnz=4, k_dim=256, bits=4,
                   group=128)
    assert r(cfg, tp4, {"layers": {"wo": {"w": w4}}}).startswith(
        "bits=4 row-parallel leaves: ")
    # the same plane on a column leaf splits N, scales included: served
    assert r(cfg, tp4, {"layers": {"wi": {"w": w4}}}) == ""


@pytest.mark.parametrize("tp", TPS)
def test_serve_cache_specs_equal_reference(tp):
    """Contiguous and paged caches of the port's own `init_cache` /
    `init_paged_cache` (meta tensors) against the reference's specs of
    the same shapes."""
    from repro_torch.models import registry as treg
    from repro_torch.serve.kv_cache import init_paged_cache
    mesh = _mesh(tp)
    for arch in ("olmo-1b", "qwen2.5-14b", "starcoder2-15b", "paligemma-3b"):
        cfg = tget(arch, smoke=True)
        for cache in (treg.init_cache(cfg, 4, 64, device="meta"),
                      init_paged_cache(cfg, 4, 33, 8, 8, device="meta")):
            cache = dict(cache, start=torch.empty(4, device="meta"))
            sds = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
                   for k, v in cache.items()}
            assert (_flat(tsh.serve_cache_specs(cache, mesh))
                    == _flat_ref(jsh.serve_cache_specs(sds, mesh)))


@pytest.mark.parametrize("arch", ["olmo-1b", "arctic-480b", "zamba2-1.2b",
                                  "rwkv6-1.6b"])
def test_cache_and_batch_specs_equal_reference(arch):
    for data, tp, batch in ((2, 4, 8), (4, 2, 6), (1, 8, 3)):
        mesh = _mesh(tp, data)
        jcfg, tcfg = jget(arch, smoke=True), tget(arch, smoke=True)
        assert (_flat(tsh.cache_specs(tcfg, mesh, batch, 32))
                == _flat_ref(jsh.cache_specs(jcfg, mesh, batch, 32)))
        assert ({k: tuple(v) for k, v in
                 tsh.batch_specs(tcfg, mesh, batch, 32).items()}
                == {k: tuple(v) for k, v in
                    jsh.batch_specs(jcfg, mesh, batch, 32).items()})


def test_opt_state_specs_equal_reference():
    """Same-shape moments copy the param spec; factored vr / vc keep the
    surviving entries; scalars replicate."""
    jt, tt = _trees("olmo-1b", True)["dense"]
    mesh = _mesh(4, 2)
    jcfg, tcfg = jget("olmo-1b", smoke=True), tget("olmo-1b", smoke=True)
    jps = jsh.param_specs(jt, mesh, jcfg, fsdp_min_shard_elems=1 << 10)
    tps = tsh.param_specs(tt, mesh, tcfg, fsdp_min_shard_elems=1 << 10)
    wi = jt["layers"]["mlp"]["wi"]["w"].shape
    jopt = {"m": jt, "step": jax.ShapeDtypeStruct((), jnp.int32),
            "fac": {"layers": {"mlp": {"wi": {"w": {
                "vr": jax.ShapeDtypeStruct(wi[:-1], jnp.float32),
                "vc": jax.ShapeDtypeStruct(wi[:-2] + wi[-1:],
                                           jnp.float32)}}}}}}
    topt = {"m": tt, "step": torch.empty((), device="meta"),
            "fac": {"layers": {"mlp": {"wi": {"w": {
                "vr": torch.empty(wi[:-1], device="meta"),
                "vc": torch.empty(wi[:-2] + wi[-1:], device="meta")}}}}}}
    want = jsh.opt_state_specs_like(jopt, jt, jps, mesh)
    got = tsh.opt_state_specs_like(topt, tt, tps, mesh)
    assert _flat(got) == _flat_ref(want)


def test_zero_spec_equals_reference():
    from jax.sharding import PartitionSpec as P
    mesh = _FakeMesh({"pod": 2, "data": 2, "model": 4})
    for spec, shape in (((None, "model"), (64, 128)), ((), (6, 8, 10)),
                        (("model", None), (8, 6)), ((None,), (1 << 24,))):
        for min_elems in (None, 1, 1 << 23):
            assert tuple(tsh.zero_spec(tsh.Spec(*spec), shape, mesh,
                                       min_elems)) == tuple(jsh.zero_spec(
                                           P(*spec), shape, mesh, min_elems))


# ---------------------------------------------------------------------------
# explain(tp=, collective=)
# ---------------------------------------------------------------------------

def _explain_cases():
    """olmo-1b's and qwen2.5-14b's serving GEMMs at decode and prefill M
    (dense, f32 / INT8 / w4 planes; row-parallel o_proj / wo behind the
    all-reduce, the rest column-parallel), the head GEMV and the sampling
    head, plus splits that do not divide and a row split inside a DBB
    block."""
    out = []
    for arch in ("olmo-1b", "qwen2.5-14b"):
        cfg = tget(arch)
        d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
        hq, hkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
        g = cfg.dbb.quant_group
        for m in (8, 24, 512):
            for dt in ("float32", "bfloat16"):
                for k, n, coll in ((d, hq, ""), (d, hkv, ""), (hq, d,
                                   "all-reduce"), (d, f, ""),
                                   (f, d, "all-reduce")):
                    base = dict(m=m, k=k, n=n, collective=coll, pallas=True)
                    out += [("matmul", dt, dict(base, dense_fused=True)),
                            ("matmul", dt, dict(base, packed=True,
                                                vals_itemsize=4)),
                            ("matmul", dt, dict(base, packed=True,
                                                vals_itemsize=1)),
                            ("matmul", dt, dict(base, packed=True, bits=4,
                                                group=g))]
            out.append(("matmul", "float32", dict(
                m=m, k=d, n=cfg.vocab_size, pallas=True, gemv=True)))
        for m in (1, 8, 24):
            out.append(("head_sample", "float32", dict(
                m=m, k=d, n=cfg.vocab_size, pallas=True)))
    out += [("matmul", "float32", dict(m=128, k=256, n=100, pallas=True)),
            ("matmul", "float32", dict(m=128, k=64, n=256, packed=True,
                                       pallas=True,
                                       collective="all-reduce")),
            ("matmul", "float32", dict(m=8, k=200, n=256, pallas=True,
                                       collective="reduce-scatter")),
            ("matmul", "float32", dict(m=8, k=512, n=256, packed=True,
                                       bits=4, group=128, pallas=True,
                                       collective="all-reduce"))]
    return out


_TP_MARKERS = ("axis split", "inside a block", "scale group")


@pytest.mark.parametrize("tp", [2, 4, 8, 16])
def test_explain_tp_equals_reference(tp):
    for domain, dt, kw in _explain_cases():
        t = td.explain(domain, dtype=getattr(torch, dt), hw=HW_H100, tp=tp,
                       **kw)
        j = jd.explain(domain, dtype=jnp.dtype(dt), hw=J_H100, tp=tp, **kw)
        assert t[0].name == j[0].name, (domain, kw, t[0].name, j[0].name)
        jrows = {d.name: d for d in j}
        for d in t:
            r = jrows[d.name]
            for field in ("flops", "bytes", "collective_bytes",
                          "collective_s", "cost_s", "weight_bytes"):
                assert getattr(d, field) == pytest.approx(
                    getattr(r, field), rel=1e-12, abs=0.0), (d.name, field)
            assert d.tp == r.tp == tp
            if any(mk in r.reason for mk in _TP_MARKERS):
                assert d.reason == r.reason, (d.name, kw)
        # the header names the mesh as the reference's does
        assert (td.format_table(t).splitlines()[0]
                == jd.format_table(j).splitlines()[0])
        # and on the reference's v5e figures the costs still agree
        tv = td.explain(domain, dtype=getattr(torch, dt), hw=V5E, tp=tp,
                        **kw)
        jv = jd.explain(domain, dtype=jnp.dtype(dt), tp=tp, **kw)
        assert {d.name: d.cost_s for d in tv} == pytest.approx(
            {d.name: d.cost_s for d in jv}, rel=1e-12, abs=0.0)


def test_explain_takes_tp_from_the_mesh_and_local_dims_in_a_shard():
    mesh = _mesh(4)
    kw = dict(m=8, k=2048, n=8192, pallas=True, packed=True,
              collective="all-reduce")
    with use_mesh(mesh):
        on = td.explain("matmul", **kw)
        with shard_tp_ctx(4):
            body = td.explain("matmul", **kw)
    assert on[0].tp == 4 and on[0].collective_bytes > 0
    assert td.format_table(on).splitlines()[0] == (
        "costed for mesh {'data': 1, 'model': 4} (model-axis tp=4)")
    assert body[0].tp == 1 and body[0].collective_bytes == 0
    assert td.format_table(body).splitlines()[0] == (
        "costed for mesh TP shard body (tp=4, local dims) "
        "(model-axis tp=1)")
    one = td.explain("matmul", **kw)
    assert [(d.name, d.flops) for d in body] == [(d.name, d.flops)
                                                 for d in one]
    # a column split with no collective prices no wire bytes
    col = td.explain("matmul", m=256, k=2048, n=2048, pallas=True, tp=4)
    assert all(d.collective_bytes == 0 for d in col)


def test_make_mesh_needs_the_default_group():
    from repro_torch.dist.mesh_ctx import make_mesh
    with pytest.raises(RuntimeError, match="needs the default process"):
        make_mesh(1, 2, backend="gloo")


def test_axis_size_inside_and_outside_a_mesh():
    """The reference's test_axis_size_outside_mesh_raises_actionable_error,
    and the size under a live mesh; mesh_ctx.axis_size is 1 without one."""
    from repro_torch.dist import collectives
    from repro_torch.dist.mesh_ctx import axis_size
    with pytest.raises(RuntimeError, match="outside a mesh"):
        collectives.axis_size("model")
    assert axis_size("model") == 1
    with use_mesh(_mesh(4, 2)):
        assert collectives.axis_size("model") == 4
        assert axis_size("data") == 2 and axis_size("pod") == 1


def test_collective_bw_equals_reference():
    from repro.roofline.analysis import collective_bw as jbw
    from repro_torch.roofline.analysis import collective_bw as tbw
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        assert tbw(kind, HW_H100) == jbw(kind, J_H100)
    assert tbw("all-gather", HW_H100) == 2 * tbw("all-reduce", HW_H100)


# ---------------------------------------------------------------------------
# the tp-smem pass
# ---------------------------------------------------------------------------

def test_tp_smem_pass_clean_on_the_registry():
    checked, violations = tp_smem.check_registry(
        dispatch_check.routes_by_domain(), dispatch_check.default_specs())
    assert checked > 1000
    assert violations == []


def test_tp_smem_pass_catches_a_global_dim_guard():
    report = lint.run(contracts_module=str(FIXTURES / "torch_bad_tp.py"),
                      device="cpu")
    assert not report["ok"]
    codes = {v["code"] for v in report["passes"]["tp-smem"]["violations"]}
    assert codes == {"tp-route-loss"}
    for name, p in report["passes"].items():
        if name != "tp-smem":
            assert not p["violations"], (name, p["violations"])
    # the reference's pass flags the same bug class on its own registry
    from repro.analysis import tp_vmem
    real = jd.routes_for("matmul")["sta"]

    def bad(spec):
        g = real.guard(dataclasses.replace(spec, tp=1, collective=""))
        if g:
            return g
        if spec.tp > 1 and spec.k * spec.n * spec.itemsize > 2 ** 22:
            return "weight tile exceeds VMEM budget"
        return ""
    _, v = tp_vmem.check_registry(
        {"matmul": {"sta": dataclasses.replace(real, guard=bad)}},
        {"matmul": [jd.OpSpec(domain="matmul", m=256, k=2048, n=2048,
                              pallas=True)]})
    assert {x.code for x in v} == codes
