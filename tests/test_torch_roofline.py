"""The port's roofline layer on the CPU: `roofline_terms` against the
reference's, the step counter (`roofline.counts.count_step`) on a smoke
olmo-1b decode step, the kernel wrappers' meta branches, and a gloo world
of 2 counting a tensor-parallel decode step's collectives by logical kind.

* `roofline_terms` on the same flops, bytes and collective-by-kind inputs
  as the reference's, with a reference `Hardware` built from `HW_H100`'s
  numbers: every ``as_dict()`` key equal, except ``roofline_fraction``,
  which the port takes against ``hw.peak_flops`` (the reference always
  divides by its TPU's peak).
* `count_step` on a packed smoke olmo-1b decode step (f32 planes, the
  kernel route family, whose wrappers run their plain versions here):
  every GEMM and the decode attention are dispatcher calls, whose counted
  flops equal the sum of the chosen routes' costs taken independently
  from `dispatch.explain`; no matrix product is counted again as an aten
  op; a CPU run and a meta run of the step count the same flops, bytes,
  routes, aten ops and collectives (their peaks differ: the CPU runs the
  plain versions' temporaries, meta the kernels' outputs and workspaces).
"""
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro.roofline.analysis import Hardware as JHardware
from repro.roofline.analysis import model_flops_per_step as j_mf
from repro.roofline.analysis import roofline_terms as j_terms
from repro.roofline.hlo import HloStats
from repro_torch.configs import get_config
from repro_torch.core.dbb import pack_dbb
from repro_torch.core.dbb_linear import pack_tree
from repro_torch.core.sparsity import apply_dbb_to_tree
from repro_torch.kernels import dispatch
from repro_torch.kernels.attn import ops as attn_ops
from repro_torch.kernels.attn import ref as attn_ref
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.conv_gemm import ops as conv_ops
from repro_torch.kernels.conv_gemm import ref as conv_ref
from repro_torch.kernels.dbb_gemm.ops import dbb_gemm
from repro_torch.kernels.dbb_gemm.ref import dbb_gemm_ref
from repro_torch.kernels.sample import ops as sample_ops
from repro_torch.kernels.skinny.ops import dbb_gemm_skinny, sta_gemm_skinny
from repro_torch.kernels.sta_gemm.ops import sta_gemm
from repro_torch.kernels.sta_gemm.ref import sta_gemm_ref
from repro_torch.launch.specs import sds_tree
from repro_torch.models import registry
from repro_torch.roofline.analysis import (HW_H100, model_flops_per_step,
                                           roofline_terms)
from repro_torch.roofline.counts import StepStats, count_step
from repro_torch.serve.engine import ServeEngine

J_H100 = JHardware(name=HW_H100.name, peak_flops=HW_H100.peak_flops,
                   hbm_bw=HW_H100.hbm_bw, ici_link_bw=HW_H100.ici_link_bw,
                   ici_links=HW_H100.ici_links)

# (flops, hbm bytes, collective bytes by kind, model flops, io bytes)
TERM_CASES = [
    (3.3e9, 6.7e9, {"all-reduce": 1.1e6, "all-gather": 1.6e1}, 1.2e9,
     2.35e9),
    (2.6e13, 4.1e12, {"all-reduce": 9.1e9}, 9.6e12, 0.0),
    (5.1e14, 1.2e12, {"all-gather": 2.0e11, "reduce-scatter": 1.0e11,
                      "all-to-all": 3.0e8, "collective-permute": 1.0e6},
     3.6e14, 7.2e8),
    (0.0, 0.0, {}, 0.0, 0.0),
]


@pytest.mark.parametrize("case", range(len(TERM_CASES)))
def test_roofline_terms_match_reference(case):
    flops, hbm, coll, mf, io = TERM_CASES[case]
    ref = j_terms(HloStats(flops=flops, hbm_bytes=hbm,
                           collective_bytes=dict(coll)), hw=J_H100,
                  model_flops_per_device=mf, io_bytes_per_device=io)
    got = roofline_terms(StepStats(flops=flops, hbm_bytes=hbm,
                                   collective_bytes=dict(coll)), hw=HW_H100,
                         model_flops_per_device=mf, io_bytes_per_device=io)
    want, have = ref.as_dict(), got.as_dict()
    assert set(want) == set(have)
    for k in want:
        if k != "roofline_fraction":
            assert have[k] == want[k], k
    lb = got.step_time_lb
    assert have["roofline_fraction"] == (
        mf / HW_H100.peak_flops / lb if lb else 0.0)
    assert got.int8_compute_s == ref.int8_compute_s


@pytest.mark.parametrize("n,tokens,train", [(1_176_764_416, 8, False),
                                            (14_770_033_664, 1 << 20, True),
                                            (0, 5, True)])
def test_model_flops_per_step_matches_reference(n, tokens, train):
    assert model_flops_per_step(n, tokens, train) == j_mf(n, tokens, train)


# ---------------------------------------------------------------------------
# the step counter on a smoke decode step
# ---------------------------------------------------------------------------

B, SMAX = 8, 64


def _decode_args(dev, packed=None):
    cfg = get_config("olmo-1b", smoke=True).replace(gemm_impl="pallas")
    if packed is None:
        packed = pack_tree(apply_dbb_to_tree(
            registry.init_params(cfg, seed=0, device=dev), cfg.dbb,
            straight_through=False), cfg.dbb)
    eng = ServeEngine(cfg, packed, max_batch=B, device=dev)
    cache = registry.init_cache(cfg, B, SMAX, device=dev)
    tok = torch.arange(2, 2 + B, dtype=torch.int32, device=dev)
    return cfg, packed, eng, (eng.params, eng.head, cache, tok)


@pytest.fixture(scope="module")
def decode_counts():
    cfg, packed, eng, args = _decode_args(torch.device("cpu"))
    _, cpu = count_step(eng._decode, *args)
    _, _, meng, margs = _decode_args(torch.device("meta"), sds_tree(packed))
    _, meta = count_step(meng._decode, *margs)
    return cfg, cpu, meta


def _chosen(domain, **kw):
    rows = dispatch.explain(domain, **kw)
    return next(d for d in rows if d.chosen)


def test_dispatcher_flops_are_the_chosen_routes_costs(decode_counts):
    cfg, st, _ = decode_counts
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hd, g = cfg.resolved_head_dim, cfg.num_heads // cfg.num_kv_heads
    want = {}

    def add(dec, calls):
        row = want.setdefault(dec.name, [0, 0.0, 0.0])
        row[0] += calls
        row[1] += calls * dec.flops
        row[2] += calls * dec.bytes

    layer_gemms = [(d, d)] * 4 + [(d, f)] * 2 + [(f, d)]
    for k, n in layer_gemms:
        add(_chosen("matmul", m=B, k=k, n=n, packed=True, cfg=cfg,
                    dtype=cfg.dtype, vals_itemsize=4), cfg.num_layers)
    add(_chosen("matmul", m=B, k=d, n=v, cfg=cfg, dtype=torch.float32,
                gemv=True), 1)
    dec = _chosen("attn_decode", m=g, k=hd, n=SMAX, cfg=cfg,
                  dtype=cfg.dtype, page=SMAX)
    add(dec, cfg.num_layers)
    # a decode spec costs one (row, KV head) pair: the call covers all
    want[dec.name][1] *= B * cfg.num_kv_heads
    want[dec.name][2] *= B * cfg.num_kv_heads
    assert set(want) == {"skinny_dbb", "skinny_sta", "attn_decode_flash"}
    assert st.routes == want
    assert sum(r[1] for r in st.routes.values()) == st.flops


def test_no_aten_op_counted_twice(decode_counts):
    _, st, _ = decode_counts
    assert not {"mm", "bmm", "addmm", "baddbmm", "matmul"} & set(st.ops)
    assert all(r[1] == 0.0 for r in st.ops.values())
    assert st.hbm_bytes == (sum(r[2] for r in st.routes.values())
                            + sum(r[2] for r in st.ops.values()))
    # the cache writes are the only in-place ops: one K and one V a layer
    assert st.ops["index_put_"][0] == 2 * 2


def test_cpu_and_meta_steps_count_the_same(decode_counts):
    _, cpu, meta = decode_counts
    for field in ("flops", "hbm_bytes", "routes", "ops",
                  "collective_bytes", "collective_counts", "top_ops"):
        assert getattr(cpu, field) == getattr(meta, field), field
    assert meta.peak_bytes > 0 and cpu.peak_bytes > 0


# ---------------------------------------------------------------------------
# the kernel wrappers' meta branch
# ---------------------------------------------------------------------------

def _planes(k, n, nnz=4, dev="cpu"):
    g = torch.Generator().manual_seed(k * 31 + n)
    p = pack_dbb(torch.randn(k, n, generator=g), 8, nnz)
    return p.values.to(dev), p.bitmask.to(dev)


def _rand(*shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dtype)


def _wrapper_cases(dev):
    """name -> (wrapper call on ``dev``, its plain version's call)."""
    x = _rand(24, 64).to(dev)
    xs = _rand(8, 64).to(dev)
    vals, mask = _planes(64, 32, dev=dev)
    w = _rand(64, 32, seed=1).to(dev)
    q = _rand(2, 16, 4, 32, seed=2).to(dev)
    kv = _rand(2, 16, 2, 32, seed=3).to(dev)
    qp = _rand(16, 4, 32, seed=4).to(dev)
    kvp = _rand(16, 2, 32, seed=5).to(dev)
    seg = torch.tensor([0] * 7 + [1] * 9, dtype=torch.int32).to(dev)
    qd = _rand(2, 2, 2, 32, seed=6).to(dev)
    pages = _rand(5, 8, 2, 32, seed=7).to(dev)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32).to(dev)
    lens = torch.tensor([9, 12], dtype=torch.int32).to(dev)
    img = _rand(2, 8, 8, 8, seed=8).to(dev)
    cw = _rand(72, 16, seed=9).to(dev)
    cvals, cmask = _planes(72, 16, dev=dev)
    h = _rand(4, 128, seed=10).to(dev)
    hw = _rand(128, 256, seed=11).to(dev)
    counts = torch.zeros((4, 256), dtype=torch.int32).to(dev)
    f32 = dict(dtype=torch.float32, device=dev)
    rows = (torch.ones(4, **f32), torch.ones(4, **f32),
            torch.zeros(4, **f32), torch.zeros(4, **f32),
            torch.arange(4, dtype=torch.int32).to(dev),
            torch.zeros(4, dtype=torch.int32).to(dev))
    conv = dict(kh=3, kw=3)
    return {
        "dbb_gemm": (lambda: dbb_gemm(x, vals, mask),
                     lambda: dbb_gemm_ref(x, vals, mask, None, None)),
        "dbb_gemm_skinny": (lambda: dbb_gemm_skinny(xs, vals, mask),
                            lambda: dbb_gemm_ref(xs, vals, mask, None,
                                                 None)),
        "sta_gemm": (lambda: sta_gemm(x, w),
                     lambda: sta_gemm_ref(x, w, None, None)),
        "sta_gemm_skinny": (lambda: sta_gemm_skinny(xs, w),
                            lambda: sta_gemm_ref(xs, w, None, None)),
        "flash_prefill": (
            lambda: attn_ops.flash_attention(q, kv, kv),
            lambda: attn_ref.flash_prefill_ref(
                q.transpose(1, 2), kv.transpose(1, 2), kv.transpose(1, 2),
                torch.zeros(2, dtype=torch.int32),
                torch.zeros(2, dtype=torch.int32),
                sm_scale=32 ** -0.5).transpose(1, 2)),
        "flash_prefill_packed": (
            lambda: attn_ops.packed_flash_attention(qp, kvp, kvp, seg),
            lambda: attn_ref.packed_prefill_ref(
                qp.transpose(0, 1), kvp.transpose(0, 1), kvp.transpose(0, 1),
                seg, sm_scale=32 ** -0.5).transpose(0, 1)),
        "paged_decode": (
            lambda: attn_ops.paged_decode_attention(qd, pages, pages, table,
                                                    lens),
            lambda: attn_ref.paged_decode_ref(
                qd, pages, pages, table, lens, torch.zeros(2,
                                                           dtype=torch.int32),
                sm_scale=32 ** -0.5)),
        "conv_gemm": (lambda: conv_ops.conv_gemm(img, cw, **conv),
                      lambda: conv_ref.conv_gemm_ref(img, cw, None, None,
                                                     **conv)),
        "conv_gemm_dbb": (
            lambda: conv_ops.conv_gemm_dbb(img, cvals, cmask, **conv),
            lambda: conv_ref.conv_gemm_dbb_ref(img, cvals, cmask, None,
                                               None, **conv)),
        "head_sample_fused": (
            lambda: sample_ops.head_sample_fused(h, hw, counts, *rows),
            lambda: sample_ops.head_sample_fused_ref(h, hw, counts, *rows)),
    }


WRAPPERS = sorted(_wrapper_cases("cpu"))


def _outs(y):
    return list(y) if isinstance(y, tuple) else [y]


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_meta_branch(name):
    cpu_call, plain = _wrapper_cases("cpu")[name]
    meta_call, _ = _wrapper_cases("meta")[name]
    before = dict(LAUNCHES)
    got_cpu = _outs(cpu_call())
    got_meta = _outs(meta_call())
    assert dict(LAUNCHES) == before              # nothing launched
    for a, b, want in zip(got_cpu, got_meta, _outs(plain())):
        assert b.device.type == "meta"
        assert (b.shape, b.dtype) == (a.shape, a.dtype)
        assert torch.equal(a, want)              # the CPU runs the plain one


# ---------------------------------------------------------------------------
# collectives by logical kind: a gloo world of 2
# ---------------------------------------------------------------------------

_RANK = r"""
import json, sys
import torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.core.dbb_linear import pack_tree
from repro_torch.core.sparsity import apply_dbb_to_tree
from repro_torch.dist.mesh_ctx import make_mesh, use_mesh
from repro_torch.models import registry
from repro_torch.roofline.counts import count_step
from repro_torch.serve.engine import ServeEngine
rank, store = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=2)
cfg = get_config("olmo-1b", smoke=True).replace(gemm_impl="pallas",
                                                dtype="float32")
tree = pack_tree(apply_dbb_to_tree(registry.init_params(cfg, device="cpu"),
                                   cfg.dbb, straight_through=False), cfg.dbb)
with use_mesh(make_mesh(1, 2, backend="gloo")):
    eng = ServeEngine(cfg, tree, max_batch=4, device="cpu")
    cache = registry.init_cache(eng._lcfg, 4, 32, device="cpu")
    tok = torch.arange(2, 6, dtype=torch.int32)
    _, st = count_step(eng._decode, eng.params, eng.head, cache, tok)
print("JSON::" + json.dumps({"reason": eng.tp_reason,
                             "bytes": st.collective_bytes,
                             "counts": st.collective_counts}))
dist.destroy_process_group()
"""


def test_tp_decode_counts_gather_as_all_gather():
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src)
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r),
                                   store], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            line = next(x for x in out.splitlines() if x.startswith("JSON::"))
            outs.append(__import__("json").loads(line[6:]))
    layers, b, d = 2, 4, 128
    for o in outs:
        assert o["reason"] == ""                 # the TP wrap is on
        # the greedy combine gathers each rank's (score, id) rows as f64:
        # one all-gather of its [2, B] operand, not an all-reduce of the
        # zero-filled [2, 2, B] buffer gloo carries
        assert o["counts"]["all-gather"] == 1
        assert o["bytes"]["all-gather"] == 2 * b * 8
        # the embedding's and each layer's two boundary all-reduces
        assert o["counts"]["all-reduce"] == 1 + 2 * layers
        assert o["bytes"]["all-reduce"] == (1 + 2 * layers) * b * d * 4
    assert outs[0] == outs[1]


def test_step_stats_top_collectives_order():
    st = StepStats(top_ops=[("all-reduce", 4.0, 1.0, "a"),
                            ("all-gather", 9.0, 1.0, "b"),
                            ("reduce-scatter", 1.0, 2.0, "c")])
    assert st.top_collectives(2) == [("all-gather", 9.0, "b"),
                                     ("all-reduce", 4.0, "a")]
    assert np.isclose(sum(r[1] for r in st.top_collectives()), 15.0)
