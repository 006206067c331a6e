"""The port's roofline route costs (`dispatch.explain`, `select`,
`format_table`) against the reference's registry on the shape grid of
tests/test_torch_dispatch.py: olmo-1b's smoke and full widths and the
three family configs' full widths (every layer GEMM, the head GEMV, the
sampling head, prefill and decode attention at M and T from 1 to 8192),
and the CNN configs' convs and classifiers at batch 1-256.

On a v5e `Hardware` built here, every route both packages have must cost
the same flops, bytes and time (rel 1e-12) and both must pick the same
route; on `HW_H100` the port must still pick the reference's route."""
import dataclasses
import math

import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels import dispatch as jd
from repro.roofline.analysis import HW_V5E as J_V5E
from repro_torch.configs import get_config as tget
from repro_torch.kernels import dispatch as td
from repro_torch.roofline.analysis import HW_H100, Hardware

from test_torch_dispatch import CNN_ROUTES

V5E = Hardware(name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
               ici_link_bw=50e9, ici_links=4)
LM = [("olmo-1b", True), ("olmo-1b", False), ("starcoder2-15b", False),
      ("qwen2.5-14b", False), ("yi-34b", False)]
MS = [1, 8, 24, 32, 48, 96, 512, 2048, 8192]
DTYPES = ("float32", "bfloat16")


def _lm_matmul_cases(arch, smoke, m):
    """(dtype, explain kwargs) of every GEMM the LM path can issue at M = m:
    the attention projections and MLP GEMMs dense (kernel-opted or kept
    plain), packed with f32 / int8 values and as w4, with and without a
    fused epilogue, on both route families; the head GEMV dense."""
    cfg = tget(arch, smoke)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    g = cfg.dbb.quant_group
    out = []
    for dt in DTYPES:
        for pallas in (True, False):
            for k, n in ((d, hq), (d, hkv), (hq, d), (d, f), (f, d)):
                for epi in (0, 1):
                    base = dict(m=m, k=k, n=n, pallas=pallas,
                                epilogue_ops=epi)
                    out += [(dt, dict(base, dense_fused=fused))
                            for fused in (True, False)]
                    out += [(dt, dict(base, packed=True, vals_itemsize=v))
                            for v in (4, 1)]
                    if k % g == 0:
                        out.append((dt, dict(base, packed=True, bits=4,
                                             group=g)))
            out.append((dt, dict(m=m, k=d, n=cfg.vocab_size, pallas=pallas,
                                 gemv=True)))
    return out


def _cnn_cases(arch, b):
    """(domain, dtype, explain kwargs) of every conv and the classifier
    `cnn_apply` issues at batch b, dense and packed (bias + ReLU on the
    convs, bias on the classifier)."""
    cfg = tget(arch)
    kk, nnz = cfg.cnn_kernel, cfg.dbb.nnz
    size, c, out = cfg.cnn_img, cfg.cnn_in_ch, []
    for n in cfg.cnn_channels:
        geom = (b, size, size, c, kk, kk, 1, "SAME")
        for packed in sorted({False, (kk * kk * c) % 8 == 0}):
            out.append(("conv", "float32", dict(
                m=b * size * size, k=kk * kk * c, n=n, packed=packed,
                nnz=nnz, vals_itemsize=4, epilogue_ops=2, pallas=True,
                conv_geom=geom)))
        size, c = size // 2, n
    for packed in (False, True):
        out.append(("matmul", "float32", dict(
            m=b, k=size * size * c, n=cfg.cnn_classes, packed=packed,
            nnz=nnz, vals_itemsize=4, epilogue_ops=1, pallas=True)))
    return out


def _attention_cases():
    out = []
    for arch, smoke in LM:
        hd = tget(arch, smoke).resolved_head_dim
        for dt in DTYPES:
            for pallas in (True, False):
                for t in (16, 64, 512, 2048, 4096, 8192):
                    for b in (1, 8):
                        out.append((dt, dict(m=t, k=hd, n=t, batch=b,
                                             pallas=pallas)))
                    out.append((dt, dict(m=t, k=hd, n=t, pallas=pallas,
                                         packed_seq=True)))
                    out.append((dt, dict(m=t, k=hd, n=t, batch=8,
                                         ragged=True, pallas=pallas)))
    return out


def _decode_cases():
    out = []
    for arch, smoke in LM:
        cfg = tget(arch, smoke)
        g = cfg.num_heads // cfg.num_kv_heads
        for dt in DTYPES:
            for pallas in (True, False):
                for smax in (16, 24, 31, 72, 130, 640, 4096, 5136):
                    for page in (math.gcd(smax, 64), 16, 64):
                        out.append((dt, dict(m=g, k=cfg.resolved_head_dim,
                                             n=smax, page=page,
                                             pallas=pallas)))
    return out


def _head_cases():
    out = []
    for arch, smoke in LM:
        cfg = tget(arch, smoke)
        for m in (1, 8, 24, 32, 40):
            for tt in (False, True):
                for pallas in (True, False):
                    out.append(("float32", dict(m=m, k=cfg.d_model,
                                                n=cfg.vocab_size,
                                                pallas=pallas, sample_tt=tt)))
    return out


def _both(domain, dtype, kw, hw_port=V5E, hw_ref=J_V5E):
    """(port rows, reference rows) of one op."""
    t = td.explain(domain, dtype=getattr(torch, dtype), hw=hw_port, **kw)
    j = jd.explain(domain, dtype=jnp.dtype(dtype), hw=hw_ref, **kw)
    return t, j


def _check_equal_costs(domain, dtype, kw):
    t, j = _both(domain, dtype, kw)
    jrows = {d.name: d for d in j}
    assert {d.name for d in t} == set(jrows), (domain, kw)
    for d in t:
        r = jrows[d.name]
        for field in ("flops", "bytes", "compute_s", "memory_s", "cost_s",
                      "weight_bytes"):
            assert getattr(d, field) == pytest.approx(
                getattr(r, field), rel=1e-12, abs=0.0), (d.name, field, kw)
        assert d.priority == r.priority and d.deferred == r.deferred
    assert t[0].name == j[0].name, (domain, kw, t[0].name, j[0].name)
    # the choice does not move on the H100's constants
    assert td.explain(domain, dtype=getattr(torch, dtype), hw=HW_H100,
                      **kw)[0].name == j[0].name, (domain, kw)


def test_v5e_is_the_reference_constant():
    assert dataclasses.astuple(V5E) == dataclasses.astuple(J_V5E)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("arch,smoke", LM)
def test_matmul_costs_equal_reference(arch, smoke, m):
    for dt, kw in _lm_matmul_cases(arch, smoke, m):
        _check_equal_costs("matmul", dt, kw)


@pytest.mark.parametrize("b", [1, 8, 64, 256])
@pytest.mark.parametrize("arch", ["convnet-dbb", "lenet5-dbb"])
def test_cnn_costs_equal_reference(arch, b):
    for domain, dt, kw in _cnn_cases(arch, b):
        _check_equal_costs(domain, dt, kw)


@pytest.mark.parametrize("domain,cases", [
    ("attention", _attention_cases), ("attn_decode", _decode_cases),
    ("head_sample", _head_cases)])
def test_attention_and_head_costs_equal_reference(domain, cases):
    for dt, kw in cases():
        _check_equal_costs(domain, dt, kw)


@pytest.mark.parametrize("arch,mode,b", sorted(CNN_ROUTES))
def test_h100_keeps_the_pinned_cnn_routes(arch, mode, b):
    """test_torch_dispatch.py's CNN expectations, on specs with every cost
    field the front doors fill, costed on HW_H100."""
    got = []
    for domain, _, kw in _cnn_cases(arch, b):
        if kw["packed"] != (mode == "dbb" and (
                domain == "matmul" or (kw["k"] % 8 == 0))):
            continue
        spec = td.OpSpec(domain=domain, **kw)
        got.append(td.select(spec, hw=HW_H100)[0])
    assert got == CNN_ROUTES[(arch, mode, b)]


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("m", [8, 48, 96, 512])
def test_h100_keeps_the_pinned_serving_routes(smoke, m):
    """test_torch_dispatch.py's serving-path expectations on HW_H100, with
    the front doors' cost fields: packed MLP kernels (skinny at M ≤ 32),
    the attention projections plain, the bf16 dense MLP on ``sta`` /
    ``skinny_sta``, the f32 head GEMV on ``skinny_sta`` up to M 32."""
    cfg = tget("olmo-1b", smoke)
    d, f = cfg.d_model, cfg.d_ff
    hq = cfg.num_heads * cfg.resolved_head_dim

    def pick(**kw):
        return td.select(td.OpSpec(domain="matmul", m=m, pallas=True, **kw),
                         hw=HW_H100)[0]
    packed = "skinny_dbb" if m <= 32 else "dbb_packed"
    dense = "skinny_sta" if m <= 32 else "sta"
    for k, n, epi in ((d, f, 0), (d, f, 1), (f, d, 0)):
        assert pick(k=k, n=n, packed=True, vals_itemsize=4,
                    epilogue_ops=epi) == packed
        assert pick(k=k, n=n, itemsize=2, out_itemsize=2,
                    epilogue_ops=epi) == dense
    assert pick(k=d, n=hq, itemsize=2, out_itemsize=2,
                dense_fused=False) == "xla"
    assert pick(k=d, n=cfg.vocab_size, gemv=True) == (
        "skinny_sta" if m <= 32 else "xla")


def test_format_table_prints_the_reference_columns():
    """The header is the reference's; on v5e every row's route, ok, cost,
    flops, bytes, wbytes and coll columns are the reference's too (the
    notes word the guards' reasons)."""
    jcfg = jget("olmo-1b").replace(gemm_impl="pallas")
    tcfg = tget("olmo-1b").replace(gemm_impl="pallas")
    for domain, kw in (("matmul", dict(m=8, k=2048, n=8192, packed=True,
                                       epilogue_ops=1)),
                       ("attention", dict(m=512, k=128, n=512,
                                          packed_seq=True)),
                       ("head_sample", dict(m=8, k=2048, n=50304))):
        t = td.format_table(td.explain(domain, dtype="float32", cfg=tcfg,
                                       hw=V5E, **kw)).splitlines()
        j = jd.format_table(jd.explain(domain, dtype=jnp.float32, cfg=jcfg,
                                       **kw)).splitlines()
        assert t[0] == j[0]
        cut = len(j[0]) - len("note")
        jrows = {row.split()[0]: row[:cut] for row in j[1:]}
        assert {row[:cut] for row in t[1:]} == set(jrows.values())
        assert t[1].split()[1] == "y*"


def test_explain_refuses_tensor_parallel():
    """explain(tp=2) no longer refuses: it costs the per-shard instance
    (tests/test_torch_tp_specs.py holds it against the reference), and
    tp=1 is the single-device table."""
    two = td.explain("matmul", m=8, k=2048, n=8192, tp=2)
    assert two[0].tp == 2 and two[0].mesh == "(model=2)"
    one = td.explain("matmul", m=8, k=2048, n=8192, tp=1)
    assert one[0].name == "xla" and one[0].tp == 1
    assert two[0].flops == pytest.approx(one[0].flops / 2)
