"""The port's route choice against the reference's registry
(`repro.kernels.dispatch.select`) on the serving path's shapes, at the
smoke and the full olmo-1b widths, with packed and with dense weights; on
every conv and classifier of the CNN configs at full width; and the
override order REPRO_FORCE_ROUTE > kernel_routes > auto."""
import math
import warnings

import pytest

from repro.configs import get_config as jget
from repro.kernels import dispatch as jd
from repro_torch.configs import get_config as tget
from repro_torch.kernels import dispatch as td

PIN = (("attention", "attn_naive"),)


def _cfgs(smoke: bool, gemm_impl: str = "pallas"):
    kw = dict(remat="none", gemm_impl=gemm_impl, kernel_routes=PIN)
    return jget("olmo-1b", smoke).replace(**kw), tget("olmo-1b",
                                                     smoke).replace(**kw)


def _matmul_specs(cfg, m: int):
    """(jax OpSpec, port OpSpec) of every GEMM the path issues at M = m:
    the four attention projections, the three MLP projections (packed,
    values in the f32 param dtype) and, at M = batch, the f32 head GEMV."""
    d, f = cfg.d_model, cfg.d_ff
    hq = cfg.num_heads * cfg.resolved_head_dim
    hkv = cfg.num_kv_heads * cfg.resolved_head_dim
    item = 4 if cfg.dtype == "float32" else 2
    pallas = cfg.gemm_impl == "pallas"
    ops = [(d, hq, 0, False), (d, hkv, 0, False), (hq, d, 0, False),
           (d, f, 0, True), (d, f, 1, True), (f, d, 0, True)]
    out = []
    for k, n, epi, fused in ops:
        out.append((
            jd.OpSpec(domain="matmul", m=m, k=k, n=n, itemsize=item,
                      out_itemsize=item, packed=pallas, vals_itemsize=4,
                      epilogue_ops=epi, pallas=pallas, dense_fused=fused),
            td.OpSpec(domain="matmul", m=m, k=k, n=n, packed=pallas,
                      pallas=pallas, dense_fused=fused)))
    if m <= 8:
        out.append((
            jd.OpSpec(domain="matmul", m=m, k=d, n=cfg.vocab_size,
                      itemsize=4, out_itemsize=4, pallas=pallas, gemv=True),
            td.OpSpec(domain="matmul", m=m, k=d, n=cfg.vocab_size,
                      pallas=pallas)))
    return out


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("gemm_impl", ["pallas", "xla"])
@pytest.mark.parametrize("m", [8, 48, 96, 512])
def test_matmul_routes_match_reference(smoke, gemm_impl, m):
    jcfg, tcfg = _cfgs(smoke, gemm_impl)
    chosen = set()
    for jspec, tspec in _matmul_specs(tcfg, m):
        want, _ = jd.select(jspec, jd.routes_from_cfg(jcfg))
        got, _ = td.select(tspec, td.routes_from_cfg(tcfg))
        assert got == want, (jspec, got, want)
        chosen.add(got)
    if gemm_impl == "xla":
        assert chosen == {"xla"}
    elif m <= 8:
        assert chosen == {"skinny_dbb", "skinny_sta"}
    else:
        assert chosen == {"dbb_packed"}


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("gemm_impl", ["pallas", "xla"])
@pytest.mark.parametrize("total", [16, 24, 31, 36, 72, 128, 130])
def test_decode_attention_routes_match_reference(smoke, gemm_impl, total):
    """Cache lengths that are multiples of 8 take the kernel; others get a
    page under 8 slots and the plain route, in both packages."""
    jcfg, tcfg = _cfgs(smoke, gemm_impl)
    hd = tcfg.resolved_head_dim
    g = tcfg.num_heads // tcfg.num_kv_heads
    item = 4 if tcfg.dtype == "float32" else 2
    page = math.gcd(total, 64)
    want = jd.decode_attention_route(jcfg, group=g, head_dim=hd,
                                     itemsize=item, page=page, smax=total)
    got = td.decode_attention_route(tcfg, group=g, head_dim=hd, page=page,
                                    smax=total)
    assert got == want
    assert (got == "attn_decode_flash") == (gemm_impl == "pallas"
                                            and total % 8 == 0)


def test_attention_domain_pins_naive():
    jcfg, tcfg = _cfgs(True)
    spec = jd.OpSpec(domain="attention", m=6, k=32, n=6, ragged=True,
                     flash_active=True)
    assert jd.select(spec, jd.routes_from_cfg(jcfg))[0] == "attn_naive"
    tspec = td.OpSpec(domain="attention", m=6, k=32, n=6)
    assert td.select(tspec, td.routes_from_cfg(tcfg))[0] == "attn_naive"


@pytest.mark.parametrize("env,cfg_route,want", [
    ("", None, "skinny_dbb"),                        # auto
    ("", "xla", "xla"),                              # kernel_routes
    ("matmul=dbb_packed", "xla", "dbb_packed"),      # env beats config
    ("dbb_packed", "xla", "dbb_packed"),             # bare env name
    ("attention=attn_naive", "xla", "xla"),          # env for another domain
    ("matmul=skinny_sta", None, "skinny_dbb"),       # inapplicable → auto
])
def test_override_order_matches_reference(monkeypatch, env, cfg_route, want):
    monkeypatch.setenv("REPRO_FORCE_ROUTE", env)
    jcfg, tcfg = _cfgs(True)
    if cfg_route:
        jcfg = jcfg.replace(kernel_routes=PIN + (("matmul", cfg_route),))
        tcfg = tcfg.replace(kernel_routes=PIN + (("matmul", cfg_route),))
    jspec, tspec = _matmul_specs(tcfg, 8)[0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert jd.select(jspec, jd.routes_from_cfg(jcfg))[0] == want
        assert td.select(tspec, td.routes_from_cfg(tcfg))[0] == want


def test_unported_forced_route_warns_and_falls_back(monkeypatch):
    """A pin naming a route the port does not have warns "not ported";
    a pin to the (ported) w4 route on a bits=8 leaf warns that it is not
    applicable, as in the reference; both fall back to auto."""
    _, tcfg = _cfgs(True)
    _, tspec = _matmul_specs(tcfg, 48)[0]
    monkeypatch.setenv("REPRO_FORCE_ROUTE", "matmul=dbb_packed_w2")
    with pytest.warns(UserWarning, match="not ported"):
        name, reasons = td.select(tspec, {})
    assert name == "dbb_packed" and "dbb_packed_w2" not in reasons
    monkeypatch.setenv("REPRO_FORCE_ROUTE", "matmul=dbb_packed_w4")
    with pytest.warns(UserWarning, match="not applicable"):
        name, reasons = td.select(tspec, {})
    assert name == "dbb_packed" and "nibble plane" in reasons["dbb_packed_w4"]


def _dense_specs(cfg, m: int):
    """(jax OpSpec, port OpSpec) of the dense-weights path's GEMMs at
    M = m: the attention projections (kept on the plain matmul by their
    call site), the three MLP projections in bf16 (the SiLU gate fused),
    and the f32 head GEMV."""
    d, f = cfg.d_model, cfg.d_ff
    hq = cfg.num_heads * cfg.resolved_head_dim
    ops = [(d, hq, 0, False, False), (hq, d, 0, False, False),
           (d, f, 0, True, False), (d, f, 1, True, False),
           (f, d, 0, True, False), (d, cfg.vocab_size, 0, True, True)]
    out = []
    for k, n, epi, fused, gemv in ops:
        item = 4 if gemv else 2
        out.append((
            jd.OpSpec(domain="matmul", m=m, k=k, n=n, itemsize=item,
                      out_itemsize=item, epilogue_ops=epi, pallas=True,
                      dense_fused=fused, gemv=gemv),
            td.OpSpec(domain="matmul", m=m, k=k, n=n, pallas=True,
                      dense_fused=fused, gemv=gemv)))
    return out


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("m", [8, 48, 64, 96, 512])
def test_dense_weight_routes_match_reference(smoke, m):
    """Unpacked weights under gemm_impl="pallas": the MLP takes ``sta``
    (M-tiled) above the skinny regime and ``skinny_sta`` in it; the
    attention projections stay plain; the head GEMV takes ``skinny_sta``
    at M ≤ 32 and the plain matmul above, never ``sta``."""
    jcfg, tcfg = _cfgs(smoke)
    got_all = []
    for jspec, tspec in _dense_specs(tcfg, m):
        want, _ = jd.select(jspec, jd.routes_from_cfg(jcfg))
        got, _ = td.select(tspec, td.routes_from_cfg(tcfg))
        assert got == want, (jspec, got, want)
        got_all.append(got)
    mlp = "skinny_sta" if m <= 32 else "sta"
    head = "skinny_sta" if m <= 32 else "xla"
    assert got_all == ["xla", "xla", mlp, mlp, mlp, head]


@pytest.mark.parametrize("m", [8, 64])
def test_head_gemv_route_matches_reference(m):
    """The head call as the engine makes it (f32, ``gemv=True``): skinny
    kernel at M = 8, plain matmul at M = 64 — in both packages."""
    jcfg, tcfg = _cfgs(False)
    d, v = tcfg.d_model, tcfg.vocab_size
    want, _ = jd.select(jd.OpSpec(domain="matmul", m=m, k=d, n=v,
                                  itemsize=4, out_itemsize=4, pallas=True,
                                  gemv=True))
    got, reasons = td.select(td.OpSpec(domain="matmul", m=m, k=d, n=v,
                                       pallas=True, gemv=True))
    assert got == want == ("skinny_sta" if m == 8 else "xla")
    assert reasons["sta"].startswith("head GEMV")


@pytest.mark.parametrize("k", [2, 4])
def test_spec_head_logits_routes_match_reference(k):
    """The speculative draft/verify head logits at max_batch 8: M = 8·(k+1)
    rows through ``matmul(gemv=True)`` — the skinny kernel at k = 2 (M 24),
    the plain matmul at k = 4 (M 40), in both packages."""
    _, tcfg = _cfgs(False)
    m, d, v = 8 * (k + 1), tcfg.d_model, tcfg.vocab_size
    want, _ = jd.select(jd.OpSpec(domain="matmul", m=m, k=d, n=v,
                                  itemsize=4, out_itemsize=4, pallas=True,
                                  gemv=True))
    got, _ = td.select(td.OpSpec(domain="matmul", m=m, k=d, n=v,
                                 pallas=True, gemv=True))
    assert got == want == ("skinny_sta" if k == 2 else "xla")


@pytest.mark.parametrize("m,k,n,pallas,tt,want", [
    (8, 2048, 50304, True, False, "head_sample_fused"),   # decode
    (1, 2048, 50304, True, False, "head_sample_fused"),   # prefill row
    (24, 2048, 50304, True, False, "head_sample_fused"),  # draft_k rows
    (8, 2048, 50304, True, True, "head_sample_xla"),      # top-k / top-p
    (4, 128, 512, True, False, "head_sample_fused"),      # smoke width
    (8, 128, 512, False, False, "head_sample_xla"),       # plain route
    (40, 2048, 50304, True, False, "head_sample_xla"),    # M > 32
    (8, 2048, 50000, True, False, "head_sample_xla"),     # N % 128
])
def test_head_sample_routes_match_reference(m, k, n, pallas, tt, want):
    """The sampling head's route (``head_sample`` domain) in both
    packages: the fused kernel for float rows at M ≤ 32 with K and N
    multiples of 128 and no top-k / top-p row."""
    jspec = jd.OpSpec(domain="head_sample", m=m, k=k, n=n, itemsize=4,
                      out_itemsize=4, gemv=True, pallas=pallas, sample_tt=tt)
    tspec = td.OpSpec(domain="head_sample", m=m, k=k, n=n, gemv=True,
                      pallas=pallas, sample_tt=tt)
    jname, _ = jd.select(jspec, {})
    tname, reasons = td.select(tspec, {})
    assert tname == jname == want, reasons


def test_head_sample_route_pins():
    """A pin to either route (``kernel_routes``) is honoured where its
    guard admits; ``route=`` names one outright and raises where the
    guard refuses."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal((4, 128)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((128, 256)).astype(np.float32))
    rows = (torch.full((4,), 0.7), torch.ones(4), torch.zeros(4),
            torch.zeros(4), torch.arange(4, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32))
    args = (h, w, torch.zeros((4, 256), dtype=torch.int32)) + rows
    a = td.head_sample(*args, route="head_sample_xla", pallas=True)
    b = td.head_sample(*args, route="head_sample_fused", pallas=True)
    assert torch.equal(a, b)
    _, tcfg = _cfgs(True)
    pinned = tcfg.replace(kernel_routes=(("head_sample", "head_sample_xla"),))
    spec = td.OpSpec(domain="head_sample", m=4, k=128, n=256, pallas=True)
    assert td.select(spec, td.routes_from_cfg(pinned))[0] == \
        "head_sample_xla"
    with pytest.raises(ValueError, match="rejected"):
        td.head_sample(*args, route="head_sample_fused", pallas=False)


def _cnn_layers(cfg):
    """(name, h, w, c, N) of every conv, then ("fc", K, N) — full width."""
    layers, size, c = [], cfg.cnn_img, cfg.cnn_in_ch
    for i, n in enumerate(cfg.cnn_channels):
        layers.append((f"conv{i}", size, size, c, n))
        size, c = size // 2, n
    return layers, size * size * c


def _cnn_specs(arch: str, b: int, mode: str):
    """(layer, jax OpSpec, port OpSpec) of every conv and the classifier
    the CNN issues at batch b under ``matmul=mode`` ("sta": dense weights;
    "dbb": packed where K % 8 == 0). Bias and ReLU ride each conv, bias
    the classifier, as `cnn_apply` calls them."""
    cfg = tget(arch)
    k, nnz = cfg.cnn_kernel, cfg.dbb.nnz
    layers, fdim = _cnn_layers(cfg)
    out = []
    for name, h, w, c, n in layers:
        kd = k * k * c
        packed = mode == "dbb" and kd % 8 == 0
        geom = (b, h, w, c, k, k, 1)
        out.append((name,
                    jd.OpSpec(domain="conv", m=b * h * w, k=kd, n=n,
                              packed=packed, nnz=nnz, vals_itemsize=4,
                              epilogue_ops=2, pallas=True,
                              conv_geom=geom + ("SAME",)),
                    td.OpSpec(domain="conv", m=b * h * w, k=kd, n=n,
                              packed=packed, nnz=nnz, pallas=True,
                              conv_geom=geom)))
    packed = mode == "dbb"
    out.append(("fc",
                jd.OpSpec(domain="matmul", m=b, k=fdim, n=cfg.cnn_classes,
                          packed=packed, nnz=nnz, vals_itemsize=4,
                          epilogue_ops=1, pallas=True),
                td.OpSpec(domain="matmul", m=b, k=fdim, n=cfg.cnn_classes,
                          packed=packed, nnz=nnz, pallas=True)))
    return out


# the reference's routes at full width (ISSUE table; lenet's fc at batch
# 256 takes the plain route in the reference's cost model)
CNN_ROUTES = {
    ("convnet-dbb", "dbb", 1): ["conv_sta", "conv_dbb", "conv_dbb",
                                "skinny_dbb"],
    ("convnet-dbb", "dbb", 256): ["conv_sta", "conv_dbb", "conv_dbb",
                                  "dbb_packed"],
    ("convnet-dbb", "sta", 1): ["conv_sta"] * 3 + ["xla"],
    ("convnet-dbb", "sta", 256): ["conv_sta"] * 3 + ["xla"],
    ("lenet5-dbb", "dbb", 1): ["conv_xla", "conv_sta", "skinny_dbb"],
    ("lenet5-dbb", "dbb", 256): ["conv_xla", "conv_sta", "xla"],
    ("lenet5-dbb", "sta", 1): ["conv_xla", "conv_sta", "xla"],
    ("lenet5-dbb", "sta", 256): ["conv_xla", "conv_sta", "xla"],
}


@pytest.mark.parametrize("arch,mode,b", sorted(CNN_ROUTES))
def test_cnn_routes_match_reference(arch, mode, b):
    got_all = []
    for name, jspec, tspec in _cnn_specs(arch, b, mode):
        want, _ = jd.select(jspec)
        got, _ = td.select(tspec)
        assert got == want, (arch, mode, b, name, got, want)
        got_all.append(got)
    assert got_all == CNN_ROUTES[(arch, mode, b)]


@pytest.mark.parametrize("b", [1, 8, 64, 256])
def test_cnn_fc_routes_match_reference_at_every_batch(b):
    """The packed classifiers at the batches between: K = 4096 keeps its
    kernel, K = 784 drops to the plain route at 256 only."""
    for arch in ("convnet-dbb", "lenet5-dbb"):
        _, jspec, tspec = _cnn_specs(arch, b, "dbb")[-1]
        assert td.select(tspec)[0] == jd.select(jspec)[0]


def test_conv_pins_and_use_kernel(monkeypatch):
    """``use_kernel=False`` (pallas off) leaves only ``conv_xla``; a pin
    carries over by name; a pin whose guard rejects falls back."""
    _, _, spec = _cnn_specs("convnet-dbb", 8, "dbb")[1]
    assert td.select(spec)[0] == "conv_dbb"
    off = td.OpSpec(**{**spec.__dict__, "pallas": False})
    assert td.select(off)[0] == "conv_xla"
    assert td.select(spec, {"conv": "conv_xla"})[0] == "conv_xla"
    monkeypatch.setenv("REPRO_FORCE_ROUTE", "conv=conv_sta")
    with pytest.warns(UserWarning, match="not applicable"):
        assert td.select(spec)[0] == "conv_dbb"
