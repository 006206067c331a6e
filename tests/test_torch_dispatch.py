"""The port's route choice against the reference's registry
(`repro.kernels.dispatch.select`) on the serving path's shapes, at the
smoke and the full olmo-1b widths, and the override order
REPRO_FORCE_ROUTE > kernel_routes > auto."""
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
    monkeypatch.setenv("REPRO_FORCE_ROUTE", "matmul=sta")
    _, tcfg = _cfgs(True)
    _, tspec = _matmul_specs(tcfg, 48)[0]
    with pytest.warns(UserWarning, match="not ported"):
        name, reasons = td.select(tspec, {})
    assert name == "dbb_packed" and "sta" not in reasons
