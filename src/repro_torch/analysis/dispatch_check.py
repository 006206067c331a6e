"""Dispatch registry consistency: the reference's pass over the port's
route tables (``repro_torch.kernels.dispatch.ROUTES``), costed on the H100.

Sweeps each domain's routes over `OpSpec`s built from the full-width dims
of the 12 configs (d_model, d_ff, vocab, the attention projections'
widths, MoE residual widths, head dims, GQA groups; the CNNs' convs and
classifiers) on the reference's M ladder ``(1, 8, 32, 256, 1024)``: dense
and packed (the f32, INT8 and w4 values planes), float and int8
activations, flash on and off, and flags:

  * ``unreachable``: a route whose guard rejects every spec in the sweep;
  * ``shadowed``: a route applicable somewhere but chosen nowhere;
  * ``non-monotone-cost``: a route whose modeled cost falls when M, N or
    K doubles, all else fixed.

The sweep replays `dispatch.select`'s auto path (guards, costs, defer,
cost-tie priority break) over the given table on ``HW_H100``, hermetic:
it analyses fixture registries the same way as the real one, and no
``REPRO_FORCE_ROUTE`` override can distort reachability.

The port's sweep finds no exception to name here: every route of every
domain is chosen somewhere on it and every cost is monotone
(tests/test_torch_analysis.py holds the repo clean).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.contracts import Violation

__all__ = ["default_specs", "check_registry", "routes_by_domain"]

# canonical M ladder: decode token, GQA group, skinny cap, prefill tiles
_MS = (1, 8, 32, 256, 1024)


def routes_by_domain() -> Dict[str, Dict]:
    """The port's tables as ``{domain: {name: Route}}``."""
    from repro_torch.kernels.dispatch import ROUTES
    return {d: {r.name: r for r in table} for d, table in ROUTES.items()}


def _lm_dims(cfg) -> List[Tuple[int, int]]:
    """The (K, N) of a config's layer GEMMs and head."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    pairs = {(d, cfg.d_ff), (cfg.d_ff, d), (d, cfg.vocab_size),
             (d, cfg.num_heads * hd), (cfg.num_heads * hd, d),
             (d, cfg.num_kv_heads * hd)}
    if cfg.moe.dense_residual_ff:
        r = cfg.moe.dense_residual_ff
        pairs |= {(d, r), (r, d)}
    if cfg.family == "zamba2":
        inner = cfg.ssm.expand * d
        pairs |= {(d, inner), (inner, d)}
    return sorted(pairs)


def _cnn_convs(cfg) -> List[Tuple[int, int, int, int, int, int]]:
    """(h, w, c, n, kh, stride) of each conv of a CNN config (2x2 pools
    between them)."""
    out, c, s = [], cfg.cnn_in_ch, cfg.cnn_img
    for n in cfg.cnn_channels:
        out.append((s, s, c, n, cfg.cnn_kernel, 1))
        c, s = n, s // 2
    return out


def default_specs() -> Dict[str, List]:
    """Per-domain OpSpec sweep from the configs' full-width dims."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.kernels.dispatch import OpSpec
    cfgs = [get_config(a) for a in ARCHS]
    lms = [c for c in cfgs if c.family != "cnn"]
    cnns = [c for c in cfgs if c.family == "cnn"]

    pairs = sorted({p for c in lms for p in _lm_dims(c)})
    for c in cnns:                       # the classifiers
        s = c.cnn_img >> len(c.cnn_channels)
        pairs.append((s * s * c.cnn_channels[-1], c.cnn_classes))
    mm: List[OpSpec] = []
    for m in _MS:
        for k, n in pairs:
            base = dict(domain="matmul", m=m, k=k, n=n, pallas=True)
            mm.append(OpSpec(itemsize=2, out_itemsize=2, **base))
            mm.append(OpSpec(itemsize=1, out_itemsize=4, x_int8=True,
                             **base))
            if k % 8:
                continue
            mm.append(OpSpec(itemsize=2, out_itemsize=2, packed=True,
                             vals_itemsize=4, **base))
            mm.append(OpSpec(itemsize=2, out_itemsize=2, packed=True,
                             int8_values=True, **base))
            mm.append(OpSpec(itemsize=1, out_itemsize=4, packed=True,
                             x_int8=True, int8_values=True, **base))
            if k % 128 == 0:
                mm.append(OpSpec(itemsize=2, out_itemsize=2, packed=True,
                                 bits=4, group=128, **base))
    for c in lms:
        for m in (1, 8, 32):             # the decode head GEMV
            mm.append(OpSpec(domain="matmul", m=m, k=c.d_model,
                             n=c.vocab_size, pallas=True, gemv=True))
    mm.append(OpSpec(domain="matmul", m=8, k=2048, n=2048, pallas=False))

    conv: List[OpSpec] = []
    for c in cnns:
        for h, w, ch, n, k, stride in _cnn_convs(c):
            for b in (1, 256):
                for packed in (False, True):
                    for pallas in (True, False):
                        for int8 in (False, True):
                            conv.append(_conv_spec(
                                b, h, w, ch, k, k, stride, n, packed=packed,
                                pallas=pallas, x_int8=int8,
                                nnz=c.dbb.nnz))

    attn: List[OpSpec] = []
    hds = sorted({c.resolved_head_dim for c in lms})
    for d in hds:
        for t, chunk in ((256, 256), (2048, 256), (4096, 1024)):
            for flash in (True, False):
                attn.append(OpSpec(
                    domain="attention", m=t, k=d, n=t, itemsize=2,
                    out_itemsize=2, batch=2, chunk=chunk,
                    flash_active=flash))
        for flash in (True, False):
            attn.append(OpSpec(
                domain="attention", m=1024, k=d, n=1024, itemsize=2,
                out_itemsize=2, chunk=1024, flash_active=flash,
                packed_seq=True))

    dec: List[OpSpec] = []
    groups = sorted({(c.num_heads // c.num_kv_heads, c.resolved_head_dim)
                     for c in lms})
    for g, d in groups:
        for flash in (True, False):
            for ring in (False, True):
                dec.append(OpSpec(
                    domain="attn_decode", m=g, k=d, n=640, itemsize=2,
                    out_itemsize=2, page=64, ring=ring, flash_active=flash))

    hs: List[OpSpec] = []
    for c in lms:
        for m in _MS:
            for pallas in (True, False):
                for tt in (False, True):
                    hs.append(OpSpec(domain="head_sample", m=m,
                                     k=c.d_model, n=c.vocab_size,
                                     pallas=pallas, gemv=True,
                                     sample_tt=tt))
    return {"matmul": mm, "conv": conv, "attention": attn,
            "attn_decode": dec, "head_sample": hs}


def _conv_spec(b, h, w, c, kh, kw, stride, n, *, packed, pallas,
               x_int8=False, nnz=4):
    from repro_torch.kernels.conv_gemm.ref import out_spatial
    from repro_torch.kernels.dispatch import OpSpec
    ho, _, _ = out_spatial(h, kh, stride, "SAME")
    wo, _, _ = out_spatial(w, kw, stride, "SAME")
    return OpSpec(domain="conv", m=b * ho * wo, k=kh * kw * c, n=n,
                  itemsize=1 if x_int8 else 4,
                  out_itemsize=4, packed=packed, pallas=pallas, nnz=nnz,
                  x_int8=x_int8, int8_values=packed and x_int8,
                  conv_geom=(b, h, w, c, kh, kw, stride, "SAME"))


def _grow(spec, dim: str):
    """The same spec with one problem dimension doubled (conv specs grow
    the generating geometry so conv_geom stays consistent)."""
    if spec.domain == "conv" and spec.conv_geom:
        b, h, w, c, kh, kw, stride = spec.conv_geom[:7]
        kw_ = dict(packed=spec.packed, pallas=spec.pallas,
                   x_int8=spec.x_int8, nnz=spec.nnz)
        if dim == "m":
            return _conv_spec(b, 2 * h, w, c, kh, kw, stride, spec.n, **kw_)
        if dim == "k":
            return _conv_spec(b, h, w, 2 * c, kh, kw, stride, spec.n, **kw_)
        return dataclasses.replace(spec, n=2 * spec.n)
    if spec.domain == "attention" and dim in ("m", "n"):
        # T and S grow together for self-attention specs (T != S flips
        # the chunked guard rather than testing cost shape)
        return dataclasses.replace(spec, m=2 * spec.m, n=2 * spec.n)
    return dataclasses.replace(spec, **{dim: 2 * getattr(spec, dim)})


def _auto_select(table: Dict, spec) -> Optional[str]:
    """`dispatch.select`'s auto path over an explicit route table."""
    from repro_torch.kernels.dispatch import COST_TIE_RTOL, _decide
    from repro_torch.roofline.analysis import HW_H100
    decisions = [_decide(r, spec, HW_H100) for r in table.values()]
    cands = [d for d in decisions if d.applicable and not d.deferred]
    if not cands:
        cands = [d for d in decisions if d.applicable]
    if not cands:
        return None
    best = min(d.cost_s for d in cands)
    tied = [d for d in cands if d.cost_s <= best * (1.0 + COST_TIE_RTOL)]
    return min(tied, key=lambda d: (d.priority, d.cost_s, d.name)).name


def check_registry(routes_by_domain: Dict[str, Dict],
                   specs_by_domain: Dict[str, Sequence],
                   ) -> Tuple[int, List[Violation]]:
    """Run the three registry checks. ``routes_by_domain`` maps domain →
    {name: Route}; ``specs_by_domain`` maps domain → OpSpec sweep."""
    out: List[Violation] = []
    checked = 0
    for domain, table in routes_by_domain.items():
        specs = list(specs_by_domain.get(domain, ()))
        if not specs:
            continue
        applicable = {name: 0 for name in table}
        chosen = {name: 0 for name in table}
        for spec in specs:
            checked += 1
            for name, route in table.items():
                if route.guard(spec) == "":
                    applicable[name] += 1
            name = _auto_select(table, spec)
            if name in chosen:
                chosen[name] += 1
        for name in table:
            if applicable[name] == 0:
                out.append(Violation(
                    pass_name="dispatch", code="unreachable",
                    subject=f"{domain}:{name}",
                    message=f"guard rejects all {len(specs)} specs "
                            f"in the sweep"))
            elif chosen[name] == 0:
                out.append(Violation(
                    pass_name="dispatch", code="shadowed",
                    subject=f"{domain}:{name}",
                    message=f"applicable on {applicable[name]} "
                            f"specs but never selected (cost/"
                            f"priority can never win)"))
        out.extend(_check_monotone(domain, table, specs))
    return checked, out


def _check_monotone(domain: str, table: Dict, specs: Sequence
                    ) -> List[Violation]:
    from repro_torch.roofline.analysis import HW_H100
    out: List[Violation] = []
    flagged = set()
    for spec in specs:
        for dim in ("m", "k", "n"):
            try:
                grown = _grow(spec, dim)
            except Exception:
                continue
            for name, route in table.items():
                if name in flagged:
                    continue
                c0 = _cost_s(route, spec, HW_H100)
                c1 = _cost_s(route, grown, HW_H100)
                if c1 < c0 * (1.0 - 1e-9):
                    flagged.add(name)
                    out.append(Violation(
                        pass_name="dispatch", code="non-monotone-cost",
                        subject=f"{domain}:{name}",
                        message=f"cost decreases when {dim.upper()} "
                                f"doubles ({c0:.3e}s → {c1:.3e}s at "
                                f"m={spec.m} k={spec.k} n={spec.n})"))
    return out


def _cost_s(route, spec, hw) -> float:
    flops, nbytes = route.cost(spec)
    return max(flops / hw.peak_flops, nbytes / hw.hbm_bw)
