"""``python -m repro_torch.analysis.lint``: run the port's verifier.

Default: the repo's shared-memory contracts and the source pass on the
limit's spelling, the materialization checks, the workspace sizes, the
real dispatch registry over the configs' sweep (and its guards on the
per-shard instances of a TP split), and the import layering.
Exit 0 when clean, 1 when any pass reports a violation.

It runs on the card (``--device cuda``, the default): the kernel-route
checks then run and the smem pass adds ptxas's static shared memory and
reads the card's opt-in limit. ``--device cpu`` runs what needs no card
and lists the kernel-route checks as skipped. Without a card and without
``--device cpu`` it exits 2 with the reason; it never falls back.

``--contracts MODULE`` swaps the inputs for a module (dotted path or
``.py`` file) exporting any of ``SMEM_CONTRACTS`` (list of SmemContract),
``MATERIALIZATION_CHECKS``, ``ROUTES`` + ``SPECS`` (dicts keyed by
domain); passes without input are skipped, as are the repo-wide passes.
This is how the known-bad fixtures under ``tests/fixtures/`` prove each
pass catches its bug class.

``--json PATH`` writes the machine-readable report.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
from typing import Any, Dict, List, Optional

import torch

from repro_torch.analysis import (dispatch_check, layering, materialize,
                                  smem, tp_smem)
from repro_torch.analysis.contracts import Violation

__all__ = ["run", "main", "workspace_pass"]


def _load_module(spec: str):
    if spec.endswith(".py"):
        name = os.path.splitext(os.path.basename(spec))[0]
        modspec = importlib.util.spec_from_file_location(name, spec)
        mod = importlib.util.module_from_spec(modspec)
        modspec.loader.exec_module(mod)
        return mod
    return importlib.import_module(spec)


def _src_root() -> str:
    # .../src/repro_torch/analysis/lint.py → .../src
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


# the skinny and sampling shapes the materialization checks run: (K, N)
_SKINNY_SHAPES = ((8192, 2048), (2048, 8192), (2048, 2048), (2048, 50304))
_HEAD_SHAPES = ((2048, 50304),)


def workspace_pass(device: torch.device):
    """Each workspace function against its dense bound at the checks'
    shapes (here and on the card) and, on the card, each Python split
    count against the library's: ``(n_checked, violations, rows)``."""
    from repro_torch.kernels.attn.ops import decode_workspace_elems
    from repro_torch.kernels.sample import ops as so
    from repro_torch.kernels.skinny import ops as sk
    out: List[Violation] = []
    rows: List[Dict[str, Any]] = []
    card = device.type == "cuda"

    def bound(name, ws_bytes, dense_bytes):
        rows.append({"name": name, "workspace_bytes": ws_bytes,
                     "dense_bytes": dense_bytes})
        if ws_bytes >= dense_bytes:
            out.append(Violation("workspace", "workspace-over-dense", name,
                                 f"workspace {ws_bytes} B reaches the dense "
                                 f"{dense_bytes} B"))

    def split(name, py, lib):
        rows.append({"name": name, "python": py, "library": lib})
        if py != lib:
            out.append(Violation("workspace", "split-mismatch", name,
                                 f"Python rule {py}, library {lib}"))

    for k_dim, n in _SKINNY_SHAPES:
        for m in (8, 24, 32):
            for dt, esz, xsz in ((torch.bfloat16, 4, 2),
                                 (torch.int8, 4, 1)):
                ws = sk.workspace_elems(m, k_dim, n, dt) * esz
                # the [K, N] dense weight in x's dtype
                bound(f"skinny M{m} K{k_dim} N{n} {dt}", ws,
                      k_dim * n * xsz)
        if card:
            split(f"dbb_gemm_skinny splits K{k_dim} N{n}",
                  sk.splits(k_dim, n),
                  sk.library_splits("dbb_gemm_skinny", False, k_dim, n))
            for kern in ("dbb_gemm_skinny", "sta_gemm_skinny"):
                split(f"{kern} s8 splits K{k_dim} N{n}",
                      sk.s8_splits(k_dim, n),
                      sk.library_splits(kern, True, k_dim, n))
    for k_dim, n in _HEAD_SHAPES:
        for m in (1, 8, 32):
            bound(f"head_sample M{m} K{k_dim} N{n}",
                  8 * so.workspace_elems(m, k_dim, n), 4 * m * n)
        if card:
            split(f"head_sample partials K{k_dim} N{n}",
                  so.partials(k_dim, n), so._partials(k_dim, n))
    # the decode workspace against the [B, S, Hkv, D] gather of K and V
    for b, hkv, g, d, smax, page, esz in ((8, 16, 1, 128, 640, 64, 2),
                                          (8, 1, 8, 256, 640, 64, 2),
                                          (8, 16, 1, 128, 640, 64, 4),
                                          (1, 8, 8, 128, 4096, 16, 2)):
        ws = 4 * decode_workspace_elems(b, hkv, g, d, smax // page, page)
        bound(f"paged_decode B{b} Hkv{hkv} G{g} D{d} S{smax} page {page} "
              f"esz {esz}", ws, 2 * b * smax * hkv * d * esz)
    return len(rows), out, rows


def _smem_pass(cs, device: torch.device, repo_mode: bool):
    """The contracts (on the card with ptxas's static bytes, held to the
    card's opt-in limit) and, in repo mode, the limit-sites source pass."""
    rows = []
    static, limit, found = None, None, []
    if device.type == "cuda" and repo_mode:
        from repro_torch.kernels import build
        build.build()
        static, found = smem.with_static(cs, smem.static_smem(build.BUILD_DIR))
        limit = smem.optin_limit()
        if limit != smem.SMEM_LIMIT:
            found.append(Violation(
                "smem", "limit-mismatch", "SMEM_LIMIT",
                f"the card's opt-in limit is {limit} B, the port's "
                f"SMEM_LIMIT {smem.SMEM_LIMIT} B"))
    n, v = smem.check_contracts(cs, static, limit)
    for c in cs:
        rows.append({"name": c.name, "dynamic": c.smem_bytes,
                     "static": (static or {}).get(c.name),
                     "limit": limit or c.budget, "admitted": c.admitted})
    v = v + found
    if repo_mode:
        n2, v2 = smem.check_limit_sites(_src_root())
        n, v = n + n2, v + v2
    return n, v, rows


def run(contracts_module: Optional[str] = None,
        device: str = "cuda") -> Dict[str, Any]:
    """Execute every pass on ``device``; returns the JSON-able report.
    Raises RuntimeError for ``device="cuda"`` without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card (torch.cuda.is_available() is "
                           "False): pass --device cpu to run the passes "
                           "that need none")
    repo_mode = contracts_module is None
    if repo_mode:
        cs = smem.contracts()
        checks = materialize.repo_checks()
        routes = dispatch_check.routes_by_domain()
        specs = dispatch_check.default_specs()
    else:
        mod = _load_module(contracts_module)
        cs = list(getattr(mod, "SMEM_CONTRACTS", ()))
        checks = list(getattr(mod, "MATERIALIZATION_CHECKS", ()))
        routes = dict(getattr(mod, "ROUTES", {}))
        specs = dict(getattr(mod, "SPECS", {}))

    passes: Dict[str, Dict[str, Any]] = {}

    def record(name: str, checked: int, violations: List[Violation],
               skipped: bool = False, rows=None) -> None:
        passes[name] = {
            "checked": checked, "skipped": skipped,
            "violations": [v.as_dict() for v in violations]}
        if rows is not None:
            passes[name]["rows"] = rows

    if cs:
        n, v, rows = _smem_pass(cs, dev, repo_mode)
        record("smem", n, v, rows=rows)
    else:
        record("smem", 0, [], skipped=True)
    if checks:
        n, v, rows = materialize.run_checks(checks, dev)
        record("materialize", n, v, rows=rows)
    else:
        record("materialize", 0, [], skipped=True)
    if repo_mode:
        n, v, rows = workspace_pass(dev)
        record("workspace", n, v, rows=rows)
    else:
        record("workspace", 0, [], skipped=True)
    if routes and specs:
        record("dispatch", *dispatch_check.check_registry(routes, specs))
        record("tp-smem", *tp_smem.check_registry(routes, specs))
    else:
        record("dispatch", 0, [], skipped=True)
        record("tp-smem", 0, [], skipped=True)
    if repo_mode:
        record("layering", *layering.check(_src_root()))
    else:
        record("layering", 0, [], skipped=True)

    total = sum(len(p["violations"]) for p in passes.values())
    return {"ok": total == 0, "violation_count": total,
            "device": str(dev), "passes": passes}


def render(report: Dict[str, Any]) -> str:
    """The human-readable report: each pass's counts, each materialization
    case's figures (bytes), each skipped check with its reason."""
    lines = []
    for name, p in report["passes"].items():
        if p["skipped"]:
            lines.append(f"  {name:<12} skipped (no input)")
            continue
        n_v = len(p["violations"])
        status = "OK" if n_v == 0 else f"{n_v} violation(s)"
        lines.append(f"  {name:<12} checked {p['checked']:<4} {status}")
        if name == "materialize":
            for r in p.get("rows", ()):
                if "skipped" in r:
                    lines.append(f"    {r['check']}: skipped, "
                                 f"{r['skipped']}")
                    continue
                line = (f"    {r['check']} [{r['case']}]: walker peak "
                        f"{r['peak_bytes']} B ({r['peak_op']})")
                if r["requested_peak"] is not None:
                    line += (f", allocator peak {r['requested_peak']} B "
                             f"requested / {r['alloc_peak']} B allocated")
                if r["allowed_bytes"] is not None:
                    line += f", out + workspace {r['allowed_bytes']} B"
                if r["dense_bytes"] is not None:
                    line += f", dense {r['dense_bytes']} B"
                lines.append(line)
        for v in p["violations"]:
            lines.append(f"    [{v['code']}] {v['subject']}")
            lines.append(f"        {v['message']}")
    verdict = ("clean" if report["ok"]
               else f"{report['violation_count']} violation(s)")
    lines.append(f"repro_torch.analysis.lint ({report['device']}): {verdict}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="the port's kernel verifier: shared-memory contracts, "
                    "materialization, workspaces, dispatch, TP shards, "
                    "layering")
    ap.add_argument("--json", metavar="PATH",
                    help="write the JSON report here")
    ap.add_argument("--contracts", metavar="MODULE",
                    help="dotted module or .py file supplying "
                         "SMEM_CONTRACTS/MATERIALIZATION_CHECKS/ROUTES+SPECS "
                         "instead of the repo's own")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default: the kernel-route checks run) or "
                         "cpu (they are listed as skipped)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the human-readable report")
    args = ap.parse_args(argv)

    try:
        report = run(contracts_module=args.contracts, device=args.device)
    except RuntimeError as e:
        print(f"repro_torch.analysis.lint: {e}", file=sys.stderr)
        return 2
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)
    if not args.quiet:
        print(render(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
