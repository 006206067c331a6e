"""The port's verifier (repro_torch.analysis), on the CPU.

* Each known-bad fixture (tests/fixtures/torch_bad_{dispatch,materialize,
  smem}.py) makes its pass fail with the reference fixture's codes (the
  reference's ``vmem-*`` are ``smem-*`` here) and leaves every other pass
  quiet; for dispatch and vmem the reference's own lint runs on its own
  fixture in the same test and the codes are compared route by route.
* The repo is clean: the smem contracts, the limit's spelling, the
  workspaces, the dispatch sweep and the layering (run once, on the CPU,
  through `lint.run`); the kernel-route materialization checks are listed
  as skipped because they need a card, and what runs here holds: the
  chunked route below [B, Hq, T, S], the naive route, the plain DBB route
  and the plain conv route reaching their dense sizes.
* The layering rules are the reference's ``DEFAULT_RULES`` mapped to the
  port; a planted breach of each is flagged.
* The hermetic selector equals ``dispatch.select`` over the sweep.
* Each shared-memory formula in analysis/smem.py and the wrappers equals
  the C expression parsed out of its source; each workspace function,
  split counts included, equals the rule parsed out of its source.
* The CLI: in process with ``--device cpu``, and one subprocess for the
  exit code and the JSON.
"""
import functools
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import (dispatch_check, layering, lint,
                                  materialize, smem)
from repro_torch.kernels.common import SMEM_LIMIT

HERE = Path(__file__).resolve().parent
FIXTURES = HERE / "fixtures"
SRC_ROOT = HERE.parent / "src"
CSRC = SRC_ROOT / "repro_torch" / "csrc"


def _codes(report, pass_name):
    return {v["code"] for v in report["passes"][pass_name]["violations"]}


@pytest.fixture(scope="module")
def repo_report():
    return lint.run(device="cpu")


# ---------------------------------------------------------------------------
# the repo is clean
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pass_name", ["smem", "materialize", "workspace",
                                       "dispatch", "layering"])
def test_repo_pass_is_clean(repo_report, pass_name):
    p = repo_report["passes"][pass_name]
    assert not p["skipped"] and p["checked"] > 0
    assert not p["violations"], p["violations"]


def test_kernel_route_checks_are_skipped_not_passed(repo_report):
    rows = repo_report["passes"]["materialize"]["rows"]
    skipped = {r["check"] for r in rows if "skipped" in r}
    assert skipped == {"attn-no-score-tensor", "packed-attn-no-score-tensor",
                       "dbb-no-dense-weight", "decode-no-gathered-kv",
                       "head-no-logits", "conv-no-im2col",
                       "decode-step-no-dense", "sta-peak"}
    assert all(r["skipped"] == "needs a card" for r in rows
               if "skipped" in r)
    assert repo_report["passes"]["materialize"]["checked"] == 4


def test_what_runs_here_holds_and_the_controls_reach(repo_report):
    """The chunked route's largest tensor is one chunk's scores, far below
    [B, Hq, T, S]; the naive route builds exactly it; the plain DBB route
    builds [K, N] (one decompress); the plain conv route builds [M, K]."""
    rows = {r["check"]: r for r in repo_report["passes"]["materialize"]
            ["rows"] if "skipped" not in r}
    b, hq, t = 2, 4, 1024
    assert rows["attn-chunked-no-score-tensor"]["peak_elems"] \
        <= b * hq * 256 * 256
    assert rows["attn-naive-control"]["peak_elems"] == b * hq * t * t
    dbb = rows["dbb-plain-control"]
    assert dbb["forbidden_hits"] and dbb["decompress_calls"] == 1
    assert rows["conv-plain-control"]["peak_elems"] == 4 * 16 * 16 * 9 * 16


def test_workspaces_stay_below_their_dense_bounds(repo_report):
    rows = repo_report["passes"]["workspace"]["rows"]
    assert len(rows) >= 20
    for r in rows:
        assert r["workspace_bytes"] < r["dense_bytes"], r


def test_walker_primitives():
    x = torch.ones(16, 16)
    big = lambda x: (x[:, None, :] * x[None, :, :]).sum(0)  # noqa: E731
    assert materialize.max_intermediate_elems(big, x) == 16 ** 3
    peak = materialize.assert_no_intermediate_larger_than(
        lambda x: x + 1.0, x, max_elems=1000)
    assert peak == 256
    with pytest.raises(AssertionError, match="materialized"):
        materialize.assert_no_intermediate_larger_than(big, x,
                                                       max_elems=4096)
    # views and in-place results allocate nothing and are not recorded
    recs = materialize.iter_outputs(lambda x: x.view(256).add_(1.0), x)
    assert recs == []
    assert materialize.alloc_bytes(1) == 512
    assert materialize.alloc_bytes(513) == 1024


def test_decompress_stats_count_every_decompress():
    from repro_torch.core.dbb import pack_dbb
    from repro_torch.core.dbb_linear import DECOMPRESS_STATS, decompress
    p = pack_dbb(torch.randn(64, 16), 8, 4)
    before = DECOMPRESS_STATS["calls"]
    decompress(p)
    decompress(p, dtype=torch.bfloat16)
    assert DECOMPRESS_STATS["calls"] == before + 2


# ---------------------------------------------------------------------------
# known-bad fixtures
# ---------------------------------------------------------------------------

_FIXTURES = [("torch_bad_smem.py", "smem", {"smem-overflow",
                                            "dead-headroom"}),
             ("torch_bad_materialize.py", "materialize", {"materialized"}),
             ("torch_bad_dispatch.py", "dispatch",
              {"unreachable", "shadowed", "non-monotone-cost"})]


@pytest.mark.parametrize("fname,pass_name,expect", _FIXTURES,
                         ids=[f[0] for f in _FIXTURES])
def test_fixture_fails_its_pass(fname, pass_name, expect):
    report = lint.run(contracts_module=str(FIXTURES / fname), device="cpu")
    assert not report["ok"]
    assert _codes(report, pass_name) == expect
    for name, p in report["passes"].items():
        if name != pass_name:
            assert not p["violations"], (name, p["violations"])


def test_fixtures_match_the_references():
    """The reference's lint on its own fixtures: the same violations per
    route (dispatch) and the same codes, vmem → smem."""
    from repro.analysis import lint as ref_lint
    ref = ref_lint.run(contracts_module=str(FIXTURES / "bad_dispatch.py"))
    port = lint.run(contracts_module=str(FIXTURES / "torch_bad_dispatch.py"),
                    device="cpu")

    def by_route(rep):
        out = {}
        for v in rep["passes"]["dispatch"]["violations"]:
            out.setdefault(v["subject"], set()).add(v["code"])
        return out
    assert by_route(port) == by_route(ref)
    ref = ref_lint.run(contracts_module=str(FIXTURES / "bad_vmem.py"))
    port = lint.run(contracts_module=str(FIXTURES / "torch_bad_smem.py"),
                    device="cpu")
    assert _codes(port, "smem") == {
        c.replace("vmem-", "smem-") for c in _codes(ref, "vmem")}


# ---------------------------------------------------------------------------
# layering
# ---------------------------------------------------------------------------

def test_layering_rules_are_the_references_mapped():
    from repro.analysis.layering import DEFAULT_RULES as REF

    def mapped(text):
        return re.sub(r"\brepro\b", "repro_torch", text)
    assert [r.name for r in layering.DEFAULT_RULES] == [r.name for r in REF]
    for port, ref in zip(layering.DEFAULT_RULES, REF):
        assert port.scope == mapped(ref.scope)
        assert port.banned.pattern == mapped(ref.banned.pattern)
        assert {k: tuple(v) for k, v in port.allow.items()} == {
            mapped(k): tuple(mapped(p) for p in v)
            for k, v in ref.allow.items()}


@pytest.mark.parametrize("rel,line,code", [
    ("models/mlp.py", "from repro_torch.kernels.epilogue import apply_act",
     "kernel-internals-private"),
    ("serve/engine.py", "from repro_torch.kernels.skinny.ops import x",
     "kernel-internals-private"),
    ("kernels/common.py", "from repro_torch.models import attention",
     "kernels-no-upper-layers")])
def test_a_planted_breach_is_flagged(tmp_path, rel, line, code):
    path = tmp_path / "repro_torch" / rel
    path.parent.mkdir(parents=True)
    path.write_text(f'"""doc: {line}"""\n{line}\n')
    n, v = layering.check(str(tmp_path))
    assert n == 1 and [x.code for x in v] == [code]
    assert v[0].subject.endswith(":2")        # the docstring is not a hit


def test_models_take_apply_act_from_the_kernels_root():
    from repro_torch.kernels import apply_act
    from repro_torch.kernels.epilogue import apply_act as epi
    assert apply_act is epi
    for name in ("mlp.py", "moe.py"):
        text = (SRC_ROOT / "repro_torch" / "models" / name).read_text()
        assert "kernels.epilogue" not in text


def test_the_limit_is_spelled_at_its_two_sites_only(tmp_path):
    n, v = smem.check_limit_sites(str(SRC_ROOT))
    assert n > 80 and not v
    for rel in ("repro_torch/kernels/attn/ops.py",
                "repro_torch/csrc/conv_tc.cuh"):
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("x = 227 * 1024\nconstexpr int k = 232448;\n")
    _, v = smem.check_limit_sites(str(tmp_path))
    assert [x.code for x in v] == ["raw-smem-limit"] * 4


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_hermetic_selector_matches_dispatch():
    from repro_torch.kernels import dispatch
    tables = dispatch_check.routes_by_domain()
    for domain, specs in dispatch_check.default_specs().items():
        assert specs
        for spec in specs[::max(1, len(specs) // 40)]:
            want, _ = dispatch.select(spec)
            assert dispatch_check._auto_select(tables[domain], spec) == want


def test_the_sweep_covers_the_configs():
    from repro_torch.configs import ARCHS, get_config
    specs = dispatch_check.default_specs()
    mm = {(s.k, s.n) for s in specs["matmul"]}
    for arch in ARCHS:
        cfg = get_config(arch)
        if cfg.family != "cnn":
            assert (cfg.d_model, cfg.d_ff) in mm, arch
            assert (cfg.d_model, cfg.vocab_size) in mm, arch
    assert {s.m for s in specs["matmul"]} >= {1, 8, 32, 256, 1024}


# ---------------------------------------------------------------------------
# the C sources, parsed
# ---------------------------------------------------------------------------

_NAMESPACES = ("repro", "sk", "tc", "tc8", "sm90", "splitk", "splitk8",
               "skinny", "convtc", "gemm")


def _strip_comments(text):
    return re.sub(r"//[^\n]*", "", text)


@functools.lru_cache(maxsize=None)
def _src(name):
    return _strip_comments((CSRC / name).read_text())


def _py(expr):
    """A C integer expression as Python: casts, template arguments and
    namespaces dropped, ``X::y`` and ``L.f`` as names, && ||, one level
    of ?:, / as floor division (every operand is non-negative)."""
    e = re.sub(r"\s+", " ", expr).strip()
    e = re.sub(r"\((?:int|size_t|long long)\)", "", e)
    e = re.sub(r"sizeof\((float|int)\)", "4", e)
    e = re.sub(r"sizeof\((?:\w+::)*(\w+)\)", r"sizeof_\1", e)
    e = re.sub(r"\b(\w+)<[^<>()]*>", r"\1", e)
    for ns in _NAMESPACES:
        e = re.sub(rf"\b{ns}::", "", e)
    e = re.sub(r"\b(\w+)::(\w+)", r"\1_\2", e)
    e = re.sub(r"\bL\.(\w+)", r"L_\1", e)
    e = e.replace("&&", " and ").replace("||", " or ")
    e = re.sub(r"(?<![<>=!/])/(?!/)", "//", e)
    while True:                      # ?: inside parentheses, innermost
        m = re.search(r"\(([^()?]*)\?([^()]*):([^()]*)\)", e)
        if not m:
            break
        e = (e[:m.start()] + f"(({m.group(2)}) if ({m.group(1)}) else "
             f"({m.group(3)}))" + e[m.end():])
    m = re.fullmatch(r"([^?]+)\?(.+):(.+)", e)
    if m:
        e = f"(({m.group(2)}) if ({m.group(1)}) else ({m.group(3)}))"
    return e


def _c_function(source, name):
    """``name``'s parameters and body statements in ``source``."""
    m = re.search(rf"\b{name}\(([^)]*)\)\s*\{{([^{{}}]*)\}}", _src(source))
    assert m, f"no {name} in {source}"
    params = [p.split()[-1] for p in m.group(1).split(",") if p.strip()]
    return params, [s.strip() for s in m.group(2).split(";") if s.strip()]


def _translate(source, name, scope):
    """``name`` of ``source`` as a Python function evaluated in ``scope``:
    declarations, ``L.f = e`` fields, ``while (c) s *= 2`` loops and the
    return (``return L`` returns the fields as a dict)."""
    params, stmts = _c_function(source, name)
    lines = [f"def {name}({', '.join(params)}):"]
    fields = []
    for st in stmts:
        st = re.sub(r"\s+", " ", st)
        st = re.sub(r"^(const )?(int|size_t|bool) ", "", st)
        if re.fullmatch(r"[A-Z]\w* L", st) or st.startswith("using "):
            continue
        loop = re.fullmatch(r"while \((.*)\) (\w+) \*= 2", st, re.S)
        if loop:
            lines.append(f"    while {_py(loop.group(1))}: "
                         f"{loop.group(2)} *= 2")
        elif st == "return L":
            lines.append("    return dict(" + ", ".join(
                f"{f}=L_{f}" for f in fields) + ")")
        elif st.startswith("return "):
            lines.append(f"    return {_py(st[7:])}")
        else:
            lhs, rhs = st.split("=", 1)
            lhs = lhs.strip()
            if lhs.startswith("L."):
                fields.append(lhs[2:])
            lines.append(f"    {_py(lhs)} = {_py(rhs)}")
    exec("\n".join(lines), scope)
    return scope[name]


@functools.lru_cache(maxsize=None)
def _consts(*sources):
    """The ``constexpr int`` constants of the sources, in order (later
    ones may read earlier ones)."""
    scope = {}
    for source in sources:
        for m in re.finditer(r"^\s*constexpr int ([^;]+);", _src(source),
                             re.M):
            for part in m.group(1).split(","):
                if "=" not in part:
                    continue
                key, expr = (s.strip() for s in part.split("=", 1))
                try:
                    scope[key] = eval(_py(expr), {}, dict(scope))
                except NameError:
                    pass
    return scope


def test_flash_smem_matches_the_sources():
    from repro_torch.kernels.attn.ops import _flash_smem_bytes
    c = _consts("flash_tile.cuh", "flash_tc.cuh")
    for d in (64, 128, 256):
        scope = dict(c, D=d)
        scope["tile_bytes"] = _translate("flash_tc.cuh", "tile_bytes",
                                         dict(scope))
        want = _translate("flash_tc.cuh", "smem_bytes", scope)()
        assert _flash_smem_bytes(d, torch.bfloat16) == want
    fma = _translate("flash_tile.cuh", "smem_bytes",
                     dict(_consts("flash_tile.cuh")))
    for d in (1, 32, 64, 72, 128, 200, 256):
        assert _flash_smem_bytes(d, torch.float32) == fma(d)


def test_decode_smem_and_workspace_match_the_source():
    from repro_torch.kernels.attn.ops import (_decode_smem_bytes,
                                              decode_workspace_elems)
    c = dict(_consts("paged_decode.cu"))
    c["kWarps"] = c["kThreads"] // 32
    fn = _translate("paged_decode.cu", "smem_bytes", c)
    for g in (1, 7, 8, 32):
        for d in (64, 128, 256):
            for esz in (2, 4):
                assert _decode_smem_bytes(g, d, esz) == fn(g, d, esz)
    # the workspace: acc [B, Hkv, NS, G, D], then m and l [B, Hkv, NS, G]
    src = re.sub(r"\s+", " ", _src("paged_decode.cu"))
    assert "const size_t n_acc = (size_t)a.B * a.Hkv * a.ns_max * G * D;" \
        in src
    assert ("a.work + n_acc + (size_t)a.B * a.Hkv * a.ns_max * G + "
            "bh * a.ns_max * G") in src
    split_pages = _translate("paged_decode.cu", "split_pages", dict(c))
    max_splits = _translate("paged_decode.cu", "max_splits",
                            dict(c, split_pages=split_pages))
    for b, hkv, g, d, n_log, page in ((8, 16, 1, 128, 10, 64),
                                      (3, 2, 7, 72, 33, 16),
                                      (1, 1, 8, 256, 5, 8)):
        ns = max_splits(n_log, page)
        assert decode_workspace_elems(b, hkv, g, d, n_log, page) == (
            b * hkv * ns * g * d + 2 * b * hkv * ns * g)


def test_tc_gemm_smem_matches_the_source():
    c = _consts("common.cuh", "tc_gemm.cuh")
    scope = dict(c, sizeof_ExpandTable=256 * 2 * 4 + 256 * 4 * 4)
    assert re.search(r"uint32_t sel\[256\]\[2\];", _src("tc_gemm.cuh"))
    assert re.search(r"uint32_t keep\[256\]\[4\];", _src("tc_gemm.cuh"))
    for rows, dbb in ((128, False), (128, True), (256, True)):
        s = dict(scope, BSrc_kRows=rows, IsDbb_value=dbb)
        s["tile_m"] = _translate("tc_gemm.cuh", "tile_m", dict(s))
        s["a_tile_bytes"] = _translate("tc_gemm.cuh", "a_tile_bytes",
                                       dict(s))
        want = _translate("tc_gemm.cuh", "smem_bytes", s)()
        assert smem.tc_gemm_smem(rows, dbb) == want


def test_tc_gemm_s8_smem_matches_the_source():
    c = _consts("common.cuh", "tc_gemm_s8.cuh")
    text = _src("tc_gemm_s8.cuh")
    assert "static constexpr int kRawBytes = BK * BN;" in text
    assert ("static constexpr int kRawBytes = kMaskBytes + kBlocks * "
            "kNnzMax * BN;") in text
    for rows, stages in ((128, 6), (256, 4)):
        for dbb in (False, True):
            raw = (c["kMaskBytes"] + c["kBlocks"] * c["kNnzMax"] * c["BN"]
                   if dbb else c["BK"] * c["BN"])
            s = dict(c, BSrc_kRows=rows, BSrc_kStages=stages,
                     BSrc_kRawBytes=raw, BSrc_kTable=dbb)
            s["stage_bytes"] = _translate("tc_gemm_s8.cuh", "stage_bytes",
                                          dict(s))
            want = _translate("tc_gemm_s8.cuh", "smem_bytes", s)()
            assert smem.tc_gemm_s8_smem(rows, stages, dbb) == want
    assert "return launch<TO>(x, bmap, cmap, Src<256, 4>" in re.sub(
        r"\s+", " ", text)


def test_split_k_smem_matches_the_source():
    """The float split-K body: ``layout<Plane>(nnz, mp, xsz, stages).total
    + 1024`` per plane (its Staged<Plane> rows and sizes and RingDepth
    parsed out of dbb_gemm_skinny.cu)."""
    c = _consts("common.cuh", "dbb_gemm_skinny.cu")
    text = re.sub(r"\s+", " ", _src("dbb_gemm_skinny.cu"))
    assert "const int smem = L.total + 1024;" in text
    staged = {}
    for plane, tag in (("f32", "F32Plane"), ("i8", "I8Plane"),
                       ("w4", "W4Plane")):
        m = re.search(rf"struct Staged<repro::{tag}> \{{(.*?)\}};", text)
        body = m.group(1)
        esz = int(re.search(r"kEsz = (\d+);", body).group(1))
        groups = re.search(r"kGroups = (\w+);", body).group(1) == "true"
        rows = re.search(r"static int rows\(int nnz\) \{ return (.*?); \}",
                         body).group(1)
        staged[plane] = (esz, groups, rows)
    depth = {"f32": int(re.search(
        r"struct RingDepth<repro::F32Plane> \{ static constexpr int value "
        r"= (\d+);", text).group(1))}
    depth["i8"] = depth["w4"] = int(re.search(
        r"struct RingDepth \{ static constexpr int value = (\d+);",
        text).group(1))
    assert depth == smem.SPLIT_RING
    for plane, (esz, groups, rows) in staged.items():
        for nnz in ((2, 4, 8) if plane == "w4" else (1, 3, 4, 8)):
            for m in (1, 8, 13, 32):
                for xsz in (2, 4):
                    s = dict(c, St_kEsz=esz, St_kGroups=groups,
                             sizeof_ExpandTable=256 * 2 * 4 + 256 * 4 * 4,
                             St_rows=lambda nnz, r=rows: eval(
                                 _py(r), dict(c), {"nnz": nnz}))
                    lay = _translate("dbb_gemm_skinny.cu", "layout", s)(
                        nnz, (m + 7) // 8 * 8, xsz, depth[plane])
                    assert smem.split_smem(plane, nnz, m, xsz) == \
                        lay["total"] + 1024, (plane, nnz, m, xsz)


@functools.lru_cache(maxsize=None)
def _s8_scope():
    """split_k_s8.cuh's constants over those it reads (common.cuh,
    split_k.cuh, tc_gemm_s8.cuh's kMaskBytes)."""
    return _consts("common.cuh", "split_k.cuh", "tc_gemm_s8.cuh",
                   "split_k_s8.cuh")


def test_split_k_s8_smem_matches_the_source():
    c = dict(_s8_scope())
    c["raw_bytes"] = _translate("split_k_s8.cuh", "raw_bytes", dict(c))
    c["slot_bytes"] = _translate("split_k_s8.cuh", "slot_bytes", dict(c))
    fn = _translate("split_k_s8.cuh", "smem_bytes", c)
    for dbb in (False, True):
        for nnz in (1, 2, 4, 8):
            for m in (1, 8, 24, 32):
                assert smem.split_s8_smem(dbb, nnz, m) == fn(
                    dbb, nnz, (m + 7) // 8 * 8)


def test_skinny_float_smem_matches_the_source():
    c = dict(_consts("common.cuh", "split_k.cuh", "skinny_float.cuh"))
    text = re.sub(r"\s+", " ", _src("skinny_float.cuh"))
    lanes = {4: re.search(r"struct Lanes<float> \{ static constexpr int "
                          r"C = \d+, RL = (\d+), PC = \d+, kStages = (\d+);",
                          text),
             2: re.search(r"struct Lanes<__nv_bfloat16> \{ static constexpr "
                          r"int C = \d+, RL = (\d+), PC = \d+, kStages = "
                          r"(\d+);", text)}
    assert "a.xr = ((MT == 1 ? a.M : MT * q * Lanes<T>::RL) + 7) / 8 * 8;" \
        in text
    ladder = [int(x) for x in re.findall(
        r"return launch_float_mt<T, (\d+)>", text)]
    assert ladder == [1, 2, 4, 6, 8, 12, 16]
    cluster_q = _translate("skinny_float.cuh", "cluster_q", dict(c))
    layout = _translate("skinny_float.cuh", "layout", dict(c))
    for esz, m_ in lanes.items():
        rl, stages = int(m_.group(1)), int(m_.group(2))
        for m, k_dim, n in ((1, 2048, 2048), (8, 2048, 8192),
                            (24, 8192, 2048), (32, 2048, 50304),
                            (5, 1024, 4224), (32, 7168, 163840)):
            q = cluster_q(k_dim, n)
            assert smem.skinny_float_q(k_dim, n) == q
            rows = -(-m // (q * rl))
            mt = next(t for t in ladder if rows <= t)
            xr = ((m if mt == 1 else mt * q * rl) + 7) // 8 * 8
            want = layout(esz, xr, stages, q)["total"]
            assert smem.skinny_float_smem(m, k_dim, n, esz) == want


def test_conv_tc_smem_matches_the_source():
    c = dict(_consts("common.cuh", "hopper.cuh", "tc_gemm_s8.cuh"))
    tc8_mask = c["kMaskBytes"]
    c.update(_consts("common.cuh", "hopper.cuh", "conv_tc.cuh"))
    assert c["kSmemMax"] == c["kSmemLimit"] == SMEM_LIMIT
    text = re.sub(r"\s+", " ", _src("conv_tc.cuh"))
    assert "constexpr int kSmemMax = kSmemLimit;" in text
    slots = _translate("conv_tc.cuh", "slots", dict(c))
    for int8 in (False, True):
        tag = "int8_t" if int8 else "float"
        body = re.search(rf"struct Stage<{tag}> \{{(.*?)\}};", text).group(1)
        s = dict(c, slots=slots, kMaskBytes=tc8_mask)
        for decl in re.findall(r"static constexpr int ([^;]+);", body):
            for key, expr in re.findall(r"(\w+) = ([^,]+)", decl):
                s[key] = eval(_py(expr), dict(s))
        for fname in ("mask_bytes", "half_bytes", "raw_bytes"):
            m = re.search(rf"static int {fname}\(int nnz\) \{{ return "
                          rf"(.*?); \}}", body)
            if m:
                s[f"Stage_{fname}"] = s[fname] = (
                    lambda nnz, e=_py(m.group(1)), s=s: eval(
                        e, s, {"nnz": nnz}))
        s["Stage_kBTiles"] = s["kBTiles"]
        s["stage_bytes"] = _translate("conv_tc.cuh", "stage_bytes", dict(s))
        stages_for = _translate("conv_tc.cuh", "stages_for", dict(s))
        fn = _translate("conv_tc.cuh", "smem_bytes", dict(s))
        for nnz in (0, 1, 2, 4, 8):
            assert smem.conv_tc_stages(int8, nnz) == stages_for(nnz)
            assert smem.conv_tc_smem(int8, nnz) == fn(nnz, stages_for(nnz))


def test_conv_small_smem_matches_the_source():
    c = dict(_consts("common.cuh", "conv_gemm.cu"))
    text = re.sub(r"\s+", " ", _src("conv_gemm.cu"))
    c["align16"] = _translate("conv_gemm.cu", "align16", dict(c))
    small_smem = _translate("conv_gemm.cu", "small_smem", dict(c))
    # the tiling loop, pinned: the band's columns, rows, halved R first
    for line in ("sg.CW = g.Wo < kBand ? g.Wo : kBand;",
                 "sg.R = kBand / sg.CW < g.Ho ? kBand / sg.CW : g.Ho;",
                 "if (bytes <= kWindowMax || (sg.R == 1 && sg.CW == 1)) "
                 "break;",
                 "const int nwin = sg.WR * sg.WC * (sg.cp / Small<T>::kPack);",
                 "const int smem = small_smem(sg.words, CL * kNT, nwin).total;"):
        assert line in text, line
    for h, w, ch, n, k, stride, pad, int8 in (
            (32, 32, 3, 64, 3, 1, "SAME", False),
            (32, 32, 3, 64, 3, 1, "SAME", True),
            (14, 14, 6, 16, 5, 1, "SAME", False),
            (33, 31, 5, 40, 5, 2, "VALID", True)):
        pack = 4 if int8 else 1
        cp = -(-ch // pack) * pack
        words = k * k * cp // pack
        ho = -(-h // stride) if pad == "SAME" else (h - k) // stride + 1
        wo = -(-w // stride) if pad == "SAME" else (w - k) // stride + 1
        cw = min(wo, c["kBand"])
        r = min(c["kBand"] // cw, ho)
        while True:
            wr, wc = (r - 1) * stride + k, (cw - 1) * stride + k
            if wr * wc * cp * 4 // pack <= c["kWindowMax"] or (
                    r == 1 and cw == 1):
                break
            if r > 1:
                r = (r + 1) // 2
            else:
                cw = (cw + 1) // 2
        cl = next(x for x in (1, 2, 4, 8) if n <= x * c["kNT"])
        want = small_smem(words, cl * c["kNT"], wr * wc * (cp // pack))
        assert smem.conv_small_smem(h, w, ch, n, k, k, stride, pad,
                                    int8) == want["total"]


def test_skinny_splits_match_the_sources():
    from repro_torch.kernels.skinny.ops import s8_splits, splits
    c = dict(_consts("common.cuh", "split_k.cuh", "dbb_gemm_skinny.cu"))
    c["kMaxSplit"], c["kSMs"] = 8, 132
    assert _consts("common.cuh", "split_k.cuh")["kSMs"] == 132
    fl = _translate("dbb_gemm_skinny.cu", "splits", c)
    s8 = _translate("split_k_s8.cuh", "splits", dict(_s8_scope()))
    for k_dim in (0, 8, 264, 512, 1184, 2048, 4096, 7168, 8192, 16384):
        # N 2112, 4224 and 8448: 33, 66 and 132 tiles, where the grid
        # limits' comparisons meet equality
        for n in (1, 10, 136, 200, 640, 2048, 2112, 4224, 8192, 8448,
                  50304):
            assert splits(k_dim, n) == fl(k_dim, n), (k_dim, n)
            assert s8_splits(k_dim, n) == s8(k_dim, n), (k_dim, n)


def test_head_partials_match_the_source():
    from repro_torch.kernels.sample.ops import partials, workspace_elems
    c = dict(_consts("common.cuh", "split_k.cuh", "skinny_float.cuh"))
    cq = _translate("skinny_float.cuh", "cluster_q", dict(c))
    blocks = _translate("skinny_float.cuh", "blocks", dict(c, cluster_q=cq))
    for k_dim in (128, 2048, 7168):
        for n in (128, 4224, 50304, 163840):
            assert partials(k_dim, n) == blocks(k_dim, n)
            assert workspace_elems(8, k_dim, n) == 8 * blocks(k_dim, n)


def test_every_smem_contract_fits_or_is_refused_for_cause():
    cs = smem.contracts()
    assert len({c.name for c in cs}) == len(cs) >= 100
    for c in cs:
        assert c.budget == SMEM_LIMIT
        if c.admitted:
            assert c.smem_bytes <= SMEM_LIMIT, c
        elif c.smem_reject:
            assert c.smem_bytes > SMEM_LIMIT, c
    bodies = {c.body.split(":")[0] for c in cs}
    assert bodies == {"csrc/flash_tc.cuh", "csrc/flash_tile.cuh",
                      "csrc/paged_decode.cu", "csrc/tc_gemm.cuh",
                      "csrc/tc_gemm_s8.cuh", "csrc/dbb_gemm_skinny.cu",
                      "csrc/split_k_s8.cuh", "csrc/skinny_float.cuh",
                      "csrc/conv_tc.cuh", "csrc/conv_gemm.cu"}


def test_static_smem_parses_ptxas_logs(tmp_path):
    (tmp_path / "libpaged_decode-0123456789ab.log").write_text(
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_125paged_decode_split_kernelIfEEvT_' for "
        "'sm_90a'\nptxas info    : Used 64 registers, 16 bytes smem, 400 "
        "bytes cmem[0]\n")
    table = smem.static_smem(tmp_path)
    assert list(table.values()) == [16]
    c = smem.contracts()
    dec = [x for x in c if x.kernel == "paged_decode"]
    static, missing = smem.with_static(dec, table)
    assert set(static.values()) == {16} and not missing
    _, missing = smem.with_static(c[:1], table)
    assert [v.code for v in missing] == ["no-entry"]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_in_process(repo_report, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(lint, "run", lambda contracts_module=None,
                        device="cuda": dict(repo_report, device=device))
    out = tmp_path / "r.json"
    assert lint.main(["--device", "cpu", "--json", str(out)]) == 0
    text = capsys.readouterr().out
    assert "skipped, needs a card" in text and "clean" in text
    assert json.loads(out.read_text())["ok"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="runs without a card")
def test_cli_refuses_without_a_card_or_device_cpu(capsys):
    assert lint.main(["--quiet"]) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_cli_exit_code_and_json(tmp_path):
    out = tmp_path / "report.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC_ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", "--quiet",
         "--device", "cpu", "--contracts",
         str(FIXTURES / "torch_bad_smem.py"), "--json", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr
    report = json.loads(out.read_text())
    assert _codes(report, "smem") == {"smem-overflow", "dead-headroom"}
