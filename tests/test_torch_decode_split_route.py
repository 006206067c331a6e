"""The split-and-combine design of the paged decode kernel, on the CPU.

csrc/paged_decode.cu splits each row's live KV pages across blocks: a row's
live logical pages j0 .. j1 (those holding a valid key) are cut into splits
of ``split_pages(page)`` pages from j0 (``row_splits``); each split block
walks its pages in chunks of up to 64 keys with an online softmax and
leaves (m, l, acc) in f32; a second launch merges a row's splits in
ascending order. Here, with inputs from numpy seeds:

* the split rule, the workspace's split count and the guards are parsed
  out of paged_decode.cu and translated to Python: the split rule reads no
  B, n_log, Hkv or table (a row's bits must not depend on the batch or
  the cache layout), the wrapper's mirrors (``split_pages``,
  ``decode_splits``, ``paged_decode_ok``, ``PAGE_MIN``) agree with it;
* a torch model of the kernel's arithmetic (written here: the parsed split
  rule, 64-key chunks, the per-chunk online update with P rounded to V's
  dtype, the ordered merge) is held against the Pallas kernel
  (``paged_decode_pallas``) in interpret mode at G 1 / 2 / 4, with a
  window, a softcap, shuffled tables, pages of 8 to 128 slots, splits that
  do not divide a row's live pages and chunks that hold only masked keys.
  Tolerance: f32, rtol = atol = 1e-5 (the two sum in different orders), as
  tests/test_torch_kernels.py holds the plain version;
* merging a split that holds only masked keys (m = -1e30, l = 0) changes
  no bit, and no merge makes NaN or inf.

tests/test_torch_gpu.py holds the kernel itself against its plain version
on the card.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attn.ops import paged_decode_attention as jpaged
from repro_torch.kernels.attn import identity_block_table
from repro_torch.kernels.attn.ops import (PAGE_MIN, SMEM_LIMIT,
                                          _decode_smem_bytes, decode_splits,
                                          paged_decode_ok, split_pages)

torch.set_num_threads(1)
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
SRC = (CSRC / "paged_decode.cu").read_text()
TOL = dict(rtol=1e-5, atol=1e-5)
NEG_INF, L_EPS = -1e30, 1e-30


def _consts():
    """The ``constexpr int kName = value;`` constants of the source, with
    kWarps = kThreads / 32."""
    c = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", SRC)}
    c["kWarps"] = c["kThreads"] // 32
    # the shared-memory limit the launcher's guard reads (common.cuh)
    c["kSmemLimit"] = int(re.search(
        r"constexpr int kSmemLimit = (\d+);",
        (CSRC / "common.cuh").read_text()).group(1))
    return c


def _c_expr(e: str) -> str:
    """A C integer expression as Python: && || ! and one level of ?:
    (every operand here is non-negative, so / is floor division)."""
    e = e.replace("&&", " and ").replace("||", " or ")
    e = re.sub(r"(?<![<>=!])/(?!/)", "//", e)
    m = re.fullmatch(r"(.+?)\?(.+):(.+)", e.strip())
    if m:
        e = f"(({m.group(2)}) if ({m.group(1)}) else ({m.group(3)}))"
    return e


def _c_function(name: str):
    """``name`` as defined in paged_decode.cu: its parameter names, its
    body's text and a Python function of the same straight-line statements
    (declarations, assignments through pointers, one-line ifs, return),
    which returns the return value or the pointer outputs as a dict."""
    m = re.search(rf"\b{name}\(([^)]*)\)\s*\{{(.*?)\n\}}", SRC, re.S)
    assert m, f"no {name} in paged_decode.cu"
    params = [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]
    body = m.group(2)
    outs = [p.split()[-1].lstrip("*") for p in m.group(1).split(",")
            if "*" in p]
    lines = [f"def {name}({', '.join(p for p in params if p not in outs)}):"]
    for stmt in re.sub(r"\s+", " ", body).split(";"):
        stmt = stmt.strip()
        if not stmt:
            continue
        stmt = re.sub(r"^(const )?int ", "", stmt)
        stmt = re.sub(r"(?<![\w)])\*(\w)", r"\1", stmt)  # *j0 = ... -> j0
        cond = re.match(r"if \((.*)\) (\w+) = (.*)$", stmt)
        if cond:
            lines.append(f"    if {_c_expr(cond.group(1))}: "
                         f"{cond.group(2)} = {_c_expr(cond.group(3))}")
        elif stmt.startswith("return "):
            lines.append(f"    return {_c_expr(stmt[7:])}")
        else:
            lhs, rhs = stmt.split("=", 1)
            lines.append(f"    {lhs.strip()} = {_c_expr(rhs)}")
    if outs:
        fields = ", ".join(f"{o}={o}" for o in outs)
        lines.append(f"    return dict({fields})")
    scope = dict(_consts())
    for dep in ("split_pages",):
        if dep != name and re.search(rf"\b{dep}\(", body):
            scope[dep] = _c_function(dep)[2]
    exec("\n".join(lines), scope)
    return params, body, scope[name]


def _c_guard():
    """The launcher's refusal condition as a Python function of (page, D,
    G, esz)."""
    m = re.search(r"if \((page < kPageMin.*?)\)\s*return \(int\)"
                  r"cudaErrorInvalidValue", SRC, re.S)
    assert m, "no guard in paged_decode_launch"
    expr = _c_expr(re.sub(r"\s+", " ", m.group(1)))
    expr = expr.replace("smem_bytes(G, D, esz)", "smem(G, D, esz)")
    scope = dict(_consts(), smem=_c_function("smem_bytes")[2])
    return lambda **kw: bool(eval(expr, scope, kw))


# ---------------------------------------------------------------------------
# the rules, parsed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["split_pages", "row_splits"])
def test_split_rule_reads_no_batch_layout_or_table(name):
    """The split boundaries are a function of the row's start, length and
    window and of the page size: neither rule names B, n_log, Hkv, the
    table or a physical page."""
    params, body, _ = _c_function(name)
    words = set(re.findall(r"[A-Za-z_]\w*", " ".join(params) + body))
    assert not words & {"B", "n_log", "Hkv", "table", "tab", "block_table",
                        "phys", "k_pages", "v_pages"}, words
    assert set(params) <= {"start", "length", "window", "page", "j0", "j1",
                           "n"}


def test_split_pages_and_workspace_mirror_the_source():
    """``split_pages`` and ``decode_splits`` (the workspace's NS) equal the
    source's split_pages and max_splits; every row of a table n_log pages
    wide has at most NS splits, and a row's splits cover its live pages
    exactly once."""
    c_pages = _c_function("split_pages")[2]
    c_max = _c_function("max_splits")[2]
    c_row = _c_function("row_splits")[2]
    r = np.random.default_rng(0)
    for page in (8, 12, 16, 24, 32, 48, 64, 96, 128, 256):
        assert split_pages(page) == c_pages(page)
        for n_log in (1, 2, 3, 7, 10, 64):
            ns_max = decode_splits(n_log, page)
            assert ns_max == c_max(n_log, page)
            s = n_log * page
            for _ in range(40):
                length = int(r.integers(0, s))
                start = int(r.integers(0, length + 2))
                window = int(r.choice([0, 1, 5, page, 3 * page]))
                got = c_row(start, length, window, page)
                assert got["n"] <= ns_max
                lo = max(start, length - window + 1 if window else 0)
                live = [j for j in range(n_log) if any(
                    lo <= k <= length
                    for k in range(j * page, (j + 1) * page))]
                cover = [j for i in range(got["n"])
                         for j in range(got["j0"] + i * split_pages(page),
                                        min(got["j0"] + (i + 1)
                                            * split_pages(page),
                                            got["j1"] + 1))]
                assert cover == live, (start, length, window, page)


def test_guard_mirrors_the_launcher():
    """``paged_decode_ok`` for each dtype equals the launcher's refusal
    condition negated, its shared-memory formula the source's, and
    ``PAGE_MIN`` is its kPageMin; with no dtype the guard takes the shape
    only where both dtypes' kernels do."""
    c = _consts()
    assert PAGE_MIN == c["kPageMin"]
    c_smem = _c_function("smem_bytes")[2]
    for g in (1, 2, 4, 32, 64):
        for d in (8, 64, 128, 256):
            for esz in (2, 4):
                assert _decode_smem_bytes(g, d, esz) == c_smem(g, d, esz)
    guard = _c_guard()
    for g in (1, 2, 4, 8, 16, 32, 48, 64):
        for d in (1, 4, 8, 32, 64, 72, 100, 128, 136, 256, 264):
            for page in (1, 7, 8, 16, 64, 256):
                both = True
                for dt, esz in ((torch.float32, 4), (torch.bfloat16, 2)):
                    ok = paged_decode_ok(g, page, d, dt)
                    assert ok == (not guard(page=page, D=d, G=g, esz=esz)), (
                        g, d, page, dt)
                    both = both and ok
                assert paged_decode_ok(g, page, d) == both
    # the serving path's shapes and the card tests' largest one fit
    assert paged_decode_ok(1, 64, 128) and paged_decode_ok(32, 256, 128)
    assert c["kChunk"] == 64 and SMEM_LIMIT == c["kSmemLimit"] == 232448


# ---------------------------------------------------------------------------
# the combine's math: a torch model of the kernel against the Pallas kernel
# ---------------------------------------------------------------------------

def _split_state(q, kp, vp, tab, length, st, window, page, sm_scale,
                 softcap, pages, chunk):
    """One split block of (row, KV head): q [G, D]; the split's logical
    pages; returns (m [G], l [G], acc [G, D]) in f32 as the kernel leaves
    them."""
    g_n, d = q.shape
    m = torch.full((g_n,), NEG_INF)
    l = torch.zeros(g_n)
    acc = torch.zeros(g_n, d)
    lo = max(st, length - window + 1 if window > 0 else 0)
    slots = [j * page + o for j in pages for o in range(page)]
    for c0 in range(0, len(slots), chunk):
        keys = slots[c0:c0 + chunk]
        if not any(lo <= k <= length for k in keys):
            continue                        # a chunk with no valid key
        kk = torch.stack([kp[tab[k // page], k % page] for k in keys])
        vv = torch.stack([vp[tab[k // page], k % page] for k in keys])
        s = (q.float() @ kk.float().T) * sm_scale
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        valid = torch.tensor([lo <= k <= length for k in keys])
        s = torch.where(valid[None, :], s, torch.full_like(s, NEG_INF))
        m_cur = torch.maximum(m, s.max(dim=1).values)
        p = torch.exp(s - m_cur[:, None])
        alpha = torch.exp(m - m_cur)
        l = l * alpha + p.sum(dim=1)
        acc = acc * alpha[:, None] + p.to(vv.dtype).float() @ vv.float()
        m = m_cur
    return m, l, acc


def _merge(states):
    """The combine launch: the splits merged in the given (ascending)
    order, then acc / max(l, 1e-30)."""
    g_n, d = states[0][2].shape if states else (0, 0)
    m = torch.full((g_n,), NEG_INF)
    l = torch.zeros(g_n)
    acc = torch.zeros(g_n, d)
    for ms, ls, accs in states:
        mn = torch.maximum(m, ms)
        ea, eb = torch.exp(m - mn), torch.exp(ms - mn)
        l = l * ea + ls * eb
        acc = acc * ea[:, None] + accs * eb[:, None]
        m = mn
    return acc / torch.clamp(l, min=L_EPS)[:, None]


def _model(q, kp, vp, table, lengths, start, *, window, softcap,
           whole_table=False):
    """The kernel's arithmetic, row by row: the parsed split rule, each
    split's state, the ordered merge. ``whole_table`` also cuts the pages
    before the row's first live page and after its last into splits, which
    hold only masked keys, and merges them in their places."""
    row_splits = _c_function("row_splits")[2]
    chunk = _consts()["kChunk"]
    b_n, hkv, g_n, d = q.shape
    page, n_log = kp.shape[1], table.shape[1]
    sm_scale = 1.0 / math.sqrt(d)
    per = split_pages(page)
    out = torch.zeros(b_n, hkv, g_n, d)
    for b in range(b_n):
        length, st = int(lengths[b]), int(start[b])
        rs = row_splits(st, length, window, page)
        j0, j1 = rs["j0"], rs["j1"]
        splits = [range(j0 + i * per, min(j0 + (i + 1) * per, j1 + 1))
                  for i in range(rs["n"])]
        if whole_table:
            splits = ([range(j, min(j + per, j0)) for j in range(0, j0, per)]
                      + splits
                      + [range(j, min(j + per, n_log))
                         for j in range(j1 + 1, n_log, per)])
        tab = table[b].tolist()
        for h in range(hkv):
            states = [_split_state(q[b, h], kp[:, :, h], vp[:, :, h], tab,
                                   length, st, window, page, sm_scale,
                                   softcap, pages, chunk)
                      for pages in splits]
            out[b, h] = _merge(states)
    return out.to(q.dtype)


def _operands(b, hkv, g, d, s, page, seed, shuffle):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, hkv, g, d)).astype(np.float32)
    kc = r.standard_normal((b, s, hkv, d)).astype(np.float32)
    vc = r.standard_normal((b, s, hkv, d)).astype(np.float32)
    n_log = s // page
    kp = kc.reshape(b * n_log, page, hkv, d)
    vp = vc.reshape(b * n_log, page, hkv, d)
    table = np.asarray(identity_block_table(b, n_log, "cpu"))
    if shuffle:          # a true page pool: physical pages in random order
        perm = r.permutation(b * n_log)
        kp, vp = kp[np.argsort(perm)], vp[np.argsort(perm)]
        table = perm[table].astype(np.int32)
    lengths = r.integers(s // 3, s, b).astype(np.int32)
    start = np.minimum(r.integers(0, s // 2, b), lengths).astype(np.int32)
    # ragged edges: a row whose left padding fills whole splits, one that
    # starts and ends inside a single page
    start[0] = min(int(lengths[0]), 2 * page + 3)
    lengths[-1], start[-1] = page + page // 2, page + 1
    return q, kp, vp, table, lengths, start


@pytest.mark.parametrize("g,page,s,window,softcap,shuffle", [
    (1, 64, 256, 0, 0.0, False),      # the serving path: 1-page splits
    (2, 16, 160, 0, 0.0, True),       # 4-page splits; 10 pages: ragged
    (4, 8, 120, 0, 30.0, True),       # 8-page splits; softcap
    (1, 128, 384, 0, 0.0, True),      # 2 chunks a page, some all masked
    (2, 24, 240, 37, 0.0, False),     # 2-page splits of 48 keys; window
    (1, 64, 320, 70, 20.0, True),     # window over a page; softcap
])
def test_split_combine_model_matches_pallas(g, page, s, window, softcap,
                                            shuffle):
    args = _operands(4, 2, g, 32, s, page, seed=page + g + window,
                     shuffle=shuffle)
    want = jpaged(*map(jnp.asarray, args), window=window, softcap=softcap,
                  use_kernel=True)
    t = [torch.from_numpy(a) for a in args]
    got = _model(*t, window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the splits of the whole table, leading and trailing ones holding only
    # masked keys, merge to the same bits
    assert torch.equal(got, _model(*t, window=window, softcap=softcap,
                                   whole_table=True))


def test_masked_split_merges_to_nothing():
    """A split with only masked keys leaves m = -1e30, l = 0, acc = 0;
    merging it first, between or last changes no bit, and a row with no
    valid key gives zeros, never NaN or inf."""
    r = np.random.default_rng(5)
    states = []
    for _ in range(3):
        m = torch.from_numpy(r.standard_normal(4).astype(np.float32) * 30)
        l = torch.from_numpy(r.random(4).astype(np.float32) * 10 + 1)
        acc = torch.from_numpy(r.standard_normal((4, 16)).astype(np.float32))
        states.append((m, l, acc))
    empty = (torch.full((4,), NEG_INF), torch.zeros(4), torch.zeros(4, 16))
    want = _merge(states)
    for at in range(4):
        got = _merge(states[:at] + [empty] + states[at:])
        assert torch.equal(got, want)
    nothing = _merge([empty, empty])
    assert torch.equal(nothing, torch.zeros(4, 16))
    assert torch.isfinite(_merge([])).all()
    # a chunk whose keys are all masked never reaches the online update
    q = torch.ones(1, 8)
    kp = torch.ones(4, 8, 1, 8)
    m, l, acc = _split_state(q, kp[:, :, 0], kp[:, :, 0], [0, 1, 2, 3],
                             length=10, st=9, window=0, page=8,
                             sm_scale=1.0, softcap=0.0, pages=[0], chunk=64)
    assert torch.equal(m, torch.tensor([NEG_INF]))
    assert l.item() == 0 and not acc.any()
