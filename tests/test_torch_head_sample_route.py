"""The fused sampling head on the skinny float body, on the CPU.

csrc/head_sample_fused.cu runs the persistent float body of
csrc/skinny_float.cuh (the greedy head's, sta_gemm_skinny.cu) with a
sampling epilogue: each block walks the 64-column tiles blockIdx.x,
+ gridDim.x, ..., reduces each tile's scores per row (two 32-column warp
halves) by ``beats`` (the larger score, then the lower index), folds them
into a running best per (row, half) across its tiles, and leaves one
(score, index) partial per row; a second launch merges a row's partials by
``beats``. Here, with inputs from numpy seeds:

* the partial count (the body's grid: ``cluster_q`` and ``blocks``) is
  parsed out of skinny_float.cuh and translated to Python: it reads K and N
  only (never M), and the wrapper's mirror ``sample.ops.partials`` agrees
  with it; the launcher sizes the merge by the same rule, and
  head_sample_fused.cu has no GEMV loop of its own (its logits are
  sta_gemm_skinny's body's);
* ``beats`` is parsed out of head_sample_fused.cu; a torch model of the
  kernel's order (the logits summed in the body's K order: 16 strands of
  8-row K groups, each one fused multiply-add chain, added in strand order;
  the penalties, 1/T and Gumbel noise of the port's plain sampler; 64-column
  tiles, the persistent walk, the per-(row, half) running best, the
  ordered merge) is held against ``head_sample_fused_pallas`` in interpret
  mode at M 1, 8, 9, 24 and 32, with temperature-0 and penalised rows,
  and with ties planted across tiles, across blocks and within one block's
  two tiles (N large enough that a block walks two tiles).

Tolerances: scores within rtol 1e-5 and atol 1e-5·max(|score|, 1) of the
Pallas kernel's (the two sum the GEMV in different orders; log may differ
by an ulp); indices equal on every row whose top-2 score margin exceeds
twice that; the model's index equal to the plain sampler's
(``sample_argmax``: the first maximum) on the model's own scores bit for
bit, and on planted ties equal to the Pallas kernel's exactly.

tests/test_torch_gpu.py holds the kernel itself against its plain version
and the greedy head on the card.
"""
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sample import kernel as jkernel
from repro_torch.kernels.sample import ops as tops
from repro_torch.kernels.sample import ref as tref

torch.set_num_threads(1)
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
BODY = (CSRC / "skinny_float.cuh").read_text()
HEAD = (CSRC / "head_sample_fused.cu").read_text()
INT_MAX = 2 ** 31 - 1
RTOL = 1e-5


def _consts() -> dict:
    """The ``constexpr int`` constants of split_k.cuh (kSMs) and
    skinny_float.cuh, each evaluated in the scope of those before it."""
    scope = {}
    for text in ((CSRC / "split_k.cuh").read_text(), BODY):
        for m in re.finditer(r"^constexpr int (\w+) = ([^;]+);", text, re.M):
            scope[m.group(1)] = eval(_c_expr(m.group(2)), {}, dict(scope))
    return scope


def _c_expr(e: str) -> str:
    """A C integer expression as Python: ``sk::`` dropped, && / ||, / as
    floor division (every operand here is non-negative) and one ?:."""
    e = re.sub(r"\s+", " ", e.replace("sk::", "")).strip()
    e = e.replace("&&", " and ").replace("||", " or ")
    e = re.sub(r"(?<![<>=!/])/(?![/=])", "//", e)
    m = re.fullmatch(r"(.+?)\?(.+):(.+)", e)
    if m:
        e = f"(({m.group(2)}) if ({m.group(1)}) else ({m.group(3)}))"
    return e


def _c_function(text: str, name: str, scope: dict):
    """``inline int name(int a, ...) { ... }``: its parameter names and a
    Python function of its statements (declarations, assignments, one
    ``while (cond) stmt;``, return)."""
    m = re.search(rf"inline int {name}\(([^)]*)\)\s*\{{(.*?)\n\}}", text,
                  re.S)
    assert m, f"no {name}"
    params = [p.split()[-1] for p in m.group(1).split(",")]
    lines = [f"def {name}({', '.join(params)}):"]
    for stmt in m.group(2).split(";"):
        stmt = re.sub(r"\s+", " ", stmt).strip()
        if not stmt:
            continue
        stmt = re.sub(r"^(const )?int ", "", stmt)
        loop = re.fullmatch(r"while \((.*)\) (\w+) \*= (\d+)", stmt)
        if loop:
            lines.append(f"    while {_c_expr(loop.group(1))}: "
                         f"{loop.group(2)} *= {loop.group(3)}")
        elif stmt.startswith("return "):
            lines.append(f"    return {_c_expr(stmt[7:])}")
        else:
            lhs, rhs = stmt.split("=", 1)
            lines.append(f"    {lhs.strip()} = {_c_expr(rhs)}")
    env = dict(scope)
    exec("\n".join(lines), env)
    return params, env[name]


def _c_blocks():
    scope = _consts()
    _, cluster_q = _c_function(BODY, "cluster_q", scope)
    scope["cluster_q"] = cluster_q
    params, blocks = _c_function(BODY, "blocks", scope)
    return params, blocks


def _c_beats():
    """head_sample_fused.cu's ``beats(s, i, bs, bi)`` as Python."""
    m = re.search(r"bool beats\(([^)]*)\)\s*\{\s*return (.*?);\s*\}", HEAD,
                  re.S)
    assert m, "no beats in head_sample_fused.cu"
    params = [p.split()[-1] for p in m.group(1).split(",")]
    assert params == ["s", "i", "bs", "bi"]
    code = compile(_c_expr(m.group(2)), "beats", "eval")
    return lambda s, i, bs, bi: bool(eval(code, {}, dict(s=s, i=i, bs=bs,
                                                         bi=bi)))


# ---------------------------------------------------------------------------
# the partial count and the shared body, from the sources
# ---------------------------------------------------------------------------

KS = (128, 256, 384, 1024, 2048, 4096, 8192)
NS = (128, 256, 384, 1024, 1920, 4096, 4224, 4352, 8448, 8960, 50304)


def test_partials_mirror_the_body():
    params, blocks = _c_blocks()
    assert params == ["K", "N"]
    for k in KS:
        for n in NS + (64, 100, 1000, 4099):
            assert tops.partials(k, n) == blocks(k, n), (k, n)
    # the olmo-1b head: one block a SM, no cluster
    assert blocks(2048, 50304) == 132


def test_partials_never_read_m():
    """A row's sampled token must not depend on the batch around it: the
    grid (and with it the workspace and the merge) is a function of K and N
    alone, in C and in Python."""
    assert list(inspect.signature(tops.partials).parameters) == ["k_dim",
                                                                 "n"]
    params, _ = _c_blocks()
    assert "M" not in params
    for name in ("cluster_q", "blocks"):
        m = re.search(rf"inline int {name}\(([^)]*)\)", BODY)
        assert "M" not in [p.split()[-1] for p in m.group(1).split(",")]


def test_the_launcher_sizes_the_merge_by_the_rule():
    assert re.search(r"head_sample_fused_partials\(int K, int N\)\s*\{\s*"
                     r"return skf::blocks\(K, N\);\s*\}", HEAD)
    assert "skf::blocks(K, N)" in HEAD.split(
        "extern \"C\" int head_sample_fused_launch")[1]
    assert "head_sample_fused_partials" in inspect.getsource(tops._partials)


def test_both_heads_run_one_body():
    """head_sample_fused.cu and sta_gemm_skinny.cu launch the float body of
    skinny_float.cuh; the sampling head has no GEMV loop of its own, and
    the old row-chunk header is gone."""
    sta = (CSRC / "sta_gemm_skinny.cu").read_text()
    for text in (HEAD, sta):
        assert '#include "skinny_float.cuh"' in text
        assert "skf::launch_float<" in text
    assert "fmaf" not in HEAD and "for (int k" not in HEAD
    assert not (CSRC / "skinny_tile.cuh").exists()
    assert "fmaf(xv[p], wv[p][c], acc[i][c])" in BODY


def test_beats_is_larger_score_then_lower_index():
    beats = _c_beats()
    assert beats(2.0, 9, 1.0, 0)
    assert not beats(1.0, 0, 2.0, 9)
    assert beats(1.0, 3, 1.0, 4) and not beats(1.0, 4, 1.0, 3)
    assert not beats(1.0, 3, 1.0, 3)
    assert beats(float("-inf"), 7, float("-inf"), INT_MAX)
    assert not beats(float("nan"), 0, float("-inf"), INT_MAX)


# ---------------------------------------------------------------------------
# a torch model of the kernel's order, against the Pallas kernel
# ---------------------------------------------------------------------------

def _strand_logits(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the body's K order: strand v is one multiply-add chain over
    the 8-row groups v, v + 16, ... (rows in order), each step rounded to
    f32 (the product is exact in f64: one f64 rounding, then f32), and the
    16 strands are added in order from 0."""
    c = _consts()
    strands, group = c["kStrands"], c["kGroupK"]
    k_dim = h.shape[1]
    hd, wd = h.double(), w.double()
    total = torch.zeros(h.shape[0], w.shape[1], dtype=torch.float32)
    for v in range(strands):
        acc = torch.zeros_like(total)
        for g in range(v, k_dim // group, strands):
            for k in range(g * group, g * group + group):
                acc = (acc.double() + hd[:, k:k + 1] * wd[k]).float()
        total = total + acc
    return total


def _model(h, w, counts, temp, rep, pres, freq, seed, step, base):
    """(score [M], index [M]) in the kernel's order: the scores of every
    column, each 64-column tile's two 32-column halves reduced by `beats`,
    folded into a block's running best per (row, half) over the tiles it
    walks, the halves merged, the blocks' partials merged by `beats`. (A
    half's warp reduction is its largest score at the lowest index holding
    it: `beats` is a strict total order on NaN-free scores, so any
    reduction order gives that.)"""
    beats = _c_beats()
    c = _consts()
    cols = c["kCols"]
    m, k_dim = h.shape
    n = w.shape[1]
    logits = _strand_logits(h, w)
    scores = tref.sample_scores(
        logits, counts, temp[:, None], rep[:, None], pres[:, None],
        freq[:, None], seed[:, None], step[:, None],
        base + torch.arange(n)[None, :])
    blocks = tops.partials(k_dim, n)
    tiles = -(-n // cols)
    assert not bool(scores.isnan().any())
    halves = []  # [tile][half]: per row (score, index) of the half
    for tile in range(tiles):
        for half in range(2):
            lo = tile * cols + half * 32
            hs, hi = scores[:, lo:min(lo + 32, n)].max(dim=-1)
            halves.append(list(zip(hs.tolist(), (hi + lo).tolist())))
    out_s, out_i = [], []
    for r in range(m):
        parts = []
        for b in range(blocks):
            best = [(float("-inf"), INT_MAX)] * 2
            for tile in range(b, tiles, blocks):
                for half in range(2):
                    ws, wi = halves[2 * tile + half][r]
                    if beats(ws, wi, *best[half]):
                        best[half] = (ws, wi)
            s, i = best[0]
            if beats(*best[1], s, i):
                s, i = best[1]
            parts.append((s, i))
        s, i = float("-inf"), INT_MAX
        for ps, pi in parts:
            if beats(ps, pi, s, i):
                s, i = ps, pi
        out_s.append(s)
        out_i.append(i)
    return (torch.tensor(out_s, dtype=torch.float32),
            torch.tensor(out_i, dtype=torch.int32), scores)


def _pallas(h, w, counts, temp, rep, pres, freq, seed, step, base):
    m = h.shape[0]
    mp = -(-m // 8) * 8
    pad = mp - m

    def col(a, fill, dt):
        return jnp.asarray(np.pad(np.asarray(a, dt), (0, pad),
                                  constant_values=fill).reshape(mp, 1))
    s, i = jkernel.head_sample_fused_pallas(
        jnp.asarray(np.pad(h, ((0, pad), (0, 0)))), jnp.asarray(w),
        jnp.asarray(np.pad(counts, ((0, pad), (0, 0)))),
        col(temp, 0, np.float32), col(rep, 1, np.float32),
        col(pres, 0, np.float32), col(freq, 0, np.float32),
        col(seed, 0, np.int32), col(step, 0, np.int32),
        jnp.asarray(np.full((mp, 1), base, np.int32)), interpret=True)
    return np.asarray(s)[:m, 0], np.asarray(i)[:m, 0]


def _inputs(m, k, n, seed):
    """Hidden rows scaled so logits are O(1) and the noise decides tokens;
    counts with zero rows; every 4th row at temperature 0, every 2nd with a
    repetition penalty, presence and frequency penalties on others."""
    r = np.random.default_rng(seed)
    h = (r.standard_normal((m, k)) / k ** 0.5).astype(np.float32)
    w = r.standard_normal((k, n)).astype(np.float32)
    counts = r.integers(0, 3, (m, n)).astype(np.int32)
    counts[::3] = 0
    rows = np.arange(m)
    temp = np.where(rows % 4 == 0, 0.0, 0.5 + 0.1 * (rows % 7)
                    ).astype(np.float32)
    rep = np.where(rows % 2 == 0, 1.0, 1.3).astype(np.float32)
    pres = np.where(rows % 3 == 1, 0.4, 0.0).astype(np.float32)
    freq = np.where(rows % 5 == 2, 0.2, 0.0).astype(np.float32)
    seed_ = (rows * 7919 - 3).astype(np.int32)
    step = (rows * 3).astype(np.int32)
    return h, w, counts, temp, rep, pres, freq, seed_, step


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("m,k,n,base", [(1, 256, 1024, 0),
                                        (8, 256, 8960, 0),
                                        (9, 128, 1024, 300),
                                        (24, 256, 1920, 0),
                                        (32, 128, 8960, 7)])
def test_model_of_the_kernel_matches_pallas(m, k, n, base):
    args = _inputs(m, k, n, 100 + m + n)
    ws, wi = _pallas(*args, base)
    gs, gi, scores = _model(*(_t(a) for a in args), base)
    scale = max(float(np.abs(ws).max()), 1.0)
    np.testing.assert_allclose(gs.numpy(), ws, rtol=RTOL, atol=RTOL * scale)
    top2 = scores.topk(2, dim=-1).values
    decided = ((top2[:, 0] - top2[:, 1]) > 2 * RTOL * scale).numpy()
    assert decided.sum() >= m - 1
    np.testing.assert_array_equal(gi.numpy()[decided], wi[decided])
    # the order's result is the first maximum of its own scores, exactly
    want_s, want_i = tref.sample_argmax(
        _strand_logits(_t(args[0]), _t(args[1])), *(_t(a) for a in args[2:]),
        base=base)
    assert torch.equal(gi, want_i.to(torch.int32))
    assert torch.equal(gs, want_s)


def test_ties_across_tiles_and_blocks_take_the_lowest_index():
    """N 8960 at K 128: 140 tiles over 132 blocks, so blocks 0-7 walk two
    tiles each. Equal columns planted in block 0's first and second tiles,
    in block 5's tiles (one in each half) and in block 9's only tile win
    every row at temperature 0 (and with penalties that leave them tied);
    dropping the winner moves the win to the next-lowest, through tiles and
    blocks, as in the Pallas kernel."""
    m, k, n = 8, 128, 8960
    assert tops.partials(k, n) == 132
    r = np.random.default_rng(4)
    h = (r.random((m, k)) + 0.5).astype(np.float32)
    w = -r.random((k, n)).astype(np.float32)
    top = r.random(k).astype(np.float32)
    tied = [5, 64 * 5 + 40, 64 * 9 + 2, 64 * 132 + 3, 64 * 137 + 1]
    for col in tied:
        w[:, col] = top
    z = np.zeros(m, np.float32)
    zi = np.zeros(m, np.int32)
    counts = np.zeros((m, n), np.int32)
    counts[:, tied] = 2
    rep = np.full(m, 1.5, np.float32)
    pres = np.full(m, 0.25, np.float32)
    args = (h, w, counts, z, rep, pres, z, zi, zi)
    _, wi = _pallas(*args, 0)
    _, gi, _ = _model(*(_t(a) for a in args), 0)
    assert wi.tolist() == gi.tolist() == [5] * m
    fresh = np.zeros_like(counts)
    for drop, want in ((5, 360), (360, 578), (578, 8451), (8451, 8769)):
        w[:, drop] = -1.0
        args = (h, w, fresh, z, z + 1, z, z, zi, zi)
        _, wi = _pallas(*args, 0)
        _, gi, _ = _model(*(_t(a) for a in args), 0)
        assert wi.tolist() == gi.tolist() == [want] * m, drop
