"""The skinny int8 body of dbb_gemm_skinny and sta_gemm_skinny, on the CPU.

csrc/split_k_s8.cuh runs every int8 call of the two skinny kernels
(INT8 × INT8 → INT32 at M <= 32): a block owns 64 output columns, all rows
of the batch and one of S = splits(K, N) slices of K; a slice is whole
128-deep stages; each stage's weight becomes a K-major int8 W^T tile (the
dense w transposed, the INT8 DBB planes expanded by bitmask rank, slot
min(rank, nnz - 1), zero at a dropped position); 16 warps run the stage's
four k32 steps of mma.sync on 8-row tiles of x, zero past M, K and N; the
four steps' tiles and then the S slices' tiles are added, the epilogue
runs on the int32 sum. Here, with inputs from numpy seeds:

* the slice rule, the slices' stage bounds and the ring's depth are parsed
  out of split_k_s8.cuh (constants from split_k.cuh and tc_gemm_s8.cuh),
  and shown to read no M; for every K a multiple of 8 up to 16384 and
  five widths N, the slices cover [0, K) once, in order, within 8 slices
  and 2 blocks per SM; the shared memory fits the card, two blocks an SM
  at nnz <= 4;
* a torch model of the body's index map (written here: the parsed rule and
  bounds, 128-deep stages of 64-column W^T tiles zero-filled past K and N,
  the four k32 steps, the slices' sum) is held against the Pallas kernels
  (``sta_gemm_skinny_pallas``, ``dbb_gemm_skinny_pallas`` through the JAX
  ops, interpret mode) at M 1, 8, 13, 24 and 32, (K, N) = (264, 200), (512,
  640), (1184, 136) and (4096, 10), DBB nnz 4 (and 2 at (264, 200) and
  (4096, 10)), the dense branch at each (K 264: K % 16 == 8);
* the int32 sums bit for bit; at the two ragged shapes the int8
  requantized (relu, scale) output bit for bit; the f32 output (scale, bias, relu) bit for bit against the
  port's CPU route and within rtol 1e-6, atol 1e-7·max|want| against the
  Pallas kernel (XLA may contract the scale and bias into one FMA:
  tests/test_torch_int8.py's tolerance);
* all-127 operands at K 1184 give the exact integer 1184·127².

The Pallas kernel's rows are independent (one accumulator row each), so
one M32 call gives every M's rows. tests/test_torch_gpu.py holds the body
itself against the plain versions on the card.
"""
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dbb import pack_dbb as jpack
from repro.kernels.dbb_gemm.ops import dbb_gemm as jdbb_gemm
from repro.kernels.sta_gemm.ops import sta_gemm as jsta_gemm
from repro_torch.kernels.common import LAUNCHES, SMEM_LIMIT
from repro_torch.kernels.epilogue import Epilogue, apply_epilogue
from repro_torch.kernels.skinny import dbb_gemm_skinny, sta_gemm_skinny

torch.set_num_threads(1)
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
SRC = (CSRC / "split_k_s8.cuh").read_text()
MS = (1, 8, 13, 24, 32)
SHAPES = ((264, 200), (512, 640), (1184, 136), (4096, 10))
NS = (10, 136, 2048, 8192, 50304)
I8, I32, F32 = torch.int8, torch.int32, torch.float32


def _c_value(expr: str, scope: dict) -> int:
    """A constant C integer expression (non-negative: / is floor division;
    ``ns::`` qualifiers dropped) evaluated in ``scope``."""
    expr = re.sub(r"\w+::", "", expr)
    expr = re.sub(r"(?<![<>=!/])/(?!/)", "//", expr)
    return eval(expr, {}, scope)


@functools.lru_cache(maxsize=None)
def _consts() -> dict:
    """The ``constexpr int`` constants the body reads: common.cuh's
    kDbbBlock, split_k.cuh's kMaxSplit and kSMs, tc_gemm_s8.cuh's BK, BN,
    kBlocks and kMaskBytes (as tc8_...), then split_k_s8.cuh's own."""
    scope = {}
    for name, prefix in (("common.cuh", ""), ("split_k.cuh", ""),
                         ("tc_gemm_s8.cuh", "tc8_"), ("split_k_s8.cuh", "")):
        text = (CSRC / name).read_text()
        for m in re.finditer(r"^constexpr int ([^;]+);", text, re.M):
            for part in m.group(1).split(","):
                key, expr = (s.strip() for s in part.split("=", 1))
                expr = re.sub(r"tc8::(\w+)", r"tc8_\1", expr)
                if prefix:
                    expr = re.sub(r"\b(BK|BN|kBlocks|kDbbBlock)\b",
                                  lambda w: (prefix + w.group(1)
                                             if w.group(1) != "kDbbBlock"
                                             else w.group(1)), expr)
                scope[prefix + key] = _c_value(expr, scope)
    return scope


def _function(name: str):
    """``name(int a, ...)`` of split_k_s8.cuh: its parameter names and its
    body's statements."""
    m = re.search(rf"\b{name}\(([^)]*)\)\s*\{{(.*?)\n\}}", SRC, re.S)
    assert m, f"no {name} in split_k_s8.cuh"
    params = [p.split()[-1] for p in m.group(1).split(",")]
    return params, re.sub(r"\s+", " ", m.group(2)).strip()


def _py(expr: str) -> str:
    """A C expression of the rules as Python: && and ?: (one level)."""
    expr = re.sub(r"\w+::", "", expr.replace("&&", " and "))
    expr = re.sub(r"(?<![<>=!/])/(?!/)", "//", expr)
    m = re.fullmatch(r"(.+?)\?(.+):(.+)", expr.strip())
    if m:
        expr = f"(({m.group(2)}) if ({m.group(1)}) else ({m.group(3)}))"
    return expr


@functools.lru_cache(maxsize=None)
def _splits():
    """split_k_s8.cuh's ``splits(K, N)`` as a Python function: its
    declarations, the doubling loop and the return, translated."""
    params, body = _function("splits")
    lines = [f"def splits({', '.join(params)}):"]
    for stmt in body.split(";"):
        stmt = re.sub(r"^(const )?int ", "", stmt.strip())
        if not stmt:
            continue
        loop = re.fullmatch(r"while \((.*)\) (\w+) \*= 2", stmt)
        if loop:
            lines.append(f"    while {_py(loop.group(1))}: "
                         f"{loop.group(2)} *= 2")
        elif stmt.startswith("return "):
            lines.append(f"    return {_py(stmt[7:])}")
        else:
            lhs, rhs = stmt.split("=", 1)
            lines.append(f"    {lhs.strip()} = {_py(rhs)}")
    scope = dict(_consts())
    exec("\n".join(lines), scope)
    return params, scope["splits"]


def _kernel_line(name: str) -> str:
    """The right-hand side of ``const int <name> = ...;`` in the kernel."""
    m = re.search(rf"const int {name} = ([^;]+);", SRC)
    assert m, f"no {name} in the kernel"
    return _py(re.sub(r"\s+", " ", m.group(1)))


@functools.lru_cache(maxsize=None)
def _bounds():
    """The kernel's stage count of K, and its first stage and stage count
    of K slice ``slice``, as Python functions."""
    scope = dict(_consts())
    exec(f"def stages_of(K): return {_kernel_line('stages')}\n"
         f"def slice_of(slice, stages, S):\n"
         f"    st0 = {_kernel_line('st0')}\n"
         f"    return st0, {_kernel_line('n_st')}\n", scope)
    return scope["stages_of"], scope["slice_of"]


def _slice(slice_, stages, S):
    return _bounds()[1](slice_, stages, S)


def _stages(K: int) -> int:
    return _bounds()[0](K)


def _returns(name: str, **kw) -> int:
    """A one-line ``return expr;`` function of split_k_s8.cuh, evaluated
    (the functions it calls among raw_bytes / slot_bytes resolved)."""
    _, body = _function(name)
    expr = _py(re.fullmatch(r"return (.*);", body).group(1))
    scope = dict(_consts())
    scope["raw_bytes"] = lambda dbb, nnz: _returns("raw_bytes", dbb=dbb,
                                                   nnz=nnz)
    scope["slot_bytes"] = lambda dbb, nnz, mp: _returns(
        "slot_bytes", dbb=dbb, nnz=nnz, mp=mp)
    scope["kMaskBytes"] = scope["tc8_kMaskBytes"]
    return eval(expr.replace("tc8::", ""), scope, kw)


# ---------------------------------------------------------------------------
# the rules, parsed
# ---------------------------------------------------------------------------

def test_the_slice_rule_and_bounds_read_no_m():
    """S is a rule on K and N; a slice's stages on its index, the stage
    count and S: nothing of the K order depends on M."""
    params, _ = _splits()
    assert params == ["K", "N"]
    for name in ("stages", "st0", "n_st"):
        assert "M" not in re.findall(r"\w+", _kernel_line(name)), name


def test_the_stage_and_the_ring():
    """A stage is 128 K (16 DBB blocks, one 128-byte swizzle row of int8)
    in 64-column tiles, the producers' task grid of tc_gemm_s8.cuh; the
    ring keeps kStages - 2 >= 2 stages in flight; the shared memory fits
    a block at every nnz and M <= 32, two blocks an SM at nnz <= 4, and
    the ring holds the slices' partial tiles ([4, mp, 64] + [mp, 64]
    int32)."""
    c = _consts()
    assert (c["kStageK"], c["kCols"], c["kStageKb"]) == (128, 64, 16)
    assert (c["tc8_BK"], c["tc8_BN"]) == (c["kStageK"], c["kCols"])
    assert c["kThreads"] == 16 * 32 and c["kWorkers"] == 128
    assert c["kAhead"] == c["kStages"] - 2 >= 2
    for dbb in (False, True):
        for nnz in range(1, 9):
            for mp in (8, 16, 24, 32):
                smem = _returns("smem_bytes", dbb=dbb, nnz=nnz, mp=mp)
                assert smem <= SMEM_LIMIT, (dbb, nnz, mp, smem)
                if nnz <= 4:
                    assert 2 * (smem + 1024) <= 228 * 1024, (dbb, nnz, mp)
                ring = c["kStages"] * _returns("slot_bytes", dbb=dbb,
                                               nnz=nnz, mp=mp)
                assert ring >= 5 * mp * c["kCols"] * 4


def test_slices_cover_k_once():
    """For every K a multiple of 8 up to 16384 and N in NS: S is a power
    of two <= 8, the grid holds at most 2 blocks an SM where S > 1, each
    slice of S > 1 keeps two stages or more, and the slices' stages cover
    [0, K) once, in order."""
    _, splits = _splits()
    c = _consts()
    for n in NS:
        tiles = -(-n // c["kCols"])
        for k in range(0, 16385, 8):
            S = splits(k, n)
            assert S in (1, 2, 4, 8), (k, n, S)
            stages = _stages(k)
            assert stages * c["kStageK"] - c["kStageK"] < k or k == 0
            if S > 1:
                assert tiles * S <= 2 * c["kSMs"], (k, n, S)
            nxt = 0
            for s in range(S):
                st0, n_st = _slice(s, stages, S)
                assert st0 == nxt and n_st >= (2 if S > 1 else 0), (k, n, s)
                nxt = st0 + n_st
            assert nxt == stages, (k, n)


def test_olmo_shapes_fill_the_card():
    """The decode path's shapes: 256 blocks at (2048, 2048), (8192, 2048)
    and (2048, 8192); the classifier (K 4096, N 10) in 8 slices."""
    _, splits = _splits()
    assert [splits(k, n) for k, n in ((2048, 2048), (8192, 2048),
                                      (2048, 8192), (4096, 10))] == [8, 8,
                                                                     2, 8]


# ---------------------------------------------------------------------------
# the model of the body against the Pallas kernels
# ---------------------------------------------------------------------------

def _dense_tiles(w: torch.Tensor):
    """Stage st's W^T tile [64, 128] of column tile n0 for a dense w[K, N],
    zero past K and N."""
    k_dim, n = w.shape
    c = _consts()

    def tile(st, n0):
        k0 = st * c["kStageK"]
        kk, nn = min(c["kStageK"], k_dim - k0), min(c["kCols"], n - n0)
        out = torch.zeros((c["kCols"], c["kStageK"]), dtype=torch.int64)
        out[:nn, :kk] = w[k0:k0 + kk, n0:n0 + nn].T.long()
        return out
    return tile


def _dbb_tiles(values: torch.Tensor, bitmask: torch.Tensor, nnz: int):
    """Stage st's W^T tile [64, 128] of column tile n0 expanded from the
    INT8 planes as tc_gemm_s8.cuh's producers do: position p of block b is
    slot min(rank, nnz - 1) where bit p of the mask's low byte is set (rank
    the set bits below p), else zero; blocks past K / 8 and columns past N
    read as zero."""
    kb_total, n = bitmask.shape
    c = _consts()
    nb, cols = c["kStageKb"], c["kCols"]

    def tile(st, n0):
        kb0 = st * nb
        kk, nn = min(nb, kb_total - kb0), min(cols, n - n0)
        masks = torch.zeros((nb, cols), dtype=torch.int64)
        vals = torch.zeros((nb, nnz, cols), dtype=torch.int64)
        masks[:kk, :nn] = bitmask[kb0:kb0 + kk, n0:n0 + nn].long()
        vals[:kk, :, :nn] = values[kb0 * nnz:(kb0 + kk) * nnz,
                                   n0:n0 + nn].long().view(kk, nnz, nn)
        bits = (masks[..., None] >> torch.arange(8)) & 1     # [16, 64, 8]
        slot = (torch.cumsum(bits, -1) - bits).clamp(max=nnz - 1)
        w = torch.gather(vals.permute(0, 2, 1), -1, slot) * bits
        return w.permute(1, 0, 2).reshape(cols, nb * 8)
    return tile


def _body_sums(x: torch.Tensor, tile, k_dim: int, n: int) -> torch.Tensor:
    """The int32 sums of the body's index map: per 64-column tile, the S
    slices' stages of [mp, 128] x tiles (zero past M and K) times W^T, each
    stage in four k32 steps summed into four partial tiles, the steps'
    tiles added, then the slices' (wrapping mod 2^32, as the mma does)."""
    c = _consts()
    m = x.shape[0]
    mp = -(-m // 8) * 8
    sk, cols = c["kStageK"], c["kCols"]
    stages = _stages(k_dim)
    S = _splits()[1](k_dim, n)
    xs = torch.zeros((mp, max(stages, 1) * sk), dtype=torch.int64)
    xs[:m, :k_dim] = x.long()
    out = torch.zeros((m, n), dtype=torch.int64)
    for n0 in range(0, n, cols):
        meet = torch.zeros((mp, cols), dtype=torch.int64)
        for s in range(S):
            st0, n_st = _slice(s, stages, S)
            part4 = torch.zeros((4, mp, cols), dtype=torch.int64)
            for st in range(st0, st0 + n_st):
                wt, xt = tile(st, n0), xs[:, st * sk:(st + 1) * sk]
                for kq in range(4):
                    k32 = slice(32 * kq, 32 * kq + 32)
                    part4[kq] += xt[:, k32] @ wt[:, k32].T
            meet += part4.sum(0)
        nn = min(cols, n - n0)
        out[:, n0:n0 + nn] = meet[:m, :nn]
    return ((out + 2 ** 31) % 2 ** 32 - 2 ** 31).to(I32)


def _epilogue_rows(r, n):
    bias = (r.standard_normal(n) * 50).astype(np.float32)
    scale = ((r.random(n) + 0.5) * 2e-3).astype(np.float32)
    return bias, scale


# (label, act, out dtype, with scale, with bias)
EPILOGUES = (("i32", "none", None, False, False),
             ("i8", "relu", I8, True, False),
             ("f32", "relu", F32, True, True))
_JNP = {None: None, I8: jnp.int8, F32: jnp.float32}


@functools.lru_cache(maxsize=None)
def _case(kind: str, k_dim: int, n: int, nnz: int, fill: int = 0):
    """Seeded M32 operands of one shape (all ``fill`` where given): (x,
    weight operands as torch tensors, bias, scale, the JAX operands)."""
    r = np.random.default_rng(k_dim * 7 + n + nnz)
    if fill:
        x = np.full((32, k_dim), fill, np.int8)
        w = np.full((k_dim, n), fill, np.int8)
    else:
        x = r.integers(-127, 128, (32, k_dim)).astype(np.int8)
        w = r.integers(-127, 128, (k_dim, n)).astype(np.int8)
    bias, scale = _epilogue_rows(r, n)
    if kind == "dbb":
        p = jpack(jnp.asarray(w), 8, nnz)
        jops = (p.values, p.bitmask)
        ops = (np.asarray(p.values), np.asarray(p.bitmask).view(np.int32))
    else:
        jops, ops = (jnp.asarray(w),), (w,)
    return (torch.from_numpy(x), tuple(torch.from_numpy(np.array(o))
                                       for o in ops),
            torch.from_numpy(bias), torch.from_numpy(scale), (x, jops))


@functools.lru_cache(maxsize=None)
def _pallas(kind: str, k_dim: int, n: int, nnz: int, label: str,
            fill: int = 0) -> torch.Tensor:
    """The Pallas kernel's M32 output of one case on one epilogue."""
    _, _, bias, scale, (x, jops) = _case(kind, k_dim, n, nnz, fill)
    _, act, od, has_scale, has_bias = next(e for e in EPILOGUES
                                           if e[0] == label)
    b = jnp.asarray(bias.numpy()) if has_bias else None
    s = jnp.asarray(scale.numpy()) if has_scale else None
    if kind == "dbb":
        y = jdbb_gemm(jnp.asarray(x), *jops, b, s, act=act, nnz=nnz,
                      out_dtype=_JNP[od], skinny=True)
    else:
        y = jsta_gemm(jnp.asarray(x), *jops, b, s, act=act,
                      out_dtype=_JNP[od], skinny=True)
    return torch.from_numpy(np.array(y))


def _tiles(kind, ops, nnz):
    """The case's W^T tiles, each built once."""
    tile = _dbb_tiles(ops[0], ops[1], nnz) if kind == "dbb" else (
        _dense_tiles(ops[0]))
    return functools.lru_cache(maxsize=None)(tile)


def _port(kind, x, ops, nnz, bias, scale, act, od):
    """The port's CPU route of the same call (launches nothing)."""
    before = dict(LAUNCHES)
    if kind == "dbb":
        y = dbb_gemm_skinny(x, ops[0], ops[1], bias, scale, act=act, nnz=nnz,
                            out_dtype=od)
    else:
        y = sta_gemm_skinny(x, ops[0], bias, scale, act=act, out_dtype=od)
    assert LAUNCHES == before
    return y


# DBB at nnz 4 on every shape and nnz 2 (the classifier's k) at two; the
# dense branch on every shape (K 264: K % 16 == 8)
CASES = ([("dbb", k, n, 4) for k, n in SHAPES]
         + [("dbb", 264, 200, 2), ("dbb", 4096, 10, 2)]
         + [("dense", k, n, 1) for k, n in SHAPES])
# the epilogues at the ragged shapes: K 264 with N 200 (cp.async copies
# of 4 bytes) and K 4096 with N 10 (byte copies, 8 slices)
EPI_CASES = [("dbb", 264, 200, 4), ("dbb", 4096, 10, 2),
             ("dense", 264, 200, 1), ("dense", 4096, 10, 1)]


@pytest.mark.parametrize("kind,k,n,nnz", CASES)
def test_body_sums_equal_pallas_at_every_m(kind, k, n, nnz):
    """The model's int32 sums at M 1, 8, 13, 24 and 32 equal the Pallas
    kernel's rows bit for bit, and the port's CPU route's."""
    x, ops, _, _, _ = _case(kind, k, n, nnz)
    tile, want = _tiles(kind, ops, nnz), _pallas(kind, k, n, nnz, "i32")
    for m in MS:
        got = _body_sums(x[:m], tile, k, n)
        assert torch.equal(got, want[:m]), m
        assert torch.equal(got, _port(kind, x[:m], ops, nnz, None, None,
                                      "none", None)), m


@pytest.mark.parametrize("kind,k,n,nnz", EPI_CASES)
def test_body_epilogues_equal_pallas(kind, k, n, nnz):
    """The epilogue on the model's sums at M 13 and 32: int8 requantized
    (relu, scale) bit for bit against the Pallas kernel and the port's
    CPU route; f32 (scale, bias, relu) bit for bit against the port's
    route and within rtol 1e-6 against the Pallas kernel."""
    x, ops, bias, scale, _ = _case(kind, k, n, nnz)
    tile = _tiles(kind, ops, nnz)
    for m in (13, 32):
        sums = _body_sums(x[:m], tile, k, n)
        for label, act, od, has_scale, has_bias in EPILOGUES[1:]:
            b, s = (bias if has_bias else None), (scale if has_scale
                                                  else None)
            y = apply_epilogue(sums, Epilogue(act, has_bias, has_scale),
                               od, bias=b, scale=s)
            assert torch.equal(y, _port(kind, x[:m], ops, nnz, b, s, act,
                                        od)), (m, label)
            ref = _pallas(kind, k, n, nnz, label)[:m]
            if od == I8:
                assert torch.equal(y, ref), m
            else:
                torch.testing.assert_close(
                    y, ref, rtol=1e-6,
                    atol=1e-7 * ref.abs().max().item())


@pytest.mark.parametrize("kind", ["dense", "dbb"])
def test_all_127_is_the_exact_integer(kind):
    """All-127 operands at K 1184 N 136 (DBB nnz 8: every position
    kept): every sum of the model, of the Pallas kernel and of the port's
    route is 1184·127², past f32's exact 2^24."""
    x, ops, _, _, _ = _case(kind, 1184, 136, 8, fill=127)
    exact = 1184 * 127 * 127
    assert exact > 2 ** 24
    got = _body_sums(x, _tiles(kind, ops, 8), 1184, 136)
    assert bool((got == exact).all())
    assert torch.equal(got, _pallas(kind, 1184, 136, 8, "i32", fill=127))
    assert torch.equal(got, _port(kind, x, ops, 8, None, None, "none",
                                  None))
