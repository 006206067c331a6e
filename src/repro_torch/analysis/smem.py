"""Shared-memory contracts of the CUDA bodies (the counterpart of the
reference's vmem pass).

Each body with dynamic shared memory gets its instances as
`SmemContract`s: the bytes its launcher asks for (the Python mirror of the
body's own formula; tests/test_torch_analysis.py holds each mirror against
the C expression parsed out of its source), the guard's verdict, and
whether a refusal was for shared memory. `check_contracts` holds both
directions, as the reference does for VMEM:

  * ``smem-overflow``: the guard admits an instance that does not fit;
  * ``dead-headroom``: the guard refuses an instance for shared memory,
    yet it fits (the guard drifted conservative);
  * ``no-budget``: a contract declares no limit.

On the card (`with_static`) each entry's static shared memory, from the
``-Xptxas -v`` logs the build leaves beside each library, is added to its
dynamic bytes, and the sum is held to the card's opt-in per-block limit,
read through the build's C library (``cudaDevAttrMaxSharedMemoryPerBlock
Optin``).

`check_limit_sites` is the source pass: the limit's value may be spelled
only where it is defined (``kernels/common.py``'s SMEM_LIMIT and
``csrc/common.cuh``'s kSmemLimit), so no guard can fork its own copy.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.contracts import SmemContract, Violation
from repro_torch.kernels.common import SMEM_LIMIT

__all__ = ["contracts", "check_contracts", "check_limit_sites",
           "with_static", "static_smem", "optin_limit", "tc_gemm_smem",
           "tc_gemm_s8_smem", "split_smem", "split_s8_smem",
           "skinny_float_smem", "conv_tc_smem", "conv_tc_stages",
           "conv_small_smem"]
_DBB_BLOCK, _NNZ_MAX, _SMS = 8, 8, 132

# ---------------------------------------------------------------------------
# the bodies' formulas, mirrored (constants named as in the C sources)
# ---------------------------------------------------------------------------

# csrc/tc_gemm.cuh: 64 x 64 B tiles, 4 stages, the DBB byte-permute table
# (sel [256][2] and keep [256][4] uint32)
_TC_BN = _TC_BK = 64
_TC_STAGES = 4
_TC_EXPAND_TABLE = 256 * 2 * 4 + 256 * 4 * 4


def tc_gemm_smem(rows: int, dbb: bool) -> int:
    """tc_gemm.cuh's ``smem_bytes<BSrc>``: the stages (an A tile of
    ``rows`` x 64 bf16 and a 64 x 64 B tile), the full / empty barriers,
    the DBB table and 1024 bytes of alignment slack."""
    return (_TC_STAGES * (rows * _TC_BK * 2 + _TC_BK * _TC_BN * 2)
            + 2 * _TC_STAGES * 8 + (_TC_EXPAND_TABLE if dbb else 0) + 1024)


# csrc/tc_gemm_s8.cuh: 64 columns x 128 K a stage, 16 DBB blocks of it
_S8_BN, _S8_BK = 64, 128
_S8_BLOCKS = _S8_BK // _DBB_BLOCK
_S8_MASK_BYTES = _S8_BLOCKS * _S8_BN * 4


def tc_gemm_s8_smem(rows: int, stages: int, dbb: bool) -> int:
    """tc_gemm_s8.cuh's ``smem_bytes<BSrc>``: per stage the A and B tiles
    and the staged raw weight (dense: w's box; DBB: bitmask and values),
    three barriers; the DBB table, the scale and bias columns, 1024 bytes
    of slack."""
    raw = (_S8_MASK_BYTES + _S8_BLOCKS * _NNZ_MAX * _S8_BN if dbb
           else _S8_BK * _S8_BN)
    stage = (rows + _S8_BN) * _S8_BK + raw
    return (stages * (stage + 3 * 8) + (256 * 4 if dbb else 0)
            + 2 * _S8_BN * 4 + 1024)


# csrc/dbb_gemm_skinny.cu's float split-K body: 8 DBB blocks (64 K) and 64
# columns a stage; 5 stages on the f32 plane, 8 on the int8 / w4 planes
_SPLIT_STAGE_KB, _SPLIT_COLS = 8, 64
_SPLIT_STAGE_K = _SPLIT_STAGE_KB * _DBB_BLOCK
SPLIT_RING = {"f32": 5, "i8": 8, "w4": 8}


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def split_smem(plane: str, nnz: int, m: int, x_esz: int) -> int:
    """The launcher's ``layout<Plane>(nnz, mp, xsz, stages).total + 1024``:
    a ring of stages (bitmask rows, values rows, the w4 group scales, x
    rows on a 1024-byte boundary), for bf16 x two W^T tiles and the
    byte-permute table, the ring's barriers, the alignment slack."""
    stages = SPLIT_RING[plane]
    v_esz = 4 if plane == "f32" else 1
    v_rows = _SPLIT_STAGE_KB * nnz // (2 if plane == "w4" else 1)
    mp = _up(m, 8)
    vals = _SPLIT_STAGE_KB * _SPLIT_COLS * 4
    gs = vals + _up(v_rows * _SPLIT_COLS * v_esz, 16)
    x = _up(gs + (_SPLIT_STAGE_KB * _SPLIT_COLS * 4 if plane == "w4" else 0),
            1024)
    stage = _up(x + mp * _SPLIT_STAGE_K * x_esz, 1024)
    mma = x_esz == 2
    table = stages * stage + (2 * _SPLIT_COLS * _SPLIT_STAGE_K * 2
                              if mma else 0)
    bars = table + (_TC_EXPAND_TABLE if mma else 0)
    return bars + stages * 8 + 1024


# csrc/split_k_s8.cuh: 6 slots, 64 columns x 128 K a stage
_SPLIT8_STAGES, _SPLIT8_WT = 6, _S8_BN * _S8_BK


def split_s8_smem(dbb: bool, nnz: int, m: int) -> int:
    """split_k_s8.cuh's ``smem_bytes(dbb, nnz, mp)``."""
    raw = (_S8_MASK_BYTES + _S8_BLOCKS * nnz * _S8_BN if dbb
           else _S8_BK * _S8_BN)
    slot = _up(raw + _up(m, 8) * _S8_BK, 1024)
    return (_SPLIT8_STAGES * slot + 2 * _SPLIT8_WT + 256 * 4
            + _SPLIT8_STAGES * 8 + 1024)


# csrc/skinny_float.cuh: 16 strands x 8-row K groups, 64 columns; per x
# dtype (Lanes<T>) the row lanes RL and the ring's stages
_SF_STRANDS, _SF_GROUP_K, _SF_COLS, _SF_MAX_CLUSTER = 16, 8, 64, 8
_SF_ROUND_K = _SF_STRANDS * _SF_GROUP_K
_SF_LANES = {4: (2, 4), 2: (4, 6)}          # esz -> (RL, kStages)


def skinny_float_q(k_dim: int, n: int) -> int:
    """skinny_float.cuh's ``cluster_q``: the blocks that split the strands."""
    tiles = -(-n // _SF_COLS)
    rounds = -(-(k_dim // _SF_GROUP_K) // _SF_STRANDS)
    q = 1
    while q < _SF_MAX_CLUSTER and tiles * 2 * q <= _SMS and rounds >= 4 * q:
        q *= 2
    return q


def skinny_float_smem(m: int, k_dim: int, n: int, esz: int) -> int:
    """``layout(esz, xr, stages, q).total`` for the instantiation
    ``launch_float`` picks at (M, K, N): the ring (a [128][64] w tile and
    the [xr][128] x tile, rows padded by 16 bytes), the strands' partial
    tiles, the barriers."""
    rl, stages = _SF_LANES[esz]
    q = skinny_float_q(k_dim, n)
    rows = -(-m // (q * rl))
    mt = next(t for t in (1, 2, 4, 6, 8, 12, 16) if rows <= t)
    xr = _up(m if mt == 1 else mt * q * rl, 8)
    stage = _SF_ROUND_K * _SF_COLS * esz + xr * (_SF_ROUND_K * esz + 16)
    part = stages * stage
    return part + (_SF_STRANDS // q) * 8 * _SF_COLS * 4 + stages * 8


# csrc/conv_tc.cuh: 128 x 128 tiles, a stage's A tile two 64-byte pieces of
# 128 pixels, at most 6 stages within the limit; nnz 0 is the dense weight
_CT_BM = _CT_BN = 128
_CT_A, _CT_B = 2 * _CT_BM * 64, _CT_BN * 128
_CT_MAX_STAGES = 6
_CT_FIXED = 1024 + 256 * 4 + 2 * 2 * _CT_BN * 4


def _conv_tc_stage(int8: bool, nnz: int) -> int:
    slots = _DBB_BLOCK if nnz == 0 else nnz
    if int8:
        mask = 0 if nnz == 0 else _S8_MASK_BYTES
        return _CT_A + _CT_B + 2 * (mask + 16 * slots * 64)
    mask = 0 if nnz == 0 else 4 * _CT_BN * 4
    return _CT_A + 2 * _CT_B + mask + 4 * _CT_BN * 4 * slots


def conv_tc_stages(int8: bool, nnz: int) -> int:
    """conv_tc.cuh's ``stages_for<T>(nnz)``: as many as fit the limit."""
    return min((SMEM_LIMIT - _CT_FIXED) // (_conv_tc_stage(int8, nnz) + 24),
               _CT_MAX_STAGES)


def conv_tc_smem(int8: bool, nnz: int) -> int:
    """conv_tc.cuh's ``smem_bytes<T>(nnz, stages_for<T>(nnz))``."""
    return _CT_FIXED + conv_tc_stages(int8, nnz) * (
        _conv_tc_stage(int8, nnz) + 24)


# csrc/conv_gemm.cu's small-C body: 128 output pixels a block, 8 channels
# a thread, a 48 KB image window
_CS_BAND, _CS_NT, _CS_WINDOW = 128, 8, 48 * 1024


def _out_spatial(size: int, k: int, stride: int, padding: str) -> int:
    if padding == "SAME":
        return -(-size // stride)
    return max(0, (size - k) // stride + 1)


def conv_small_smem(h: int, w: int, c: int, n: int, kh: int, kw: int,
                    stride: int, padding: str, int8: bool) -> int:
    """``small_smem(words, CL·kNT, nwin).total`` for the tile
    ``small_geom`` picks: the filter [words][NP], scale and bias [2][NP],
    the K table [words], the image window [nwin] words."""
    pack = 4 if int8 else 1
    cp = _up(c, pack)
    words = kh * kw * cp // pack
    ho, wo = (_out_spatial(h, kh, stride, padding),
              _out_spatial(w, kw, stride, padding))
    cw = min(wo, _CS_BAND)
    r = min(_CS_BAND // cw, ho)
    while True:
        wr, wc = (r - 1) * stride + kh, (cw - 1) * stride + kw
        if wr * wc * cp * 4 // pack <= _CS_WINDOW or (r == 1 and cw == 1):
            break
        if r > 1:
            r = (r + 1) // 2
        else:
            cw = (cw + 1) // 2
    cl = next(x for x in (1, 2, 4, 8) if n <= x * _CS_NT)
    np_ = cl * _CS_NT
    nwin = wr * wc * (cp // pack)
    ep = _up(words * np_ * 4, 16)
    return ep + 2 * np_ * 4 + _up(words * 4, 16) + nwin * 4


# ---------------------------------------------------------------------------
# the repo's instances
# ---------------------------------------------------------------------------

def contracts() -> List[SmemContract]:
    """Every body with dynamic shared memory, at the configs' shapes and
    at the guards' edges."""
    from repro_torch.kernels.attn.ops import (_decode_smem_bytes,
                                              _flash_smem_bytes, flash_ok,
                                              paged_decode_ok, tc_body)
    from repro_torch.kernels.conv_gemm.ops import small_body
    bf, f32 = torch.bfloat16, torch.float32
    out: List[SmemContract] = []

    def add(name, body, kernel, entry, nbytes, admitted=True,
            smem_reject=False, notes=""):
        out.append(SmemContract(name, body, kernel, entry, int(nbytes),
                                SMEM_LIMIT, admitted, smem_reject, notes))

    for d in (64, 128, 256):
        for kernel in ("flash_prefill", "flash_prefill_packed"):
            assert tc_body(bf, d)
            add(f"{kernel} tc[D{d} bf16]", "csrc/flash_tc.cuh:132", kernel,
                f"{kernel}_tc_kernel", _flash_smem_bytes(d, bf), flash_ok(d, bf))
    for d, dt in ((32, f32), (64, f32), (72, bf), (128, f32), (256, f32),
                  (264, f32)):
        admitted = flash_ok(d, dt)
        add(f"flash_prefill fma[D{d} {_dt(dt)}]", "csrc/flash_tile.cuh:44",
            "flash_prefill", "flash_prefill_kernel", _flash_smem_bytes(d, dt), admitted,
            notes="" if admitted else "refused for D > 256, not for smem")
    for g, d, dt in ((1, 128, bf), (1, 128, f32), (7, 128, bf),
                     (8, 112, bf), (8, 256, bf), (8, 256, f32),
                     (32, 128, f32), (32, 256, bf), (64, 256, f32)):
        nbytes = _decode_smem_bytes(g, d, dt.itemsize)
        ok = paged_decode_ok(g, 64, d, dt)
        add(f"paged_decode[G{g} D{d} {_dt(dt)}]", "csrc/paged_decode.cu:105",
            "paged_decode", "paged_decode_split_kernel", nbytes, ok,
            smem_reject=not ok and nbytes > SMEM_LIMIT)
    add("tc_gemm dense[BM128]", "csrc/tc_gemm.cuh:237", "sta_gemm",
        "tc_gemm_kernel", tc_gemm_smem(128, False))
    for rows in (128, 256):
        for plane in ("f32", "i8", "w4"):
            add(f"tc_gemm dbb {plane}[BM{rows}]", "csrc/tc_gemm.cuh:237",
                "dbb_gemm", "tc_gemm_kernel",
                tc_gemm_smem(rows, True))
    for rows, stages in ((128, 6), (256, 4)):
        add(f"tc_gemm_s8 dense[BM{rows} x{stages}]",
            "csrc/tc_gemm_s8.cuh:122", "sta_gemm", "tc_gemm_s8_kernel",
            tc_gemm_s8_smem(rows, stages, False))
        add(f"tc_gemm_s8 dbb[BM{rows} x{stages}]",
            "csrc/tc_gemm_s8.cuh:122", "dbb_gemm", "tc_gemm_s8_kernel",
            tc_gemm_s8_smem(rows, stages, True))
    for plane in ("f32", "i8", "w4"):
        for esz in (4, 2):
            # the w4 plane packs two slots a byte: an even nnz
            for nnz in ((2, 4, 8) if plane == "w4" else (1, 4, 8)):
                for m in (1, 8, 32):
                    add(f"split_k {plane}[x{'f32' if esz == 4 else 'bf16'} "
                        f"nnz{nnz} M{m}]", "csrc/dbb_gemm_skinny.cu:173",
                        "dbb_gemm_skinny", "dbb_gemm_skinny_split_kernel",
                        split_smem(plane, nnz, m, esz))
    for dbb in (False, True):
        for nnz in ((1, 4, 8) if dbb else (8,)):
            for m in (1, 8, 24, 32):
                kern = "dbb_gemm_skinny" if dbb else "sta_gemm_skinny"
                add(f"split_k_s8 {'dbb' if dbb else 'dense'}[nnz{nnz} M{m}]",
                    "csrc/split_k_s8.cuh:109", kern, "skinny_s8_kernel",
                    split_s8_smem(dbb, nnz, m))
    for esz in (4, 2):
        for m, k_dim, n in ((1, 2048, 2048), (8, 2048, 8192),
                            (24, 8192, 2048), (32, 2048, 50304),
                            (32, 7168, 163840), (8, 2048, 256)):
            add(f"skinny_float[{'f32' if esz == 4 else 'bf16'} M{m} "
                f"K{k_dim} N{n}]", "csrc/skinny_float.cuh:122",
                "sta_gemm_skinny", "skinny_float_kernel",
                skinny_float_smem(m, k_dim, n, esz))
    for int8 in (False, True):
        for nnz in (0, 1, 2, 4, 8):
            add(f"conv_tc {'int8' if int8 else 'f32'}"
                f"[{'dense' if nnz == 0 else f'nnz{nnz}'}]",
                "csrc/conv_tc.cuh:181",
                "conv_gemm" if nnz == 0 else "conv_gemm_dbb",
                "conv_tc_kernel",
                conv_tc_smem(int8, nnz))
    # convnet's conv0 (32x32x3 -> 64 3x3) and lenet's conv1 (14x14x6 -> 16
    # 5x5), f32 and int8, and a stride-2 VALID edge
    for h, w, c, n, k, stride, pad in ((32, 32, 3, 64, 3, 1, "SAME"),
                                       (14, 14, 6, 16, 5, 1, "SAME"),
                                       (33, 31, 5, 40, 5, 2, "VALID")):
        for int8 in (False, True):
            if not small_body(torch.int8 if int8 else f32, c, k, k, n):
                continue
            add(f"conv_small[{h}x{w}x{c} -> {n} {k}x{k} s{stride} {pad} "
                f"{'int8' if int8 else 'f32'}]", "csrc/conv_gemm.cu:151",
                "conv_gemm", "conv_small_kernel",
                conv_small_smem(h, w, c, n, k, k, stride, pad, int8))
    return out


def _dt(dtype: torch.dtype) -> str:
    return {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]


# ---------------------------------------------------------------------------
# the passes
# ---------------------------------------------------------------------------

def check_contracts(cs: Sequence[SmemContract],
                    static: Optional[Dict[str, int]] = None,
                    limit: Optional[int] = None
                    ) -> Tuple[int, List[Violation]]:
    """Both directions of every contract against its budget (or, on the
    card, ``limit``, with ``static[name]`` bytes of static shared memory
    added)."""
    out: List[Violation] = []
    for c in cs:
        budget = limit if limit is not None else c.budget
        total = c.smem_bytes + (static or {}).get(c.name, 0)
        fits = total <= budget
        if not budget:
            out.append(Violation("smem", "no-budget", c.name,
                                 "contract declares no shared-memory limit"))
            continue
        if c.admitted and not fits:
            out.append(Violation(
                "smem", "smem-overflow", c.name,
                f"guard admits an instance that does not fit: {total} B > "
                f"{budget} B ({c.body})"))
        if not c.admitted and c.smem_reject and fits:
            out.append(Violation(
                "smem", "dead-headroom", c.name,
                f"guard refuses for shared memory but {total} B fits "
                f"{budget} B: conservative drift ({c.body})"))
    return len(cs), out


# the limit's value, as a Python or C spelling
_LIMIT_RE = re.compile(r"\b232448\b|\b227\s*\*\s*1024\b")
_LIMIT_SITES = (os.path.join("repro_torch", "kernels", "common.py"),
                os.path.join("repro_torch", "csrc", "common.cuh"))


def check_limit_sites(src_root: str) -> Tuple[int, List[Violation]]:
    """The limit spelled outside its two definition sites (``src_root`` is
    the directory holding ``repro_torch/``)."""
    out: List[Violation] = []
    checked = 0
    for dirpath, _, files in os.walk(os.path.join(src_root, "repro_torch")):
        for fname in sorted(files):
            if not fname.endswith((".py", ".cu", ".cuh")):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, src_root)
            checked += 1
            if rel in _LIMIT_SITES:
                continue
            with open(path, encoding="utf-8") as f:
                for lineno, line in enumerate(f, 1):
                    if _LIMIT_RE.search(line):
                        out.append(Violation(
                            "smem", "raw-smem-limit", f"{rel}:{lineno}",
                            "the shared-memory limit spelled out: use "
                            "kernels.common.SMEM_LIMIT / common.cuh's "
                            "kSmemLimit"))
    return checked, out


def static_smem(build_dir: Path) -> Dict[Tuple[str, str], int]:
    """``{(kernel, entry): static bytes}`` from the ``-Xptxas -v`` logs
    the build leaves beside each library (``lib<kernel>-<hash>.log``);
    entries by their mangled names."""
    out: Dict[Tuple[str, str], int] = {}
    for log in sorted(Path(build_dir).glob("lib*.log")):
        kernel = log.name[3:].rsplit("-", 1)[0]
        entry = None
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"Used \d+ registers(?:.*?(\d+) bytes smem)?", line)
            if m and entry:
                out[(kernel, entry)] = int(m.group(1) or 0)
                entry = None
    return out


def with_static(cs: Sequence[SmemContract],
                table: Dict[Tuple[str, str], int]
                ) -> Tuple[Dict[str, int], List[Violation]]:
    """Each contract's static bytes: the most any of its library's entries
    whose name holds ``entry`` reports; a contract with no such entry in
    the logs is a finding."""
    out: Dict[str, int] = {}
    missing: List[Violation] = []
    for c in cs:
        hits = [b for (k, e), b in table.items()
                if k == c.kernel and c.entry in e]
        if not hits:
            missing.append(Violation(
                "smem", "no-entry", c.name,
                f"no '{c.entry}' entry in the ptxas log of {c.kernel}"))
            continue
        out[c.name] = max(hits)
    return out, missing


def optin_limit() -> int:
    """The card's opt-in per-block shared memory, read through the build's
    C library (``paged_decode_smem_optin``)."""
    import ctypes

    from repro_torch.kernels import build
    fn = build.load("paged_decode").paged_decode_smem_optin
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    v = fn(torch.cuda.current_device())
    if v <= 0:
        raise RuntimeError(f"cudaDeviceGetAttribute failed: cudaError {-v}")
    return v
