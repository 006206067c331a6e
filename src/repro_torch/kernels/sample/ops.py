"""Wrapper of the fused head-sample kernel (csrc/head_sample_fused.cu).

``head_sample_fused(h, w, counts, temp, rep, pres, freq, seed, step,
base)`` samples one token per hidden row: the head GEMV ``h @ w``, then the
penalty → temperature → Gumbel epilogue and the row's argmax, without the
``[M, N]`` logits ever reaching device memory. On a CUDA tensor it
launches the kernel (or raises); on a CPU tensor it runs the plain
version (`ref.sample_argmax` of the f32 product).

The kernel takes M ≤ 32 rows and K, N multiples of 128; the wrapper
raises on anything else. It does not pad the vocabulary: a pad column
could win the argmax.

The kernel runs the greedy head's persistent float body
(csrc/skinny_float.cuh, shared with ``sta_gemm_skinny``) with a sampling
epilogue: each block leaves one (score, index) partial per row, and a
second launch merges them. The wrapper allocates the ``[M, P]``
workspace, P the library's ``head_sample_fused_partials(K, N)``: the
blocks that walk the 64-column tiles (a cluster of Q of them splitting K
where the tiles are few), a function of K and N alone, so the
workspace's shape never depends on M and the call is ready for a
CUDA-graph capture. `partials` mirrors that rule in Python (the tests
hold it against the C source and the library).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (LAUNCHES, SKINNY_M_MAX,
                                        check_operand)
from repro_torch.kernels.sample.ref import sample_argmax

__all__ = ["head_sample_fused", "head_sample_fused_ref", "TILE_N",
           "partials", "workspace_elems"]

TILE_N = 128        # the reference's tile; K and N must be multiples of it

# csrc/skinny_float.cuh's grid: 64-column tiles, K rounds of 16 strands x
# 8-row groups, clusters of up to 8 blocks, one block a SM of the H100 SXM
_COLS, _STRANDS, _GROUP_K, _MAX_CLUSTER, _SMS = 64, 16, 8, 8, 132


def partials(k_dim: int, n: int) -> int:
    """The (score, index) partials a row leaves: the float body's blocks at
    (K, N) — csrc/skinny_float.cuh's ``blocks`` (via ``cluster_q``), read
    by the kernel as ``head_sample_fused_partials``."""
    tiles = -(-n // _COLS)
    rounds = -(-(k_dim // _GROUP_K) // _STRANDS)
    q = 1
    while q < _MAX_CLUSTER and tiles * 2 * q <= _SMS and rounds >= 4 * q:
        q *= 2
    return min(tiles, _SMS // q)


@functools.lru_cache(maxsize=None)
def _partials(k_dim: int, n: int) -> int:
    """`partials` as the library computes it (asked once per shape)."""
    fn = build.load("head_sample_fused").head_sample_fused_partials
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(k_dim, n)


def workspace_elems(m: int, k_dim: int, n: int) -> int:
    """Elements of each of the call's two workspace planes (the partials'
    f32 scores and int32 indices, ``[M, partials(K, N)]``): a pure function
    of the shapes; the wrapper allocates exactly this."""
    return m * partials(k_dim, n)


@functools.lru_cache(maxsize=None)
def _checked_partials(k_dim: int, n: int) -> int:
    """`partials`, held once per shape against the library's count: a
    workspace sized by a rule the kernel does not follow would be written
    past its end."""
    want, got = partials(k_dim, n), _partials(k_dim, n)
    if got != want:
        raise RuntimeError(f"head_sample_fused: the library leaves {got} "
                           f"partials at K={k_dim} N={n}, the Python rule "
                           f"{want}")
    return want


def head_sample_fused_ref(h, w, counts, temp, rep, pres, freq, seed, step,
                          base: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: f32 logits, then `sample_argmax`."""
    logits = torch.matmul(h.float(), w.float())
    return sample_argmax(logits, counts, temp, rep, pres, freq, seed, step,
                         base=base)


def _launcher():
    fn = build.load("head_sample_fused").head_sample_fused_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def head_sample_fused(h: torch.Tensor, w: torch.Tensor, counts: torch.Tensor,
                      temp, rep, pres, freq, seed, step, base: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best score [M] f32, sampled LOCAL index [M] i32) for hidden rows
    ``h [M, K]`` f32 against the head ``w [K, N]`` f32, output-token
    counts ``counts [M, N]`` i32 and per-row ``temp``/``rep``/``pres``/
    ``freq`` (f32), ``seed`` (i32 bit pattern) and ``step`` (i32) of shape
    ``[M]``. ``base`` is the global vocab id of column 0 (the noise
    counter's offset)."""
    m, k_dim = h.shape
    n = w.shape[1]
    if not (1 <= m <= SKINNY_M_MAX and k_dim % TILE_N == 0
            and n % TILE_N == 0):
        raise ValueError(f"head_sample_fused takes M in [1, {SKINNY_M_MAX}] "
                         f"and K, N multiples of {TILE_N}; got M={m} "
                         f"K={k_dim} N={n}")
    dev = h.device
    check_operand("h", h, (m, k_dim), (torch.float32,), dev)
    check_operand("w", w, (k_dim, n), (torch.float32,), dev)
    check_operand("counts", counts, (m, n), (torch.int32,), dev)
    rows = []
    for name, a, dt in (("temp", temp, torch.float32),
                        ("rep", rep, torch.float32),
                        ("pres", pres, torch.float32),
                        ("freq", freq, torch.float32),
                        ("seed", seed, torch.int32),
                        ("step", step, torch.int32)):
        if tuple(a.shape) != (m,) or a.dtype != dt or a.device != dev:
            raise ValueError(f"{name}: {tuple(a.shape)} {a.dtype} on "
                             f"{a.device}, expected ({m},) {dt} on {dev}")
        rows.append(a.contiguous())
    if dev.type == "cpu":
        return head_sample_fused_ref(h, w, counts, *rows, base=base)
    if dev.type != "meta":
        _checked_partials(k_dim, n)
    part_score = torch.empty((workspace_elems(m, k_dim, n),),
                             dtype=torch.float32, device=dev)
    part_idx = torch.empty((workspace_elems(m, k_dim, n),),
                           dtype=torch.int32, device=dev)
    score = torch.empty((m,), dtype=torch.float32, device=dev)
    idx = torch.empty((m,), dtype=torch.int32, device=dev)
    if dev.type == "meta":
        return score, idx
    rc = _launcher()(
        h.data_ptr(), w.data_ptr(), counts.data_ptr(),
        *(a.data_ptr() for a in rows), int(base),
        part_score.data_ptr(), part_idx.data_ptr(), score.data_ptr(),
        idx.data_ptr(), m, k_dim, n, build.stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"head_sample_fused launch failed: cudaError {rc}")
    LAUNCHES["head_sample_fused"] += 1
    return score, idx
