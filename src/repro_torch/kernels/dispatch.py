"""Kernel dispatch: the route tables of the ``matmul``, ``conv``,
``attention``, ``attn_decode`` and ``head_sample`` domains, their guards,
their roofline costs, and the front doors the model layers call.

Route names and the override order are the JAX package's, so overrides
carry over: ``REPRO_FORCE_ROUTE`` (one bare route name, or
``domain=route`` pairs separated by commas) > ``ModelConfig.kernel_routes``
> auto. A forced route whose guard rejects the op, or that this port does
not implement, warns once and falls back to auto.

Auto is the reference's roofline selection (`repro.kernels.dispatch`):
each route's cost is ``max(flops / peak_flops, bytes / hbm_bw)`` from the
reference's formulas term for term (FLOPs at the kernels' padded M / N /
K, the weight stream compressed or dense, unfused epilogue passes charged
to the plain route), costed on `roofline.analysis.HW_H100`. Among the
applicable routes that do not defer, the cheapest wins; costs within
``COST_TIE_RTOL`` of it tie, and the lower ``priority`` (the more
specialised kernel) wins the tie. `explain` returns the ranked table with
every route's terms and `format_table` renders it, as the serve CLI logs
it. Guards are stated for the H100 kernels in ``csrc/`` — what each
kernel takes — not carried over from TPU VMEM budgets; the head GEMV
(``gemv=True``) stays off the M-tiled ``sta`` route, as in the reference.

Ported routes: matmul ``xla`` (plain torch), ``sta``, ``skinny_sta``,
``dbb_packed``, ``skinny_dbb`` (f32 or int8 values planes),
``dbb_packed_w4``, ``skinny_dbb_w4`` (the nibble plane); conv
``conv_xla`` (explicit im2col), ``conv_sta``, ``conv_dbb``. As in the
reference, int8 activations take the GEMM and conv kernels (their int8
branches: INT8 × INT8 → INT32), the DBB ones on the INT8 values plane;
the w4 routes take float activations only. Attention
``attn_flash``, ``attn_packed_flash``, ``attn_chunked`` (the blocked
plain route with a running-softmax combine, no kernel), ``attn_naive``,
``attn_packed_ref``; attn_decode
``attn_decode_flash``, ``attn_decode_xla``; head_sample
``head_sample_fused``, ``head_sample_xla``.

A route may also defer: applicable, but auto takes it only when no other
applicable route is left (the reference's ``defer``). ``attn_chunked``
defers up to S = 2 · chunk, where its per-chunk loop costs more than the
naive route's extra score traffic; a pin takes it all the same.

Tensor parallelism (``OpSpec.tp > 1``): a GEMM is costed as the per-shard
instance a TP rank runs — K split when the op pays a boundary
``collective`` ("all-reduce" / "reduce-scatter": row-parallel), N split
otherwise (column-parallel) — and the collective's bytes over
`roofline.analysis.collective_bw` are a third pipe beside compute and
memory, as in the reference. Guards read the local dims, and name an axis
split that does not divide. Inside a TP shard body (``shard_tp() > 0``)
the dims a caller gives are already local. Unlike the reference, a live
mesh does not turn the kernel routes off: each rank's operands are its
own local tensors, with no global graph for a kernel to be kept out of.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import warnings
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.dbb import DbbWeight
from repro_torch.kernels.attn.ops import (FLASH_D_MAX, PAGE_MIN, flash_ok,
                                          paged_decode_ok)
from repro_torch.kernels.common import (FLOAT_DTYPES, OPERAND_DTYPES,
                                        SKINNY_M_MAX, skinny_ok)
from repro_torch.kernels.sample.ops import TILE_N as _HS_TILE
from repro_torch.roofline.analysis import HW_H100, Hardware, collective_bw
from repro_torch.roofline.counts import route_call

__all__ = ["OpSpec", "Route", "RouteDecision", "select", "explain",
           "format_table", "matmul", "conv", "attention",
           "packed_attention", "chunk_attention_route", "chunk_attention",
           "head_sample", "decode_attention_route", "attn_decode",
           "pallas_route_active",
           "flash_backend_active", "forced_route", "routes_from_cfg",
           "FORCE_ROUTE_ENV", "COST_TIE_RTOL", "ROUTES", "KERNEL_ROUTES",
           "no_autograd"]

FORCE_ROUTE_ENV = "REPRO_FORCE_ROUTE"
# relative cost window treated as a tie (the roofline model is first
# order; within it the more specialised kernel wins on priority)
COST_TIE_RTOL = 0.10

_MASK_BYTES = 1          # DBB bitmask storage: 1 byte per 8-block
_F32 = 4


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """Static description of one op. GEMMs use (m, k, n) literally; the
    attention domain maps T to m, head_dim to k and S to n (a packed batch
    carries its total token count in both); the decode domain maps the
    GQA group to m, head_dim to k and the cache length to n. Convs
    describe the implied GEMM (M = B·Ho·Wo, K = kh·kw·C) and carry
    ``conv_geom = (b, h, w, c, kh, kw, stride[, padding])`` (padding
    "SAME" when left out). Attention also carries ``ragged`` (per-row
    position ladders), ``chunk`` (the chunked route's block) and
    ``batch`` (rows of a padded batch; a packed batch keeps 1, its m
    already counting every token). ``itemsize``, ``out_itemsize``,
    ``vals_itemsize`` and ``epilogue_ops`` feed the route costs only."""
    domain: str
    m: int
    k: int
    n: int
    itemsize: int = 4             # operand bytes (activations / q)
    out_itemsize: int = 4
    packed: bool = False          # weight is a DbbWeight
    block: int = 8
    nnz: int = 4
    vals_itemsize: int = 1        # packed values-plane bytes
    bits: int = 8
    group: int = 0                # w4 scale group along dense K (bits=4)
    epilogue_ops: int = 0         # bias / scale / act passes the plain
                                  # route runs unfused
    pallas: bool = False          # fused kernel route family is active
    dense_fused: bool = True      # call site opts dense weights into kernels
    gemv: bool = False            # the decode head GEMV: never M-tiled
    float_ok: bool = True         # operand dtype the kernels accept
    x_int8: bool = False          # int8 activations (the kernels' int8
                                  # branches: INT8 x INT8 -> INT32)
    int8_values: bool = False     # a packed weight's values plane is int8
    conv_geom: Tuple[Any, ...] = ()
    page: int = 0
    flash_active: bool = False
    packed_seq: bool = False      # packed (cu_seqlens) prefill batch
    ragged: bool = False          # per-row (left-padded) position ladders
    chunk: int = 1024             # attn_chunked's block (cfg.attn_chunk)
    batch: int = 1                # rows of a padded attention batch
    sample_tt: bool = False       # some sampled row uses top-k / top-p
    ring: bool = False            # decode on a ring-buffer (sliding-window)
                                  # cache: the new token's slot wraps
    tp: int = 1                   # TP split: cost the per-shard instance
    collective: str = ""          # the boundary collective the op's block
                                  # pays ("all-reduce", "reduce-scatter",
                                  # "all-gather"; "": none, column split)


class Route(NamedTuple):
    """One entry of a domain's table: its guard ("" = applicable, else the
    reason), its tie-break ``priority`` (lower wins), its ``cost`` (flops,
    bytes), an optional ``defer`` (auto passes it over while another
    applicable route is left) and ``wbytes``, the weight-stream bytes it
    is costed at (None: it streams no weight)."""
    name: str
    guard: Callable[[OpSpec], str]
    priority: int
    cost: Callable[[OpSpec], Tuple[float, float]]
    defer: Optional[Callable[[OpSpec], bool]] = None
    wbytes: Optional[Callable[[OpSpec], float]] = None


@dataclasses.dataclass
class RouteDecision:
    """One row of the explain table."""
    name: str
    applicable: bool
    reason: str                  # why not applicable ("" if it is)
    flops: float
    bytes: float
    compute_s: float
    memory_s: float
    cost_s: float
    priority: int
    deferred: bool = False
    chosen: bool = False
    forced: bool = False
    weight_bytes: float = 0.0    # weight-stream traffic term (0 = n/a)
    # TP terms (0 / tp=1 outside a sharded costing)
    collective_bytes: float = 0.0
    collective_s: float = 0.0
    tp: int = 1
    mesh: str = ""               # the mesh the table was costed for

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# guards ("" = applicable, else the reason)
# ---------------------------------------------------------------------------

_NO_PALLAS = "fused route not selected (gemm_impl != 'pallas')"


def _shard_dims(s: OpSpec) -> Tuple[int, int, int]:
    """Per-shard (m, k, n) of a TP-split GEMM: row-parallel ops (a
    reduction-boundary collective) split K, the others split N; tp=1
    passes the dims through."""
    if s.tp <= 1:
        return s.m, s.k, s.n
    if s.collective in ("all-reduce", "reduce-scatter"):
        return s.m, max(s.k // s.tp, 1), s.n
    return s.m, s.k, max(s.n // s.tp, 1)


def _tp_split_reason(s: OpSpec) -> str:
    """The declared TP split's divisibility ("" = clean): a dim that does
    not divide tp has no per-shard kernel instance."""
    if s.tp <= 1:
        return ""
    if s.collective in ("all-reduce", "reduce-scatter"):
        if s.k % s.tp:
            return (f"unsupported axis split: K={s.k} % tp={s.tp} != 0 "
                    "(row-parallel shard)")
    elif s.n % s.tp:
        return f"unsupported axis split: N={s.n} % tp={s.tp} != 0"
    return ""


def _per_shard(s: OpSpec) -> str:
    return "per-shard " if s.tp > 1 else ""


def _guard_dense(s: OpSpec) -> str:
    """What both dense GEMM kernels need."""
    if s.packed:
        return "weight is DBB-packed (the dense kernels take dense [K,N])"
    if not s.pallas:
        return _NO_PALLAS
    if not s.dense_fused:
        return "call site keeps dense weights on the plain matmul"
    if not s.float_ok:
        return "operand dtype outside the kernel contract (f32/bf16/int8)"
    return _tp_split_reason(s)


def _guard_skinny_sta(s: OpSpec) -> str:
    r = _guard_dense(s)
    if r:
        return r
    if not skinny_ok(s.m):
        return f"outside the skinny regime (M ≤ {SKINNY_M_MAX})"
    _, k_loc, _ = _shard_dims(s)
    if k_loc % 8:
        return (f"{_per_shard(s)}K={k_loc} not a multiple of the kernel's "
                "8-row groups")
    return ""


def _guard_sta(s: OpSpec) -> str:
    r = _guard_dense(s)
    if r:
        return r
    if s.gemv:
        return "head GEMV: M-tiling gains nothing on [B,d]·[d,V]"
    return ""


def _guard_packed_base(s: OpSpec) -> str:
    """What every packed-weight kernel route needs, whatever its values
    plane."""
    if not s.packed:
        return "weight is dense (the DBB kernels take values+bitmask)"
    if not s.pallas:
        return _NO_PALLAS
    if s.block != 8 or not 1 <= s.nnz <= 8:
        return f"DBB B={s.block}, k={s.nnz}: the kernels take B=8, k≤8"
    if s.k % s.block:
        return f"K={s.k} not divisible by the DBB block {s.block}"
    r = _tp_split_reason(s)
    if r:
        return r
    _, k_loc, _ = _shard_dims(s)
    if k_loc % s.block:
        return (f"per-shard K={k_loc} not divisible by the DBB block "
                f"{s.block} (tp={s.tp} splits inside a block)")
    return ""


def _int8_plane_reason(s: OpSpec) -> str:
    if s.x_int8 and not s.int8_values:
        return ("int8 activations: the int8 branch streams the INT8 values "
                "plane (pack_tree(quantize=True))")
    return ""


def _guard_dbb_packed(s: OpSpec) -> str:
    r = _guard_packed_base(s)
    if r:
        return r
    if s.bits == 4:
        return ("values plane is nibble-packed INT4 (the w4 routes "
                "stream it)")
    if not s.float_ok:
        return "operand dtype outside the kernel contract (f32/bf16/int8)"
    return _int8_plane_reason(s)


def _guard_dbb_packed_w4(s: OpSpec) -> str:
    r = _guard_packed_base(s)
    if r:
        return r
    if s.bits != 4:
        return "values plane is INT8 (w4 routes take the nibble plane)"
    if s.x_int8 or not s.float_ok:
        return ("int8 activations: the w4 dequantized tile is float "
                "(float x only)")
    if s.group <= 0 or s.group % s.block:
        return (f"scale group {s.group} must be a positive multiple of "
                f"the DBB block {s.block}")
    _, k_loc, _ = _shard_dims(s)
    if k_loc % s.group:
        return (f"{_per_shard(s)}K={k_loc} not divisible by the scale "
                f"group {s.group}")
    return ""


def _skinny_reason(s: OpSpec) -> str:
    if not skinny_ok(s.m):
        return f"outside the skinny regime (M ≤ {SKINNY_M_MAX})"
    return ""


def _guard_skinny_dbb(s: OpSpec) -> str:
    return _guard_dbb_packed(s) or _skinny_reason(s)


def _guard_skinny_dbb_w4(s: OpSpec) -> str:
    return _guard_dbb_packed_w4(s) or _skinny_reason(s)


def _guard_conv_kernel(s: OpSpec) -> str:
    """What both implicit-GEMM conv kernels need. Their shared-memory
    staging does not grow with the image, so no image size is refused
    for it."""
    if not s.pallas:
        return "implicit-GEMM kernels not selected (use_kernel=False)"
    if not s.float_ok:
        return "operand dtype outside the kernel contract (f32/bf16/int8)"
    if len(s.conv_geom) < 7:
        return "conv_geom=(b, h, w, c, kh, kw, stride) required"
    return ""


def _guard_conv_sta(s: OpSpec) -> str:
    if s.packed:
        return "weight is DBB-packed"
    return _guard_conv_kernel(s)


def _guard_conv_dbb(s: OpSpec) -> str:
    if not s.packed:
        return "weight is dense"
    if s.bits != 8:
        return f"bits={s.bits}: the conv kernels take the bits=8 plane only"
    r = _guard_conv_kernel(s)
    if r:
        return r
    if s.block != 8 or not 1 <= s.nnz <= 8:
        return f"DBB B={s.block}, k={s.nnz}: the kernel takes B=8, k≤8"
    c, kw = s.conv_geom[3], s.conv_geom[5]
    if (kw * c) % s.block:
        return (f"kw·C = {kw * c} not divisible by the DBB block "
                f"{s.block} (a kernel row must cover whole blocks)")
    if s.int8_values and not s.x_int8:
        return ("float activations on INT8 values: the conv kernel's float "
                "branch streams the f32 values plane")
    return _int8_plane_reason(s)


def _guard_decode_flash(s: OpSpec) -> str:
    if s.ring:
        return "ring-buffer (sliding-window) cache layout"
    if not s.flash_active:
        return "flash backend not selected (attn_impl / gemm_impl)"
    if not s.float_ok:
        return "non-float operands"
    if not skinny_ok(s.m):
        return f"GQA group {s.m} over SKINNY_M_MAX={SKINNY_M_MAX}"
    if s.page < PAGE_MIN:
        return f"page {s.page} below {PAGE_MIN} slots"
    if s.n % s.page:
        return f"cache length {s.n} not a multiple of page {s.page}"
    if not paged_decode_ok(s.m, s.page, s.k):
        return "the decode block's shared memory exceeds 227 KB"
    return ""


def _guard_attn_flash(s: OpSpec) -> str:
    if s.packed_seq:
        return "packed cu_seqlens batch (block-diagonal masking required)"
    return _guard_flash_common(s)


def _guard_attn_packed_flash(s: OpSpec) -> str:
    if not s.packed_seq:
        return "not a packed cu_seqlens batch"
    return _guard_flash_common(s)


def _guard_flash_common(s: OpSpec) -> str:
    if not s.flash_active:
        return "flash backend not selected (attn_impl / gemm_impl)"
    if not s.float_ok:
        return "non-float operands"
    if not flash_ok(s.k):
        return (f"head dim {s.k}: the flash kernels take 1 <= D <= "
                f"{FLASH_D_MAX}, their tiles within 227 KB")
    return ""


def _guard_attn_chunked(s: OpSpec) -> str:
    if s.packed_seq:
        return "packed cu_seqlens batch (block-diagonal masking required)"
    if s.ragged:
        return "ragged per-row positions (chunked masks assume one ladder)"
    if s.m != s.n:
        return "not a self-attention full-sequence call (T != S)"
    if s.n % max(s.chunk, 1):
        return f"S={s.n} not divisible by attn_chunk={s.chunk}"
    return ""


def _guard_attn_naive(s: OpSpec) -> str:
    return ("packed cu_seqlens batch (block-diagonal masking required)"
            if s.packed_seq else "")


def _guard_attn_packed_ref(s: OpSpec) -> str:
    return "" if s.packed_seq else "not a packed cu_seqlens batch"


def _guard_head_sample_fused(s: OpSpec) -> str:
    if not s.pallas:
        return _NO_PALLAS
    if not s.float_ok:
        return "non-float hidden rows (the sampling epilogue is f32)"
    if s.sample_tt:
        return ("top-k/top-p are global order statistics — the streaming "
                "epilogue cannot sort the row (the plain sampler takes it)")
    r = _tp_split_reason(s)             # vocab-parallel: N splits
    if r:
        return r
    if not skinny_ok(s.m):
        return f"outside the skinny regime (M ≤ {SKINNY_M_MAX})"
    _, _, n_loc = _shard_dims(s)
    if s.k % _HS_TILE or n_loc % _HS_TILE:
        return (f"K={s.k} / {'local ' if s.tp > 1 else ''}N={n_loc} not "
                f"divisible by the {_HS_TILE}-column tile (vocab padding "
                "could win the argmax)")
    return ""


def _always(_s: OpSpec) -> str:
    return ""


# ---------------------------------------------------------------------------
# route costs: the reference's roofline terms, (flops, bytes) per route
# ---------------------------------------------------------------------------

def _mm_dims(s: OpSpec, skinny: bool) -> Tuple[int, int, int]:
    """Padded (mp, kp, np) the reference costs a kernel at, of the
    per-shard instance: M-tiled kernels pad M to a tile of min(128,
    round_up(m, 8)) rows, skinny ones to the 8-row quantum; K and N to
    128."""
    m, k, n = _shard_dims(s)
    if skinny:
        mp = _round_up(max(m, 1), 8)
    else:
        mp = _round_up(max(m, 1), min(128, _round_up(max(m, 1), 8)))
    return mp, _round_up(max(k, 1), 128), _round_up(max(n, 1), 128)


def _dense_w_bytes(s: OpSpec, kp: int, np_: int) -> float:
    return kp * np_ * s.itemsize


def _packed_w_bytes(s: OpSpec) -> float:
    """Compressed weight stream: values + bitmask (62.5% of dense INT8 at
    B=8, k=4); ``bits=4`` halves the values term and adds the groupwise
    f32 scale plane (the per-shard planes under a TP split)."""
    _, k, n = _shard_dims(s)
    nb = max(k // max(s.block, 1), 1)
    if s.bits == 4 and s.group > 0:
        return (nb * s.nnz * n * 0.5 + nb * n * _MASK_BYTES
                + max(k // s.group, 1) * n * 4.0)
    return nb * s.nnz * n * s.vals_itemsize + nb * n * _MASK_BYTES


def _xla_w_bytes(s: OpSpec) -> float:
    _, k, n = _shard_dims(s)
    if s.packed:
        # decompress: read compressed, write + re-read dense
        return _packed_w_bytes(s) + 2.0 * k * n * s.itemsize
    return float(k) * n * s.itemsize


def _mm_xla_cost(s: OpSpec) -> Tuple[float, float]:
    m, k, n = _shard_dims(s)
    flops = 2.0 * m * k * n
    nbytes = m * k * s.itemsize + m * n * s.out_itemsize + _xla_w_bytes(s)
    # every unfused epilogue op re-reads + re-writes the [M, N] output
    nbytes += 2.0 * m * n * s.out_itemsize * s.epilogue_ops
    return flops, nbytes


def _mm_kernel_cost(s: OpSpec, *, skinny: bool, dbb: bool
                    ) -> Tuple[float, float]:
    mp, kp, np_ = _mm_dims(s, skinny)
    w = _packed_w_bytes(s) if dbb else _dense_w_bytes(s, kp, np_)
    return (2.0 * mp * kp * np_,
            mp * kp * s.itemsize + w + mp * np_ * s.out_itemsize)


def _default_tiles(ho: int, wo: int) -> Tuple[int, int]:
    """The reference's conv tile: th rows so the M tile th·Wo lands near
    128; bn one 128-lane tile. The conv costs read it."""
    th = max(1, min(ho, -(-128 // max(wo, 1))))
    return th, 128


def _conv_padded_geom(s: OpSpec) -> Tuple[int, int, int, int, int]:
    from repro_torch.kernels.conv_gemm.ref import out_spatial
    b, h, w_dim, c, kh, kw, stride = s.conv_geom[:7]
    pad = s.conv_geom[7] if len(s.conv_geom) > 7 else "SAME"
    ho, _, _ = out_spatial(h, kh, stride, pad)
    wo, _, _ = out_spatial(w_dim, kw, stride, pad)
    th, _ = _default_tiles(ho, wo)
    hp = (_round_up(max(ho, 1), th) - 1) * stride + kh
    wp = (wo - 1) * stride + kw
    return ho, wo, th, hp, wp


def _conv_kernel_cost(s: OpSpec, dbb: bool) -> Tuple[float, float]:
    kp, np_ = _round_up(s.k, 128), _round_up(s.n, 128)
    w_bytes = _packed_w_bytes(s) if dbb else kp * np_ * s.itemsize
    if len(s.conv_geom) < 7:
        # no geometry (the guard refuses the op): the implied GEMM's reads
        img_bytes = float(s.m) * s.k * s.itemsize
    else:
        _, _, _, hp, wp = _conv_padded_geom(s)
        img_bytes = s.conv_geom[0] * hp * wp * s.conv_geom[3] * s.itemsize
    return (2.0 * s.m * kp * np_,
            img_bytes + w_bytes + s.m * np_ * s.out_itemsize)


def _conv_xla_cost(s: OpSpec) -> Tuple[float, float]:
    w_bytes = (_packed_w_bytes(s) + s.k * s.n * s.itemsize
               if s.packed else s.k * s.n * s.itemsize)
    # the explicit path gathers the image, then writes AND re-reads the
    # materialised [M, K] im2col
    nbytes = (3.0 * s.m * s.k * s.itemsize + w_bytes
              + s.m * s.n * s.out_itemsize
              + 2.0 * s.m * s.n * s.out_itemsize * s.epilogue_ops)
    return 2.0 * s.m * s.k * s.n, nbytes


def _attn_cost(s: OpSpec, score_passes: float) -> Tuple[float, float]:
    """Per-row (t, s) work times the padded batch's rows; a packed spec
    carries the whole batch's tokens in m with batch 1."""
    t, n, d, b = s.m, s.n, s.k, max(s.batch, 1)
    return (4.0 * b * t * n * d,
            b * ((2 * t * d + 2 * n * d) * s.itemsize
                 + score_passes * t * n * _F32))


def _decode_cost(s: OpSpec, score_bytes: float) -> Tuple[float, float]:
    return (4.0 * s.m * s.n * s.k,
            (s.m * s.k + 2 * s.n * s.k) * s.itemsize + score_bytes)


# operations per logit of the sampling epilogue: penalty selects, 3 hash
# mixes of ~4 ops each, the Gumbel transform's log / log / scale
_SAMPLE_EPI_OPS = 16.0


def _hs_fused_cost(s: OpSpec) -> Tuple[float, float]:
    mp, kp, np_ = _mm_dims(s, skinny=True)
    # resident rows, streamed weight and counts; the logits never leave
    # the chip, the output is the [M] (score, id) pair
    return (2.0 * mp * kp * np_ + _SAMPLE_EPI_OPS * mp * np_,
            mp * kp * s.itemsize + kp * np_ * s.itemsize + mp * np_ * _F32
            + 2.0 * mp * _F32)


def _hs_xla_cost(s: OpSpec) -> Tuple[float, float]:
    m, k, n = _shard_dims(s)
    # the GEMV writes [M, N] logits, the sampler re-reads them for the
    # penalty pass and the score / argmax pass, and reads the counts
    nbytes = (m * k * s.itemsize + k * n * s.itemsize + m * n * _F32
              + 4.0 * m * n * _F32 + m * n * _F32)
    if s.sample_tt:
        # sort + softmax / cumsum of the sorted row: ~2 more round trips
        nbytes += 4.0 * m * n * _F32
    return 2.0 * m * k * n + _SAMPLE_EPI_OPS * m * n, nbytes


def _mm_kernel(skinny: bool, dbb: bool):
    return lambda s: _mm_kernel_cost(s, skinny=skinny, dbb=dbb)


def _mm_dense_wbytes(skinny: bool):
    return lambda s: _dense_w_bytes(s, *_mm_dims(s, skinny)[1:])


# each domain's routes (selection is by cost, so the order is for reading)
ROUTES: Dict[str, Tuple[Route, ...]] = {
    "matmul": (
        Route("skinny_dbb", _guard_skinny_dbb, 0, _mm_kernel(True, True),
              wbytes=_packed_w_bytes),
        Route("skinny_dbb_w4", _guard_skinny_dbb_w4, 0,
              _mm_kernel(True, True), wbytes=_packed_w_bytes),
        Route("dbb_packed", _guard_dbb_packed, 1, _mm_kernel(False, True),
              wbytes=_packed_w_bytes),
        Route("dbb_packed_w4", _guard_dbb_packed_w4, 1,
              _mm_kernel(False, True), wbytes=_packed_w_bytes),
        Route("skinny_sta", _guard_skinny_sta, 0, _mm_kernel(True, False),
              wbytes=_mm_dense_wbytes(True)),
        Route("sta", _guard_sta, 1, _mm_kernel(False, False),
              wbytes=_mm_dense_wbytes(False)),
        Route("xla", _always, 9, _mm_xla_cost, wbytes=_xla_w_bytes)),
    "conv": (
        Route("conv_dbb", _guard_conv_dbb, 0,
              lambda s: _conv_kernel_cost(s, dbb=True)),
        Route("conv_sta", _guard_conv_sta, 0,
              lambda s: _conv_kernel_cost(s, dbb=False)),
        Route("conv_xla", _always, 9, _conv_xla_cost)),
    "attention": (
        Route("attn_flash", _guard_attn_flash, 0,
              lambda s: _attn_cost(s, 0.0)),
        Route("attn_packed_flash", _guard_attn_packed_flash, 0,
              lambda s: _attn_cost(s, 0.0)),
        # one recomputed score-tile pass; deferred up to 2 chunks, where
        # the per-chunk loop costs more than naive's extra score traffic
        Route("attn_chunked", _guard_attn_chunked, 1,
              lambda s: _attn_cost(s, 1.0),
              defer=lambda s: s.n <= 2 * s.chunk),
        Route("attn_naive", _guard_attn_naive, 2,
              lambda s: _attn_cost(s, 2.0)),
        Route("attn_packed_ref", _guard_attn_packed_ref, 3,
              lambda s: _attn_cost(s, 2.0))),
    "attn_decode": (
        Route("attn_decode_flash", _guard_decode_flash, 0,
              lambda s: _decode_cost(s, 0.0)),
        # the plain route materialises [B, H, G, 1, Smax] scores
        Route("attn_decode_xla", _always, 1,
              lambda s: _decode_cost(s, 2.0 * s.m * s.n * _F32))),
    "head_sample": (
        Route("head_sample_fused", _guard_head_sample_fused, 0,
              _hs_fused_cost),
        Route("head_sample_xla", _always, 9, _hs_xla_cost)),
}


_ROUTE_COST = {(domain, r.name): r.cost
               for domain, table in ROUTES.items() for r in table}


def _counted(spec: OpSpec, route: str, instances: int = 1):
    """The extent of one front-door call that runs ``route`` on ``spec``
    (`roofline.counts.route_call`): a live step counter adds the route's
    costed flops and bytes ``instances`` times — an attention spec costs
    one query head, a decode spec one (row, KV head) pair — and counts no
    aten op inside."""
    def cost():
        flops, nbytes = _ROUTE_COST[(spec.domain, route)](spec)
        return instances * flops, instances * nbytes
    return route_call(route, cost)


# ---------------------------------------------------------------------------
# route family predicates and overrides
# ---------------------------------------------------------------------------

def pallas_route_active(cfg) -> bool:
    """The fused kernel route family: ``gemm_impl == "pallas"``."""
    return cfg is not None and cfg.gemm_impl == "pallas"


def flash_backend_active(cfg) -> bool:
    """Whether the fused attention kernels are the selected backend:
    ``attn_impl="flash"``, or "auto" with the fused route family."""
    if cfg.attn_impl == "flash":
        return True
    return cfg.attn_impl == "auto" and pallas_route_active(cfg)


def routes_from_cfg(cfg) -> Dict[str, str]:
    if cfg is None or not cfg.kernel_routes:
        return {}
    return dict(cfg.kernel_routes)


_warned: set = set()


def _warn_once(key, msg: str) -> None:
    if key not in _warned:
        _warned.add(key)
        warnings.warn(msg, stacklevel=4)


def forced_route(domain: str, cfg_routes: Optional[Dict[str, str]] = None
                 ) -> Optional[str]:
    """The override for ``domain``: ``REPRO_FORCE_ROUTE`` > ``kernel_routes``
    > None (auto)."""
    env = os.environ.get(FORCE_ROUTE_ENV, "").strip()
    if env:
        if "=" in env:
            for pair in env.split(","):
                d, _, r = pair.partition("=")
                if d.strip() == domain and r.strip():
                    return r.strip()
        elif any(env == r.name for r in ROUTES[domain]):
            return env
        elif not any(env == r.name for table in ROUTES.values()
                     for r in table):
            _warn_once(("*", env), f"{FORCE_ROUTE_ENV}={env!r} names no "
                       "route of this port — ignoring the override")
    if cfg_routes:
        return cfg_routes.get(domain)
    return None


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------

def _collective_term(spec: OpSpec, hw: Hardware) -> Tuple[float, float]:
    """(bytes, seconds) of a TP-split op's boundary collective: its [M, N]
    output over `collective_bw` (0 at tp=1 or with no collective)."""
    if spec.tp <= 1 or not spec.collective:
        return 0.0, 0.0
    payload = float(spec.m) * spec.n * spec.out_itemsize
    return payload, payload / collective_bw(spec.collective, hw)


def _decide(route: Route, spec: OpSpec, hw: Hardware) -> RouteDecision:
    reason = route.guard(spec)
    flops, nbytes = route.cost(spec)
    compute_s, memory_s = flops / hw.peak_flops, nbytes / hw.hbm_bw
    # the collective is the same for every route of a shard; it is a third
    # pipe under max(), as the boundary all-reduce runs beside the
    # epilogue's stores in the reference's overlapped schedule
    coll_b, coll_s = _collective_term(spec, hw)
    return RouteDecision(
        name=route.name, applicable=reason == "", reason=reason,
        flops=flops, bytes=nbytes, compute_s=compute_s, memory_s=memory_s,
        cost_s=max(compute_s, memory_s, coll_s), priority=route.priority,
        deferred=bool(route.defer and route.defer(spec)),
        weight_bytes=float(route.wbytes(spec)) if route.wbytes else 0.0,
        collective_bytes=coll_b, collective_s=coll_s, tp=spec.tp)


def _rank(spec: OpSpec, cfg_routes: Optional[Dict[str, str]],
          hw: Hardware) -> Tuple[str, List[RouteDecision]]:
    """(chosen route, the ranked decisions): a forced route whose guard
    passes, else the cheapest applicable route that does not defer (any
    applicable one if all defer), priority breaking ties within
    ``COST_TIE_RTOL``."""
    decisions = [_decide(r, spec, hw) for r in ROUTES[spec.domain]]
    by_name = {d.name: d for d in decisions}
    chosen = None
    forced = forced_route(spec.domain, cfg_routes)
    if forced is not None:
        dec = by_name.get(forced)
        if dec is None:
            _warn_once((spec.domain, forced),
                       f"forced route {forced!r} for domain {spec.domain!r} "
                       "is not ported — falling back to auto dispatch")
        elif not dec.applicable:
            _warn_once((spec.domain, forced),
                       f"forced route {forced!r} for domain {spec.domain!r} "
                       f"not applicable ({dec.reason}) — falling back to "
                       "auto dispatch")
        else:
            dec.forced = True
            chosen = forced
    if chosen is None:
        live = [d for d in decisions if d.applicable]
        cands = [d for d in live if not d.deferred] or live
        best = min(d.cost_s for d in cands)
        tied = [d for d in cands if d.cost_s <= best * (1.0 + COST_TIE_RTOL)]
        chosen = min(tied, key=lambda d: (d.priority, d.cost_s, d.name)).name
    by_name[chosen].chosen = True
    decisions.sort(key=lambda d: (not d.chosen, not d.applicable, d.cost_s,
                                  d.priority))
    return chosen, decisions


def select(spec: OpSpec, cfg_routes: Optional[Dict[str, str]] = None,
           hw: Hardware = HW_H100) -> Tuple[str, Dict[str, str]]:
    """(chosen route, {route: rejection reason or ""}) for ``spec``."""
    name, decisions = _rank(spec, cfg_routes, hw)
    return name, {d.name: d.reason for d in decisions}


def explain(domain: str = "matmul", *, m: int, k: int, n: int,
            dtype=torch.float32, packed: bool = False, cfg=None,
            pallas: Optional[bool] = None, hw: Hardware = HW_H100,
            tp: Optional[int] = None, collective: str = "",
            **spec_kw) -> List[RouteDecision]:
    """Ranked route table for a hypothetical op, costed on ``hw``: the
    chosen route first, then the applicable ones by cost. ``dtype`` (a
    torch dtype or its name) is the operand's; ``pallas=None`` derives the
    route family from ``cfg`` (off without one). Other fields of `OpSpec`
    pass through ``spec_kw``: give ``epilogue_ops`` (the bias / scale /
    act passes the real call fuses) when the table describes an actual
    dispatch — near the tie window the plain route's unfused epilogue
    passes can decide the winner.

    ``tp=None`` takes the model-axis size of the live mesh (1 without one,
    and 1 inside a TP shard body, where the dims given are already
    local). With ``tp > 1`` the dims are GLOBAL and the table costs the
    per-shard instance (K split when ``collective`` names a reduction
    boundary, N split otherwise) with the collective's bytes per route;
    `format_table` heads it with the mesh it was costed for."""
    from repro_torch.dist.mesh_ctx import current_mesh, shard_tp
    mesh = current_mesh()
    mesh_desc = ""
    if tp is None:
        tp = 1
        if shard_tp() > 0:
            mesh_desc = f"TP shard body (tp={shard_tp()}, local dims)"
        elif mesh is not None and "model" in mesh.axis_names:
            tp = int(mesh.shape["model"])
    if tp > 1 and not mesh_desc:
        mesh_desc = (str(dict(mesh.shape)) if mesh is not None
                     else f"(model={tp})")
    if pallas is None:
        pallas = pallas_route_active(cfg)
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    floating = dt.is_floating_point
    spec_kw.setdefault("out_itemsize", dt.itemsize)
    if domain in ("attention", "attn_decode", "head_sample"):
        spec_kw.setdefault("float_ok", floating)
    else:
        spec_kw.setdefault("float_ok", floating or dt == torch.int8)
        spec_kw.setdefault("x_int8", dt == torch.int8)
    if domain in ("attention", "attn_decode"):
        spec_kw.setdefault("flash_active", flash_backend_active(cfg)
                           if cfg is not None else bool(pallas))
    if domain == "attention":
        spec_kw.setdefault("chunk", cfg.attn_chunk if cfg is not None
                           else 1024)
    spec = OpSpec(domain=domain, m=m, k=k, n=n, itemsize=dt.itemsize,
                  packed=packed, pallas=bool(pallas), tp=int(tp),
                  collective=collective, **spec_kw)
    decisions = _rank(spec, routes_from_cfg(cfg), hw)[1]
    for d in decisions:
        d.mesh = mesh_desc
    return decisions


def format_table(decisions: List[RouteDecision]) -> str:
    """Fixed-width rendering of an `explain` table for logs, in the
    reference's columns (``coll``: the TP collective's bytes), headed by
    the mesh a TP table was costed for."""
    lines = []
    if decisions and (decisions[0].mesh or decisions[0].tp > 1):
        lines.append(f"costed for mesh {decisions[0].mesh or '?'} "
                     f"(model-axis tp={decisions[0].tp})")
    lines.append(f"{'route':<18} {'ok':<3} {'cost':>10} {'flops':>10} "
                 f"{'bytes':>10} {'wbytes':>9} {'coll':>9}  note")
    for d in decisions:
        mark = "*" if d.chosen else ("f" if d.forced else "")
        note = d.reason if not d.applicable else (
            "deferred" if d.deferred and not d.chosen else "")
        wb = f"{d.weight_bytes:>9.3g}" if d.weight_bytes else f"{'-':>9}"
        lines.append(
            f"{d.name:<18} {('y' + mark) if d.applicable else 'n':<3} "
            f"{d.cost_s * 1e6:>9.2f}u {d.flops:>10.3g} {d.bytes:>10.3g} "
            f"{wb} {d.collective_bytes:>9.3g}  {note}")
    return "\n".join(lines)


# the routes that launch a hand-written kernel (every other route is plain
# PyTorch and differentiates)
KERNEL_ROUTES = frozenset((
    "sta", "skinny_sta", "dbb_packed", "skinny_dbb", "dbb_packed_w4",
    "skinny_dbb_w4", "conv_sta", "conv_dbb", "attn_flash",
    "attn_packed_flash", "attn_decode_flash", "head_sample_fused"))


def no_autograd(route: str, *operands) -> None:
    """Raise if kernel route ``route`` would run while autograd records and
    an operand requires grad: the kernels' wrappers return tensors without
    a ``grad_fn``, so the operands' gradients would silently never come
    (on the CPU the plain versions would differentiate and hide it)."""
    if route not in KERNEL_ROUTES or not torch.is_grad_enabled():
        return
    if any(isinstance(t, torch.Tensor) and t.requires_grad
           for t in operands):
        raise RuntimeError(
            f"kernel route {route!r} would run on operands that require "
            "grad: the CUDA kernels have no backward. Differentiate through "
            "the plain routes (gemm_impl='xla' and a plain attn_impl, as "
            "train.loop.make_loss_fn does) or run under torch.no_grad()")


def _epilogue_ops(bias, scale, act: str) -> int:
    return int(bias is not None) + int(scale is not None) + int(act != "none")


# ---------------------------------------------------------------------------
# front doors
# ---------------------------------------------------------------------------

def matmul(x: torch.Tensor, w, bias=None, scale=None, *, act: str = "none",
           out_dtype: Optional[torch.dtype] = None, cfg=None,
           pallas: Optional[bool] = None, dense_fused: bool = True,
           gemv: bool = False) -> torch.Tensor:
    """``act(scale * (x @ w) + bias)`` for a dense ``[K, N]`` tensor or a
    2-D `DbbWeight`, through the chosen route. ``pallas=None`` derives the
    route family from ``cfg``; ``gemv`` marks the decode head GEMV, which
    never takes the M-tiled ``sta`` route."""
    packed = isinstance(w, DbbWeight)
    if pallas is None:
        pallas = pallas_route_active(cfg)
    k_dim = x.shape[-1]
    m = x.numel() // max(k_dim, 1)
    k_w, n = (w.k_dim, w.n_dim) if packed else tuple(w.shape)
    if k_w != k_dim:
        raise ValueError(f"x {tuple(x.shape)} against weight K={k_w}")
    spec = OpSpec(
        domain="matmul", m=m, k=k_dim, n=n, itemsize=x.element_size(),
        out_itemsize=(out_dtype or x.dtype).itemsize, packed=packed,
        block=w.block if packed else 8, nnz=w.nnz if packed else 4,
        vals_itemsize=w.values.element_size() if packed else 1,
        bits=w.bits if packed else 8, group=w.group if packed else 0,
        epilogue_ops=_epilogue_ops(bias, None if packed else scale, act),
        pallas=bool(pallas), dense_fused=dense_fused, gemv=gemv,
        float_ok=x.dtype in OPERAND_DTYPES, x_int8=x.dtype == torch.int8,
        int8_values=packed and w.values.dtype == torch.int8)
    name, _ = select(spec, routes_from_cfg(cfg))
    no_autograd(name, x, w, bias, scale)
    with _counted(spec, name):
        return _matmul_route(name, x, w, bias, scale, act, out_dtype)


def _matmul_route(name: str, x, w, bias, scale, act: str, out_dtype):
    """Run `matmul` on its chosen route."""
    if name == "sta":
        from repro_torch.kernels.sta_gemm.ops import sta_gemm
        return sta_gemm(x.contiguous(), w.to(x.dtype).contiguous(), bias,
                        scale, act=act, out_dtype=out_dtype)
    if name == "skinny_sta":
        from repro_torch.kernels.skinny.ops import sta_gemm_skinny
        return sta_gemm_skinny(x, w.to(x.dtype).contiguous(), bias, scale,
                               act=act, out_dtype=out_dtype)
    if name in ("dbb_packed", "skinny_dbb", "dbb_packed_w4",
                "skinny_dbb_w4"):
        if scale is not None:
            # fold a caller scale into the packed weight's scale plane: the
            # epilogue's [N] scale at bits=8, the [K/G, N] group scales at
            # w4 (they broadcast against [N]; products, so folding is exact
            # up to one f32 rounding)
            s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
            w = dataclasses.replace(
                w, scale=s if w.scale is None else w.scale * s)
        if name.startswith("skinny_dbb"):
            from repro_torch.kernels.skinny.ops import dbb_gemm_skinny as fn
        else:
            from repro_torch.kernels.dbb_gemm.ops import dbb_gemm as fn
        w4 = w.bits == 4
        plane = dict(bits=4, group=w.group, gscale=w.scale.contiguous()) \
            if w4 else {}
        return fn(x, w.values, w.bitmask, bias, None if w4 else w.scale,
                  act=act, block=w.block, nnz=w.nnz, out_dtype=out_dtype,
                  **plane)
    return _matmul_xla(x, w, bias, scale, act=act, out_dtype=out_dtype)


def _matmul_xla(x, w, bias, scale, *, act, out_dtype):
    """The plain route: a packed weight is decompressed transiently, then
    one torch matmul in x's dtype with the epilogue as separate ops (the
    storage-dtype bias add of the reference's XLA route). int8 activations
    run the kernels' exact datapath instead: an int32 sum, then the fused
    epilogue's arithmetic (an INT8-valued leaf's scale folds into the
    epilogue's, its raw int8 values are the operand). A w4 leaf dequantizes
    to f32 first (its scales vary along K); int8 activations then upcast,
    as in the reference."""
    from repro_torch.kernels.common import gemm_acc
    from repro_torch.kernels.epilogue import (Epilogue, apply_act,
                                              apply_epilogue,
                                              default_out_dtype)
    if isinstance(w, DbbWeight):
        from repro_torch.core.dbb_linear import decompress
        if w.bits == 4:
            w = decompress(w)                     # f32, dequantized
            if not x.is_floating_point():
                x = x.to(w.dtype)
        elif x.dtype == torch.int8 and w.scale is not None:
            # dequantizing to f32 and casting back to int8 would destroy
            # the weights: keep the int8 values, scale in the epilogue
            scale = (w.scale if scale is None else torch.as_tensor(
                scale, dtype=torch.float32, device=x.device) * w.scale)
            w = decompress(dataclasses.replace(w, scale=None))
        else:
            w = decompress(w, dtype=x.dtype)      # scale already applied
    if x.dtype == torch.int8:
        if scale is not None:
            scale = torch.as_tensor(scale, dtype=torch.float32,
                                    device=x.device)
        spec = Epilogue(act=act, has_bias=bias is not None,
                        has_scale=scale is not None)
        return apply_epilogue(gemm_acc(x, w.to(torch.int8)), spec,
                              out_dtype or default_out_dtype(x.dtype, spec),
                              bias=bias, scale=scale)
    y = x @ w.to(x.dtype)
    if scale is not None:
        y = (y.float() * torch.as_tensor(scale, dtype=torch.float32,
                                         device=y.device)).to(y.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    y = apply_act(y, act)
    return y.to(out_dtype) if out_dtype is not None else y


def conv(x: torch.Tensor, w, bias=None, scale=None, *, kh: int, kw: int,
         stride: int = 1, padding: str = "SAME", act: str = "none",
         out_dtype: Optional[torch.dtype] = None, cfg=None,
         use_kernel: bool = True) -> torch.Tensor:
    """Conv as GEMM: ``act(scale · conv2d(x, w) + bias)`` for NHWC ``x``
    and a dense ``[kh·kw·C, N]`` weight or a packed `DbbWeight` →
    ``[B, Ho, Wo, N]``. ``use_kernel=False`` pins the explicit im2col
    route (``conv_xla``). The conv kernels stream the bits=8 plane only, so
    a w4 leaf is decompressed once to x's dtype and takes the dense
    routes, as in the reference. ``scale`` (the conv wrappers' epilogue
    scale, e.g. an int8 image's dequant x_s·w_s) folds into a packed
    weight's scale plane, as in `matmul`."""
    from repro_torch.core.dbb import unpack_dbb
    from repro_torch.kernels.conv_gemm import ops as C
    from repro_torch.kernels.conv_gemm import ref as R
    packed = isinstance(w, DbbWeight)
    if packed and w.bits == 4:
        w = unpack_dbb(w).to(x.dtype)
        packed = False
    if packed and scale is not None:
        s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
        w = dataclasses.replace(w, scale=s if w.scale is None
                                else w.scale * s)
        scale = None
    b, h, w_dim, c = x.shape
    ho, _, _ = R.out_spatial(h, kh, stride, padding)
    wo, _, _ = R.out_spatial(w_dim, kw, stride, padding)
    spec = OpSpec(
        domain="conv", m=b * ho * wo, k=kh * kw * c,
        n=w.n_dim if packed else w.shape[1], itemsize=x.element_size(),
        out_itemsize=x.element_size(), packed=packed,
        block=w.block if packed else 8, nnz=w.nnz if packed else 4,
        vals_itemsize=w.values.element_size() if packed else 1,
        epilogue_ops=_epilogue_ops(bias, scale, act),
        pallas=use_kernel, float_ok=x.dtype in OPERAND_DTYPES,
        x_int8=x.dtype == torch.int8,
        int8_values=packed and w.values.dtype == torch.int8,
        conv_geom=(b, h, w_dim, c, kh, kw, stride, padding))
    name, _ = select(spec, routes_from_cfg(cfg))
    no_autograd(name, x, w, bias, scale)
    geom = dict(kh=kh, kw=kw, stride=stride, padding=padding, act=act,
                out_dtype=out_dtype)
    with _counted(spec, name):
        if name == "conv_dbb":
            return C.conv_gemm_packed(x.contiguous(), w, bias, **geom)
        if name == "conv_sta":
            return C.conv_gemm(x.contiguous(), w.to(x.dtype).contiguous(),
                               bias, scale, **geom)
        if packed:
            return R.conv_gemm_dbb_ref(x, w.values, w.bitmask, bias,
                                       w.scale, block=w.block, **geom)
        return R.conv_gemm_ref(x, w, bias, scale, **geom)


_ATTN_IMPL_ROUTE = {"flash": "attn_flash", "chunked": "attn_chunked",
                    "naive": "attn_naive"}
# packed calls have no chunked implementation: anything but flash drops to
# the quadratic packed version
_PACKED_IMPL_ROUTE = {"flash": "attn_packed_flash",
                      "chunked": "attn_packed_ref",
                      "naive": "attn_packed_ref"}
# a kernel_routes pin on a padded route carries its intent (kernel or
# plain) to the packed variant
_ATTN_TO_PACKED = {"attn_flash": "attn_packed_flash",
                   "attn_chunked": "attn_packed_ref",
                   "attn_naive": "attn_packed_ref"}
# a continuation chunk (T != S, offset ladder) has no chunked route either
_CHUNK_IMPL_ROUTE = {"flash": "attn_flash", "chunked": "attn_naive",
                     "naive": "attn_naive"}


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              positions: torch.Tensor, cfg, ragged: bool = False
              ) -> torch.Tensor:
    """Full-sequence (prefill) attention on projected q/k/v in model
    layout, through the flash kernel, the chunked route or the naive route.
    ``positions``: ``arange(S) - start`` ladders, shared [1, S] or per row
    [B, S] (``ragged``); the flash route reads ``start`` off their first
    entry."""
    from repro_torch.models import attention as A
    spec = OpSpec(domain="attention", m=q.shape[1], k=q.shape[-1],
                  n=k.shape[1], itemsize=q.element_size(),
                  out_itemsize=q.element_size(), ragged=ragged,
                  chunk=cfg.attn_chunk,
                  batch=q.shape[0], flash_active=flash_backend_active(cfg),
                  float_ok=q.dtype in FLOAT_DTYPES)
    cfg_routes = dict(routes_from_cfg(cfg))
    if cfg.attn_impl in _ATTN_IMPL_ROUTE:
        cfg_routes.setdefault("attention", _ATTN_IMPL_ROUTE[cfg.attn_impl])
    name, _ = select(spec, cfg_routes)
    no_autograd(name, q, k, v)
    with _counted(spec, name, q.shape[2]):
        if name == "attn_flash":
            from repro_torch.kernels.attn.ops import flash_attention
            start = (-positions[..., 0]).to(torch.int32).expand(q.shape[0])
            return flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), start.contiguous(),
                                   window=cfg.sliding_window,
                                   softcap=cfg.attn_logit_softcap)
        if ragged:
            return A._naive_attention(q, k, v, positions, positions, cfg)
        if name == "attn_chunked":
            return A._chunked_causal_attention(q, k, v, cfg, cfg.attn_chunk)
        pos1d = positions[0] if positions.ndim > 1 else positions
        return A._naive_attention(q, k, v, pos1d, pos1d, cfg)


def packed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     seg_ids: torch.Tensor, cfg) -> torch.Tensor:
    """Packed (cu_seqlens) prefill attention: ``q/k/v [1, T, H, D]`` with T
    the ragged batch's total token count and ``seg_ids [T]`` the owning
    request of each position. Returns ``[1, T, Hq, D]``."""
    from repro_torch.kernels.attn.ops import packed_flash_attention
    from repro_torch.kernels.attn.ref import packed_prefill_ref
    t, d = q.shape[1], q.shape[-1]
    spec = OpSpec(domain="attention", m=t, k=d, n=t,
                  itemsize=q.element_size(), out_itemsize=q.element_size(),
                  packed_seq=True, chunk=cfg.attn_chunk,
                  flash_active=flash_backend_active(cfg),
                  float_ok=q.dtype in FLOAT_DTYPES)
    cfg_routes = dict(routes_from_cfg(cfg))
    if cfg_routes.get("attention") in _ATTN_TO_PACKED:
        cfg_routes["attention"] = _ATTN_TO_PACKED[cfg_routes["attention"]]
    if cfg.attn_impl in _PACKED_IMPL_ROUTE:
        cfg_routes.setdefault("attention", _PACKED_IMPL_ROUTE[cfg.attn_impl])
    name, _ = select(spec, cfg_routes)
    no_autograd(name, q, k, v)
    seg = seg_ids.to(torch.int32).reshape(t).contiguous()
    kw = dict(window=cfg.sliding_window, softcap=cfg.attn_logit_softcap)
    with _counted(spec, name, q.shape[2]):
        if name == "attn_packed_flash":
            return packed_flash_attention(
                q[0].contiguous(), k[0].contiguous(), v[0].contiguous(), seg,
                **kw)[None]
        o = packed_prefill_ref(q[0].transpose(0, 1), k[0].transpose(0, 1),
                               v[0].transpose(0, 1), seg,
                               sm_scale=1.0 / d ** 0.5, **kw)
        return o.transpose(0, 1)[None]


def _chunk_select(cfg, *, t: int, s: int, d: int, itemsize: int = 4,
                  floating: bool = True) -> Tuple[OpSpec, str]:
    spec = OpSpec(domain="attention", m=t, k=d, n=s, itemsize=itemsize,
                  out_itemsize=itemsize, ragged=True, chunk=cfg.attn_chunk,
                  flash_active=flash_backend_active(cfg), float_ok=floating)
    cfg_routes = dict(routes_from_cfg(cfg))
    if cfg_routes.get("attention") == "attn_chunked":
        cfg_routes["attention"] = "attn_naive"
    if cfg.attn_impl in _CHUNK_IMPL_ROUTE:
        cfg_routes.setdefault("attention", _CHUNK_IMPL_ROUTE[cfg.attn_impl])
    return spec, select(spec, cfg_routes)[0]


def chunk_attention_route(cfg, *, t: int, s: int, d: int,
                          itemsize: int = 4, floating: bool = True) -> str:
    """Route of a chunked-prefill continuation: T chunk queries at an
    absolute offset against one row's S cache slots. Flash takes it
    through ``q_offset``; everything else takes the naive mask (a pin to
    the chunked route too: it has no continuation)."""
    return _chunk_select(cfg, t=t, s=s, d=d, itemsize=itemsize,
                         floating=floating)[1]


@contextlib.contextmanager
def chunk_attention(cfg, *, heads: int, t: int, s: int, d: int,
                    itemsize: int = 4, floating: bool = True):
    """The front door of a chunked-prefill continuation over ``heads``
    query heads: yields `chunk_attention_route`'s route, and the block
    that runs it is one counted dispatcher call."""
    spec, name = _chunk_select(cfg, t=t, s=s, d=d, itemsize=itemsize,
                               floating=floating)
    with _counted(spec, name, heads):
        yield name


def _decode_spec(cfg, *, group: int, head_dim: int, page: int, smax: int,
                 itemsize: int, ring: bool, floating: bool) -> OpSpec:
    return OpSpec(domain="attn_decode", m=group, k=head_dim, n=smax,
                  itemsize=itemsize, out_itemsize=itemsize, page=page,
                  ring=ring, flash_active=flash_backend_active(cfg),
                  float_ok=floating)


def decode_attention_route(cfg, *, group: int, head_dim: int, page: int,
                           smax: int, itemsize: int = 4, ring: bool = False,
                           floating: bool = True) -> str:
    """Route of one-token decode attention (``attn_decode`` domain) on the
    contiguous cache; ``ring``: the cache is a ring buffer (zamba2's
    shared block), which the paged kernel does not take."""
    spec = _decode_spec(cfg, group=group, head_dim=head_dim, page=page,
                        smax=smax, itemsize=itemsize, ring=ring,
                        floating=floating)
    return select(spec, routes_from_cfg(cfg))[0]


@contextlib.contextmanager
def attn_decode(cfg, *, pairs: int, group: int, head_dim: int, page: int,
                smax: int, itemsize: int = 4, ring: bool = False,
                floating: bool = True, paged: bool = False):
    """The front door of one-token decode attention over ``pairs`` (row,
    KV head) pairs: yields the route — `decode_attention_route`'s on the
    contiguous cache, ``attn_decode_flash`` on a paged pool (``paged``:
    the paged kernel runs on every route) — and the block that runs it is
    one counted dispatcher call."""
    spec = _decode_spec(cfg, group=group, head_dim=head_dim, page=page,
                        smax=smax, itemsize=itemsize, ring=ring,
                        floating=floating)
    name = ("attn_decode_flash" if paged
            else select(spec, routes_from_cfg(cfg))[0])
    with _counted(spec, name, pairs):
        yield name


def head_sample(h: torch.Tensor, w_head: torch.Tensor, counts: torch.Tensor,
                temp, rep, pres, freq, seed, step, *, top_k=None,
                top_p=None, use_tt: bool = False, base: int = 0, cfg=None,
                pallas: Optional[bool] = None, route: Optional[str] = None,
                return_score: bool = False):
    """The sampling head: one token per hidden row ``h [B, K]`` against the
    head ``w_head [K, N]``, with the penalties read from ``counts [B, N]``
    and counter-hash Gumbel noise keyed by per-row ``(seed, step)``.

    ``use_tt`` (some row uses top-k / top-p) sends the head to the plain
    sampler over materialised logits (the masks are order statistics of
    the whole row). ``base`` offsets the noise to global vocab ids.
    ``route`` names a route outright (ValueError if its guard refuses);
    ``return_score=True`` also returns the winning score."""
    b, k_dim = h.shape
    k_w, n = w_head.shape
    if k_dim != k_w:
        raise ValueError(f"h {tuple(h.shape)} against head "
                         f"{tuple(w_head.shape)}")
    if pallas is None:
        pallas = pallas_route_active(cfg)
    spec = OpSpec(domain="head_sample", m=b, k=k_dim, n=n,
                  pallas=bool(pallas), gemv=True, sample_tt=bool(use_tt),
                  float_ok=h.dtype in FLOAT_DTYPES)
    if route is not None:
        guard = {r.name: r.guard for r in ROUTES["head_sample"]}.get(route)
        reason = "not a head_sample route" if guard is None else guard(spec)
        if reason:
            raise ValueError(f"route {route!r} rejected this op: {reason}")
        name = route
    else:
        name, _ = select(spec, routes_from_cfg(cfg))
    no_autograd(name, h, w_head)
    rows = dict(temp=temp, rep=rep, pres=pres, freq=freq, seed=seed,
                step=step)
    with _counted(spec, name):
        if name == "head_sample_fused":
            from repro_torch.kernels.sample.ops import head_sample_fused
            score, tok = head_sample_fused(
                h.float().contiguous(), w_head.float().contiguous(), counts,
                base=base, **rows)
        else:
            from repro_torch.kernels.sample.ref import sample_argmax
            logits = matmul(h.float(), w_head.float(), cfg=cfg,
                            pallas=bool(pallas), gemv=True)
            score, tok = sample_argmax(logits, counts, base=base,
                                       top_k=top_k, top_p=top_p,
                                       use_tt=use_tt, **rows)
    return (score, tok) if return_score else tok
