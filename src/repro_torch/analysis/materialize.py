"""Materialization lint: the paper's absence claims, proved per kernel route.

The memory story rests on what never exists as a whole tensor: the
``[B, H, T, S]`` attention scores, the dense ``[K, N]`` of a DBB weight,
the ``[M, K]`` im2col patch matrix, the ``[M, V]`` logits of the sampling
head and, in paged decode, the gathered contiguous ``[B, S, Hkv, D]`` K/V.

The reference proves them at trace time by walking a jaxpr. A PyTorch
program has no trace to walk, so this module runs the call under a
`TorchDispatchMode` walker that records the output of every aten op (a
view or an in-place result allocates nothing and is not recorded). On the
card the walker sees every tensor a kernel wrapper creates — its output,
its workspace, the small index vectors a front door builds — and nothing
inside a kernel, which allocates nothing (the launchers take every buffer
from the wrapper: csrc/common.cuh). Beside the walker, `device_peak` reads
the caching allocator's peak over the call. Each check holds both to two
sizes: the output plus the workspaces the wrapper allocates (by the
wrappers' own pure functions: `decode_workspace_elems`,
`skinny.workspace_elems`, `sample.workspace_elems`), each allocation rounded
up to the allocator's 512 bytes, and the dense size it must stay below.

Checks that run a kernel need a card; on the CPU they are reported as
skipped, never as passed. What runs here: the chunked attention route
stays below ``[B, Hq, T, S]``, and the positive controls show the walker
sees what it must — the naive route reaches the score tensor, the plain
DBB route builds ``[K, N]`` and the plain conv route builds ``[M, K]``.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, List, Sequence, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["Record", "iter_outputs", "max_intermediate_elems",
           "max_intermediate_bytes", "assert_no_intermediate_larger_than",
           "device_peak", "alloc_bytes", "Case", "MaterializationCheck",
           "run_checks", "repo_checks"]

ALLOC_ROUND = 512       # the CUDA caching allocator's block quantum (bytes)


@dataclasses.dataclass(frozen=True)
class Record:
    """One tensor an aten op returned."""
    op: str
    shape: Tuple[int, ...]
    elems: int
    nbytes: int


class _Walker(TorchDispatchMode):
    """Records the output of every aten op run under it, except views and
    results that alias an input (in-place and ``out=`` ops)."""

    def __init__(self):
        super().__init__()
        self.records: List[Record] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "is_view", False):
            return out
        ins = [t for t in tree_flatten((args, kwargs or {}))[0]
               if isinstance(t, torch.Tensor)]
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and not any(t is i for i in ins):
                n = t.numel()
                self.records.append(Record(str(func), tuple(t.shape), n,
                                           n * t.element_size()))
        return out


def iter_outputs(fn: Callable, *args) -> List[Record]:
    """Every tensor an aten op returned while ``fn(*args)`` ran (the call
    runs; nothing is traced)."""
    walker = _Walker()
    with torch.no_grad(), walker:
        fn(*args)
    return walker.records


def max_intermediate_elems(fn: Callable, *args) -> int:
    """Largest tensor (elements) any op returned while ``fn(*args)`` ran."""
    return max((r.elems for r in iter_outputs(fn, *args)), default=0)


def max_intermediate_bytes(fn: Callable, *args) -> int:
    """Largest tensor (bytes) any op returned while ``fn(*args)`` ran."""
    return max((r.nbytes for r in iter_outputs(fn, *args)), default=0)


def assert_no_intermediate_larger_than(fn: Callable, *args, max_elems: int,
                                       what: str = "") -> int:
    """Assert no tensor of ``fn(*args)`` reaches ``max_elems`` elements;
    returns the observed peak (so callers can also assert that a positive
    control does cross the limit)."""
    peak = max_intermediate_elems(fn, *args)
    label = what or getattr(fn, "__name__", "fn")
    assert peak < max_elems, (
        f"{label}: materialized a {peak}-element intermediate "
        f"(limit {max_elems})")
    return peak


def device_peak(fn: Callable, *args) -> Tuple[Any, int, int]:
    """``(fn(*args), allocated, requested)``: the caching allocator's peak
    over the call above what was allocated before it, as allocated bytes
    (the allocator's blocks: 512-byte multiples, a request over 1 MB may
    take a larger cached block whole) and as requested bytes (the sizes
    the tensors asked for; the allocated figure when this torch does not
    count them)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    s0 = torch.cuda.memory_stats()
    out = fn(*args)
    torch.cuda.synchronize()
    s1 = torch.cuda.memory_stats()
    alloc = (s1["allocated_bytes.all.peak"]
             - s0["allocated_bytes.all.current"])
    key = "requested_bytes.all"
    req = (s1[key + ".peak"] - s0[key + ".current"]
           if key + ".peak" in s1 else alloc)
    return out, int(alloc), int(req)


def alloc_bytes(nbytes: int) -> int:
    """One allocation of ``nbytes`` rounded up to the allocator's quantum."""
    return max(ALLOC_ROUND, -(-int(nbytes) // ALLOC_ROUND) * ALLOC_ROUND)


@dataclasses.dataclass
class Case:
    """One call a check runs: ``fn(*args)``.

    ``limit_elems``: no tensor of the call may reach this many elements
    (a positive control must). ``forbidden``: dense shapes (a weight's
    ``(K, N)``, the decode gather) no output may hold whole (`_is_dense`). ``allowed``: (label, bytes) of every
    allocation the call may make — its output, the wrapper's workspaces
    and the front door's index vectors; on the card the allocator's peak
    must stay within their sum, each rounded up to 512 bytes.
    ``dense_bytes``: the dense size the allocator's peak must stay below
    (0: no absence claim). ``launches``: `LAUNCHES` counters the call must
    move (the route really ran the kernel). ``decompress``: "none" (the
    call builds no dense copy of a packed weight: ``DECOMPRESS_STATS``
    stays flat) or "some" (a control: it must move)."""
    label: str
    fn: Callable
    args: tuple
    limit_elems: int = 0
    forbidden: Tuple[Tuple[int, ...], ...] = ()
    allowed: Tuple[Tuple[str, int], ...] = ()
    dense_bytes: int = 0
    launches: Tuple[str, ...] = ()
    decompress: str = ""
    control: bool = False


@dataclasses.dataclass(frozen=True)
class MaterializationCheck:
    """One absence claim (or a positive control): ``build(device)``
    returns its `Case` or cases, built lazily so that the repo's checks
    import models only when the pass runs. ``needs_card``: the call runs a
    kernel, so on the CPU the check is skipped, not passed."""
    name: str
    describe: str
    build: Callable[..., Union[Case, Sequence[Case]]]
    needs_card: bool = False


def _cases(chk: MaterializationCheck, device: torch.device) -> List[Case]:
    built = (chk.build(device) if inspect.signature(chk.build).parameters
             else chk.build())
    return [built] if isinstance(built, Case) else list(built)


def _is_dense(shape: Tuple[int, ...], dense: Tuple[int, ...]) -> bool:
    """Whether a tensor of ``shape`` holds a whole ``dense`` tensor: its
    last dim and its element count, however the leading rows are grouped
    (``[K, N]``, ``[1, K, N]``, ``[K/8, 8, N]``)."""
    numel = want = 1
    for s in shape:
        numel *= s
    for s in dense:
        want *= s
    return len(shape) >= 2 and shape[-1] == dense[-1] and numel == want


def _run_case(case: Case, device: torch.device) -> Dict[str, Any]:
    """Run one case (warmed once on the card: libraries load, split
    counts are checked); its figures."""
    from repro_torch.core.dbb_linear import DECOMPRESS_STATS
    from repro_torch.kernels.common import LAUNCHES
    card = device.type == "cuda"
    if card:
        case.fn(*case.args)
    launches0 = {k: LAUNCHES[k] for k in case.launches}
    calls0 = DECOMPRESS_STATS["calls"]
    walker = _Walker()
    alloc = req = None
    with torch.no_grad(), walker:
        if card:
            _, alloc, req = device_peak(case.fn, *case.args)
        else:
            case.fn(*case.args)
    big = max(walker.records, key=lambda r: r.elems, default=None)
    hits = sorted({r.shape for r in walker.records for dense in case.forbidden
                   if _is_dense(r.shape, dense)})
    return {
        "case": case.label,
        "peak_elems": big.elems if big else 0,
        "peak_bytes": max((r.nbytes for r in walker.records), default=0),
        "peak_op": f"{big.op} {list(big.shape)}" if big else "",
        "limit_elems": case.limit_elems,
        "forbidden_hits": [list(s) for s in hits],
        "alloc_peak": alloc, "requested_peak": req,
        "allowed_bytes": (sum(alloc_bytes(b) for _, b in case.allowed)
                          if case.allowed else None),
        "allowed": [[lbl, b] for lbl, b in case.allowed],
        "dense_bytes": case.dense_bytes or None,
        "launches": {k: LAUNCHES[k] - launches0[k] for k in case.launches},
        "decompress_calls": DECOMPRESS_STATS["calls"] - calls0,
    }


def _verdicts(row: Dict[str, Any], case: Case) -> List[Tuple[str, str]]:
    """(code, message) of every rule this case's figures break."""
    out = []
    reached = (case.limit_elems and row["peak_elems"] >= case.limit_elems)
    if case.control:
        seen = (reached or row["forbidden_hits"]
                or (case.decompress == "some" and row["decompress_calls"]))
        if not seen:
            out.append(("control-not-reached",
                        f"positive control built nothing of the dense size: "
                        f"largest tensor {row['peak_elems']} elements "
                        f"({row['peak_op']}), limit {case.limit_elems}"))
        return out
    if reached:
        out.append(("materialized",
                    f"a {row['peak_elems']}-element tensor "
                    f"({row['peak_op']}), limit {case.limit_elems}"))
    if row["forbidden_hits"]:
        out.append(("materialized",
                    f"built a dense weight-shaped tensor "
                    f"{row['forbidden_hits']}"))
    if case.decompress == "none" and row["decompress_calls"]:
        out.append(("materialized",
                    f"{row['decompress_calls']} decompress call(s)"))
    if row["requested_peak"] is not None:
        if (row["allowed_bytes"] is not None
                and row["requested_peak"] > row["allowed_bytes"]):
            out.append(("over-workspace",
                        f"allocator peak {row['requested_peak']} B over "
                        f"out + workspace {row['allowed_bytes']} B"))
        if case.dense_bytes and row["requested_peak"] >= case.dense_bytes:
            out.append(("materialized",
                        f"allocator peak {row['requested_peak']} B reaches "
                        f"the dense {case.dense_bytes} B"))
    for k, n in row["launches"].items():
        if n <= 0:
            out.append(("kernel-not-run", f"{k} was not launched"))
    return out


def run_checks(checks: Sequence[MaterializationCheck],
               device: Union[str, torch.device] = "cpu"):
    """Run the checks on ``device``: ``(n_checked, violations, rows)``;
    ``rows`` holds each case's figures, or the reason it was skipped."""
    from repro_torch.analysis.contracts import Violation
    dev = torch.device(device)
    out: List[Violation] = []
    rows: List[Dict[str, Any]] = []
    checked = 0
    for chk in checks:
        if chk.needs_card and dev.type != "cuda":
            rows.append({"check": chk.name, "skipped": "needs a card"})
            continue
        checked += 1
        try:
            cases = _cases(chk, dev)
        except Exception as e:  # a check that cannot be built is a finding
            out.append(Violation("materialize", "run-failed", chk.name,
                                 f"{type(e).__name__}: {e}"))
            continue
        for case in cases:
            subject = f"{chk.name}[{case.label}]"
            try:
                row = _run_case(case, dev)
            except Exception as e:
                out.append(Violation("materialize", "run-failed", subject,
                                     f"{type(e).__name__}: {e}"))
                continue
            rows.append(dict(row, check=chk.name))
            for code, msg in _verdicts(row, case):
                out.append(Violation("materialize", code, subject,
                                     f"{chk.describe}: {msg}"))
        del cases
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return checked, out, rows


# ---------------------------------------------------------------------------
# the repo's checks
# ---------------------------------------------------------------------------

def _gen(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _randn(shape, dtype, device, seed):
    return torch.randn(shape, generator=_gen(device, seed),
                       device=device).to(dtype)


def _int8(shape, device, seed):
    return torch.randint(-127, 128, shape, generator=_gen(device, seed),
                         device=device, dtype=torch.int32).to(torch.int8)


def _attn_cfg(impl: str, chunk: int = 1024):
    from repro_torch.configs import get_config
    return get_config("olmo-1b").replace(attn_impl=impl, attn_chunk=chunk,
                                         remat="none")


def _attn_case(device, impl, b, t, hq, hkv, d, dtype, chunk=1024,
               label=""):
    """`dispatch.attention` on a full causal sequence, the score-tensor
    limit [B, Hq, T, S] in elements (f32 scores in bytes)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attn.ops import tc_body
    cfg = _attn_cfg(impl, chunk)
    q = _randn((b, t, hq, d), dtype, device, 1)
    k = _randn((b, t, hkv, d), dtype, device, 2)
    v = _randn((b, t, hkv, d), dtype, device, 3)
    pos = torch.arange(t, device=device)[None, :]
    esz = q.element_size()
    launches = ()
    if impl == "flash":
        launches = ("flash_prefill",) + (
            ("flash_prefill_tc",) if tc_body(dtype, d) else ())
    return Case(
        label=label or f"B{b} T=S={t} Hq{hq} Hkv{hkv} D{d} {_dt(dtype)}",
        fn=lambda q, k, v, pos: dispatch.attention(q, k, v, pos, cfg),
        args=(q, k, v, pos), limit_elems=b * hq * t * t,
        # the output; the front door's start (-pos[0] as int64, as int32,
        # its [B] copy) and the wrapper's zero q_offset [B]
        allowed=(("out", b * t * hq * d * esz), ("-pos", 8),
                 ("start i32", 4), ("start [B]", 4 * b), ("q_offset", 4 * b)),
        dense_bytes=b * hq * t * t * 4, launches=launches)


def _dt(dtype) -> str:
    return {torch.float32: "f32", torch.bfloat16: "bf16",
            torch.int8: "int8", torch.int32: "i32"}[dtype]


def _attn_no_score(device):
    return [_attn_case(device, "flash", 2, 1024, 8, 8, 128, torch.bfloat16),
            _attn_case(device, "flash", 2, 1024, 8, 4, 64, torch.float32)]


def _chunked_no_score(device):
    # the shapes at which the plain routes were first walked: the chunked
    # route's largest tensor is one chunk's scores
    c = _attn_case(device, "chunked", 2, 1024, 4, 2, 32, torch.float32,
                   chunk=256)
    c.allowed, c.dense_bytes = (), 0
    return c


def _naive_reaches_score(device):
    c = _attn_case(device, "naive", 2, 1024, 4, 2, 32, torch.float32)
    c.allowed, c.dense_bytes, c.control = (), 0, True
    return c


def _packed_no_score(device):
    from repro_torch.kernels import dispatch
    cfg = _attn_cfg("flash")
    t, hq, d, segs = 2048, 8, 128, 8
    q, k, v = (_randn((1, t, hq, d), torch.bfloat16, device, s)
               for s in (4, 5, 6))
    seg = torch.arange(t, device=device, dtype=torch.int32) // (t // segs)
    return Case(
        label=f"T{t} ({segs} segments) Hq{hq} D{d} bf16",
        fn=lambda q, k, v, s: dispatch.packed_attention(q, k, v, s, cfg),
        args=(q, k, v, seg), limit_elems=hq * t * t,
        allowed=(("out", t * hq * d * 2),), dense_bytes=hq * t * t * 4,
        launches=("flash_prefill_packed", "flash_prefill_packed_tc"))


# olmo-1b's MLP down projection: the DBB checks' weight
_DBB_K, _DBB_N = 8192, 2048


def _dbb_planes(device, k_dim=_DBB_K, n=_DBB_N, nnz=4):
    """The three values planes of one seeded weight: f32, INT8 (with its
    per-channel scale) and w4 (group 128)."""
    from repro_torch.core.dbb import pack_dbb
    from repro_torch.core.quant import quantize_weight
    w = _randn((k_dim, n), torch.float32, device, 7)
    qw = quantize_weight(w)
    return {"f32": pack_dbb(w, 8, nnz),
            "i8": pack_dbb(qw.q, 8, nnz, scale=qw.scale),
            "w4": pack_dbb(w, 8, nnz, bits=4, group=128)}


def _dbb_no_dense(device, ms=(512, 8), k_dim=_DBB_K, n=_DBB_N):
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.skinny.ops import workspace_elems
    planes = _dbb_planes(device, k_dim, n)
    cases = []
    for m in ms:
        skinny = m <= 32
        for plane, xdt in (("f32", torch.bfloat16), ("i8", torch.bfloat16),
                           ("i8", torch.int8), ("w4", torch.bfloat16)):
            p = planes[plane]
            x = (_int8((m, k_dim), device, 8) if xdt == torch.int8
                 else _randn((m, k_dim), xdt, device, 8))
            od = torch.float32 if xdt == torch.int8 else xdt  # scale fused
            allowed = [("out", m * n * od.itemsize)]
            if skinny:
                allowed.append(("split-K workspace", 4 * workspace_elems(
                    m, k_dim, n, xdt)))
            kern = "dbb_gemm_skinny" if skinny else "dbb_gemm"
            suffix = {"f32": "", "i8": "_i8", "w4": "_w4"}[plane]
            launches = ((kern + "_s8",) if xdt == torch.int8
                        else (kern + suffix,))
            # the plain route's dense [K, N] (in x's dtype; int8 x keeps
            # the int8 values); w4 also the int8 slot plane [K/8·k, N]
            forbidden = ((k_dim, n),)
            limit = k_dim * n
            dense = k_dim * n * xdt.itemsize
            if plane == "w4":
                slots = k_dim // 8 * p.nnz
                forbidden += ((slots, n),)
                limit, dense = slots * n, slots * n
            cases.append(Case(
                label=f"M{m} K{k_dim} N{n} {plane} plane, {_dt(xdt)} x",
                fn=lambda x, p: dispatch.matmul(x, p, pallas=True),
                args=(x, p), limit_elems=limit, forbidden=forbidden,
                allowed=tuple(allowed), dense_bytes=dense,
                launches=launches))
    return cases


def _dbb_plain_builds_dense(device):
    from repro_torch.kernels import dispatch
    k_dim = n = 512
    p = _dbb_planes(device, k_dim, n)["f32"]
    x = _randn((8, k_dim), torch.float32, device, 9)
    return Case(label=f"M8 K{k_dim} N{n} f32 plane, plain route",
                fn=lambda x, p: dispatch.matmul(x, p, pallas=False),
                args=(x, p), limit_elems=k_dim * n,
                forbidden=((k_dim, n),), decompress="some", control=True)


def _sta_peak(device):
    """The dense GEMMs claim no absence: their peak is their output (and
    the int8 skinny body's workspace)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.skinny.ops import workspace_elems
    cases = []
    for m, k_dim, n, dt, gemv, kern in (
            (512, 2048, 8192, torch.bfloat16, False, "sta_gemm"),
            (8, 2048, 8192, torch.bfloat16, False, "sta_gemm_skinny"),
            (8, 2048, 8192, torch.int8, False, "sta_gemm_skinny_s8"),
            (8, 2048, 50304, torch.float32, True, "sta_gemm_skinny")):
        if dt == torch.int8:
            x, w = _int8((m, k_dim), device, 10), _int8((k_dim, n), device, 11)
        else:
            x = _randn((m, k_dim), dt, device, 10)
            w = _randn((k_dim, n), dt, device, 11)
        od = torch.int32 if dt == torch.int8 else dt
        allowed = [("out", m * n * od.itemsize)]
        if dt == torch.int8:
            allowed.append(("split-K workspace",
                            4 * workspace_elems(m, k_dim, n, dt)))
        cases.append(Case(
            label=(f"M{m} K{k_dim} N{n} {_dt(dt)}"
                   + (" (head GEMV)" if gemv else "")),
            fn=lambda x, w, g=gemv: dispatch.matmul(x, w, pallas=True,
                                                    gemv=g),
            args=(x, w), allowed=tuple(allowed), launches=(kern,)))
    return cases


# olmo-1b's serve shape, and paligemma's MQA group at head dim 256:
# (B, Hkv, G, D, S, page, dtype)
_DECODE = ((8, 16, 1, 128, 640, 64, torch.bfloat16),
           (8, 1, 8, 256, 640, 64, torch.bfloat16))


def _decode_no_gather(device, shapes=_DECODE):
    """paged_decode on the route the decode front door picks, called as
    models/attention.py calls it on the contiguous cache: the pool is the
    cache's view, the identity table built beforehand, start None."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attn.ops import (decode_workspace_elems,
                                              identity_block_table,
                                              paged_decode_attention)
    cfg = _attn_cfg("auto").replace(gemm_impl="pallas")
    cases = []
    for b, hkv, g, d, smax, page, dt in shapes:
        esz = torch.tensor([], dtype=dt).element_size()
        route = dispatch.decode_attention_route(
            cfg, group=g, head_dim=d, page=page, smax=smax, itemsize=esz)
        if route != "attn_decode_flash":
            raise RuntimeError(f"decode route {route!r}, not the kernel's")
        n_log = smax // page
        cache_k = _randn((b, smax, hkv, d), dt, device, 12)
        cache_v = _randn((b, smax, hkv, d), dt, device, 13)
        q = _randn((b, hkv, g, d), dt, device, 14)
        lengths = torch.randint(smax // 2, smax, (b,), device=device,
                                generator=_gen(device, 15)).to(torch.int32)
        table = identity_block_table(b, n_log, device)
        kp = cache_k.view(b * n_log, page, hkv, d)
        vp = cache_v.view(b * n_log, page, hkv, d)
        gather = b * smax * hkv * d
        cases.append(Case(
            label=f"B{b} Hkv{hkv} G{g} D{d} S{smax} page {page} {_dt(dt)}",
            fn=lambda q, kp, vp, t, ln: paged_decode_attention(
                q, kp, vp, t, ln, None),
            args=(q, kp, vp, table, lengths), limit_elems=gather,
            forbidden=((b, smax, hkv, d),),
            allowed=(("out", b * hkv * g * d * esz),
                     ("split workspace", 4 * decode_workspace_elems(
                         b, hkv, g, d, n_log, page)),
                     ("start", 4 * b)),
            # the plain route gathers K and V, each [B, S, Hkv, D]
            dense_bytes=2 * gather * esz, launches=("paged_decode",)))
    return cases


def _head_no_logits(device, m=8, k_dim=2048, n=50304):
    """The fused sampling head (default: olmo-1b's head at B8)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.sample.ops import workspace_elems
    h = _randn((m, k_dim), torch.float32, device, 16)
    w = _randn((k_dim, n), torch.float32, device, 17) * 0.02
    counts = torch.zeros((m, n), dtype=torch.int32, device=device)
    ones = torch.ones((m,), device=device)
    zeros = torch.zeros((m,), device=device)
    seed = torch.arange(m, dtype=torch.int32, device=device)
    rows = (ones * 0.8, ones, zeros, zeros, seed, seed)
    ws = workspace_elems(m, k_dim, n)
    return Case(
        label=f"M{m} K{k_dim} N{n} f32, temperature 0.8",
        fn=lambda h, w, c, *r: dispatch.head_sample(h, w, c, *r,
                                                    pallas=True),
        args=(h, w, counts) + rows, limit_elems=m * n,
        allowed=(("score", 4 * m), ("index", 4 * m),
                 ("partial scores", 4 * ws), ("partial indices", 4 * ws)),
        dense_bytes=m * n * 4, launches=("head_sample_fused",))


# convnet's conv1 (64 -> 128 channels, 3x3 SAME), batch 64
_CONV = dict(b=64, h=16, w=16, c=64, n=128, k=3)


def _conv_inputs(device, xdt, geom=_CONV):
    b, h, w, c = geom["b"], geom["h"], geom["w"], geom["c"]
    if xdt == torch.int8:
        return _int8((b, h, w, c), device, 18)
    return _randn((b, h, w, c), xdt, device, 18)


def _conv_no_im2col(device, g=_CONV):
    from repro_torch.core.dbb import pack_dbb
    from repro_torch.core.quant import quantize_weight
    from repro_torch.kernels import dispatch
    m = g["b"] * g["h"] * g["w"]      # SAME, stride 1
    k_dim, n = g["k"] * g["k"] * g["c"], g["n"]
    w = _randn((k_dim, n), torch.float32, device, 19)
    qw = quantize_weight(w)
    weights = {
        ("conv_sta", torch.float32): (w, None, None),
        ("conv_sta", torch.int8): (qw.q, qw.scale, torch.int8),
        ("conv_dbb", torch.float32): (pack_dbb(w, 8, 2), None, None),
        ("conv_dbb", torch.int8): (pack_dbb(qw.q, 8, 2, scale=qw.scale),
                                   None, torch.int8)}
    cases = []
    for (route, xdt), (wt, scale, od) in weights.items():
        x = _conv_inputs(device, xdt, g)
        out_esz = (od or xdt).itemsize
        kern = {"conv_sta": "conv_gemm", "conv_dbb": "conv_gemm_dbb"}[route]
        forbidden = ((k_dim, n),) if route == "conv_dbb" else ()
        cases.append(Case(
            label=(f"{route} B{g['b']} {g['h']}x{g['w']}x{g['c']} -> {n} "
                   f"{g['k']}x{g['k']} {_dt(xdt)}"),
            fn=lambda x, wt, s=scale, o=od: dispatch.conv(
                x, wt, None, s, kh=g["k"], kw=g["k"], out_dtype=o),
            args=(x, wt), limit_elems=m * k_dim, forbidden=forbidden,
            allowed=(("out", m * n * out_esz),),
            dense_bytes=m * k_dim * xdt.itemsize,
            launches=(kern + ("_s8" if xdt == torch.int8 else ""),)))
    return cases


def _conv_plain_builds_im2col(device):
    from repro_torch.kernels import dispatch
    g = dict(b=4, h=16, w=16, c=16, n=32, k=3)
    m, k_dim = g["b"] * g["h"] * g["w"], g["k"] * g["k"] * g["c"]
    x = _conv_inputs(device, torch.float32, g)
    w = _randn((k_dim, g["n"]), torch.float32, device, 20)
    return Case(label=f"conv_xla B4 16x16x16 -> 32 3x3 f32",
                fn=lambda x, w: dispatch.conv(x, w, kh=3, kw=3,
                                              use_kernel=False),
                args=(x, w), limit_elems=m * k_dim, control=True)


# one olmo-1b decode step at full width: B8 against a 640-slot cache
_STEP_B, _STEP_SMAX, _STEP_LEN = 8, 640, 320


def _decode_step_no_dense(device) -> List[Case]:
    """Per values plane (DBB k4 f32, w4): one tree and cache, stepped on
    the kernel route (no dense [K, N] of a packed leaf, no decompress) and
    on the plain route (the control: decompress runs, [K, N] appears)."""
    from repro_torch.configs import get_config
    from repro_torch.core.dbb import DbbWeight
    from repro_torch.core.dbb_linear import iter_leaves
    from repro_torch.models import registry
    from repro_torch.models import transformer as tf
    cases = []
    for plane in ("f32", "w4"):
        base = get_config("olmo-1b").replace(remat="none")
        if plane == "w4":
            base = base.replace(dbb=dataclasses.replace(base.dbb,
                                                        weight_bits=4))
        params = registry.init_params_by_layer(base, seed=0, device=device,
                                               pack=True)
        shapes = tuple(sorted({(leaf.k_dim, leaf.n_dim)
                               for leaf in iter_leaves(params)
                               if isinstance(leaf, DbbWeight)}))
        cache = tf.init_cache(base, _STEP_B, _STEP_SMAX, device=device)
        for key in ("k", "v"):
            cache[key].normal_(generator=_gen(device, 21))
        cache["length"].fill_(_STEP_LEN)
        tokens = torch.randint(0, base.vocab_size, (_STEP_B,),
                               device=device, generator=_gen(device, 22))
        suffix = "_w4" if plane == "w4" else ""
        for route in ("pallas", "xla"):
            cfg = base.replace(gemm_impl=route)
            kernel = route == "pallas"
            cases.append(Case(
                label=(f"olmo-1b {base.num_layers} layers B{_STEP_B} "
                       f"S{_STEP_SMAX}, DBB k4 "
                       f"{plane} plane, "
                       f"{'kernel' if kernel else 'plain'} route"),
                fn=lambda p, t, c, cfg=cfg: tf.decode_step(p, cfg, t, c),
                args=(params, tokens, cache), forbidden=shapes,
                decompress="none" if kernel else "some",
                control=not kernel,
                launches=(("dbb_gemm_skinny" + suffix, "paged_decode")
                          if kernel else ())))
    return cases


def repo_checks() -> List[MaterializationCheck]:
    """The port's absence claims, each through the dispatcher's front door,
    and the controls that show the walker sees a dense tensor."""
    M = MaterializationCheck
    return [
        M("attn-no-score-tensor", "the flash route must not build the "
          "[B,Hq,T,S] score tensor", _attn_no_score, needs_card=True),
        M("packed-attn-no-score-tensor", "the packed flash route must not "
          "build the [Hq,T,T] score tensor", _packed_no_score,
          needs_card=True),
        M("dbb-no-dense-weight", "the packed DBB GEMMs must not expand the "
          "dense [K,N] weight (w4: nor the int8 slot plane)", _dbb_no_dense,
          needs_card=True),
        M("decode-no-gathered-kv", "paged decode must not gather a "
          "contiguous [B,S,Hkv,D] K/V", _decode_no_gather, needs_card=True),
        M("head-no-logits", "the fused sampling head must not build the "
          "[M,V] logits", _head_no_logits, needs_card=True),
        M("conv-no-im2col", "the implicit-GEMM convs must not build the "
          "[M,K] im2col matrix (conv_dbb: nor the dense [K,N])",
          _conv_no_im2col, needs_card=True),
        M("decode-step-no-dense", "a kernel-route decode step must build no "
          "[K,N] of a packed leaf and call decompress 0 times",
          _decode_step_no_dense, needs_card=True),
        M("sta-peak", "the dense GEMMs' peak is their output and workspace",
          _sta_peak, needs_card=True),
        M("attn-chunked-no-score-tensor", "the chunked route must not build "
          "the [B,Hq,T,S] score tensor", _chunked_no_score),
        M("attn-naive-control", "control: the naive route builds the "
          "[B,Hq,T,S] score tensor", _naive_reaches_score),
        M("dbb-plain-control", "control: the plain DBB route builds the "
          "dense [K,N]", _dbb_plain_builds_dense),
        M("conv-plain-control", "control: the plain conv route builds the "
          "[M,K] im2col matrix", _conv_plain_builds_im2col),
    ]
