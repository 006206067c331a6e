"""The route to the tensor-core body of sta_gemm and dbb_gemm, on the CPU.

The CUDA launchers (csrc/sta_gemm.cu, csrc/dbb_gemm.cu) pick one of two
bodies by a rule on the operands: the tensor-core body (csrc/tc_gemm.cuh)
or the plain-FMA one. The wrappers mirror that rule in ``tc_body`` to
count ``sta_gemm_tc`` / ``dbb_gemm_tc`` launches. Here the mirror is held
against the launchers' own source, shown never to read M and never to
send f32 or int8 operands to the tensor cores; and the CPU route of the
shapes the tensor-core body takes on the card (bf16, ragged M, K and N
off the 64-wide stage and tile) is held against the Pallas kernels in
interpret mode, all three DBB value planes included. Tolerance (bf16
outputs): 2^-7 of |want| + 1e-5 of max |want|, one bf16 rounding step.

tests/test_torch_gpu.py holds the body itself against the plain versions
on the card.
"""
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dbb as jdbb
from repro.core import quant as jquant
from repro.kernels.dbb_gemm.ops import dbb_gemm as jdbb_gemm
from repro.kernels.sta_gemm.ops import sta_gemm as jsta_gemm
from repro_torch.core import dbb as tdbb
from repro_torch.core import quant as tquant
from repro_torch.kernels import build
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.dbb_gemm import dbb_gemm
from repro_torch.kernels.dbb_gemm.ops import tc_body as dbb_tc_body
from repro_torch.kernels.sta_gemm import sta_gemm
from repro_torch.kernels.sta_gemm.ops import tc_body as sta_tc_body

torch.set_num_threads(1)
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
DTYPES = (torch.float32, torch.bfloat16, torch.int8)
KS = (0, 5, 8, 64, 100, 136, 200, 2048, 8192)
NS = (1, 3, 8, 64, 72, 200, 300, 8192, 50304)


def _c_rule(source: str):
    """``tc_body``'s parameters and its rule as a Python function of them,
    read from a launcher's source: ``bool tc_body(int a, ...) { return
    <expr>; }`` with ``&&`` / ``==`` / ``%`` and the DType enum."""
    m = re.search(r"bool tc_body\(([^)]*)\)\s*\{\s*return (.*?);\s*\}",
                  (CSRC / source).read_text(), re.S)
    assert m, f"no tc_body rule in {source}"
    params = [p.split()[-1] for p in m.group(1).split(",")]
    expr = re.sub(r"\s+", " ", m.group(2)).replace("repro::", "")
    expr = expr.replace("&&", " and ").replace("||", " or ")
    codes = {f"DT_{k}": v for k, v in
             (("F32", 0), ("BF16", 1), ("I8", 2), ("I32", 3))}
    return params, lambda **kw: bool(eval(expr, dict(codes), kw))


def _close_bf16(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = 2.0 ** -7 * np.abs(want) + 1e-5 * np.abs(want).max()
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


def test_dtype_codes_match_the_c_enum():
    enum = re.search(r"enum DType \{([^}]*)\}",
                     (CSRC / "common.cuh").read_text()).group(1)
    c = {k.strip(): int(v) for k, v in
         (e.split("=") for e in enum.split(","))}
    assert c == {"DT_F32": build.DTYPE_CODES[torch.float32],
                 "DT_BF16": build.DTYPE_CODES[torch.bfloat16],
                 "DT_I8": build.DTYPE_CODES[torch.int8],
                 "DT_I32": build.DTYPE_CODES[torch.int32]}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_sta_gemm_rule_mirrors_the_launcher(dtype):
    params, rule = _c_rule("sta_gemm.cu")
    assert params == ["dtype", "K", "N"]
    code = build.dtype_code(dtype)
    for k in KS:
        for n in NS:
            assert sta_tc_body(dtype, k, n) == rule(dtype=code, K=k, N=n), \
                (dtype, k, n)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_dbb_gemm_rule_mirrors_the_launcher(dtype):
    params, rule = _c_rule("dbb_gemm.cu")
    assert params == ["dtype"]
    assert dbb_tc_body(dtype) == rule(dtype=build.dtype_code(dtype))


def test_rules_never_read_m():
    """The body a row runs on must not depend on how many rows share the
    call (serve's packed, chunked and padded prefills): neither rule has
    an M to read, in Python or in C."""
    assert list(inspect.signature(sta_tc_body).parameters) == ["dtype", "k",
                                                               "n"]
    assert list(inspect.signature(dbb_tc_body).parameters) == ["dtype"]
    for source in ("sta_gemm.cu", "dbb_gemm.cu"):
        params, _ = _c_rule(source)
        assert "M" not in params


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8], ids=str)
def test_f32_and_int8_never_take_the_tensor_cores(dtype):
    assert not dbb_tc_body(dtype)
    assert not any(sta_tc_body(dtype, k, n) for k in KS for n in NS)


@pytest.mark.parametrize("k,n,want", [(2048, 8192, True), (8192, 2048, True),
                                      (200, 200, True), (0, 8, True),
                                      (100, 200, False), (5, 64, False),
                                      (256, 300, False), (256, 50304, True)])
def test_sta_gemm_bf16_takes_the_tensor_cores_on_16_byte_rows(k, n, want):
    assert sta_tc_body(torch.bfloat16, k, n) is want


@pytest.mark.parametrize("m", [1, 65, 130])
@pytest.mark.parametrize("k,n", [(200, 72), (136, 200)])
def test_sta_gemm_bf16_cpu_route_matches_pallas(m, k, n):
    """Shapes the card runs on the tensor-core body: ragged M around the
    128-row tile, K and N off the 64-wide stage and column tile."""
    assert sta_tc_body(torch.bfloat16, k, n)
    r = np.random.default_rng(m * k + n)
    x = r.standard_normal((m, k)).astype(np.float32)
    w = r.standard_normal((k, n)).astype(np.float32)
    bias = r.standard_normal(n).astype(np.float32)
    want = jsta_gemm(jnp.asarray(x, jnp.bfloat16),
                     jnp.asarray(w, jnp.bfloat16), jnp.asarray(bias),
                     act="silu", skinny=False)
    before = dict(LAUNCHES)
    got = sta_gemm(torch.from_numpy(x).bfloat16(),
                   torch.from_numpy(w).bfloat16(), torch.from_numpy(bias),
                   act="silu")
    assert LAUNCHES == before              # the CPU path launches nothing
    assert got.dtype == torch.bfloat16
    _close_bf16(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("m", [1, 65, 130])
@pytest.mark.parametrize("plane", ["f32", "i8", "w4"])
def test_dbb_gemm_bf16_cpu_route_matches_pallas(m, plane):
    """bf16 x on each values plane at K 136 (17 DBB blocks: the last stage
    of 64 holds one) and N 72, with bias and silu (and the INT8 plane's
    per-channel scale in the epilogue)."""
    k, n, nnz = 136, 72, 4
    r = np.random.default_rng(m + len(plane))
    x = r.standard_normal((m, k)).astype(np.float32)
    w = r.standard_normal((k, n)).astype(np.float32)
    bias = r.standard_normal(n).astype(np.float32)
    js = ts = None
    jkw, tkw = {}, {}
    if plane == "w4":
        jp = jdbb.pack_dbb(jnp.asarray(w), 8, nnz, bits=4, group=8)
        tp = tdbb.pack_dbb(torch.from_numpy(w), 8, nnz, bits=4, group=8)
        jkw = dict(bits=4, group=8, gscale=jp.scale)
        tkw = dict(bits=4, group=8, gscale=tp.scale)
    elif plane == "i8":
        qw = jquant.quantize_weight(jnp.asarray(w))
        jp = jdbb.pack_dbb(qw.q, 8, nnz)
        tq = tquant.quantize_weight(torch.from_numpy(w))
        tp = tdbb.pack_dbb(tq.q, 8, nnz)
        js, ts = qw.scale, tq.scale
    else:
        jp = jdbb.pack_dbb(jnp.asarray(w), 8, nnz)
        tp = tdbb.pack_dbb(torch.from_numpy(w), 8, nnz)
    want = jdbb_gemm(jnp.asarray(x, jnp.bfloat16), jp.values, jp.bitmask,
                     jnp.asarray(bias), js, act="silu", block=8, nnz=nnz,
                     skinny=False, **jkw)
    before = dict(LAUNCHES)
    got = dbb_gemm(torch.from_numpy(x).bfloat16(), tp.values, tp.bitmask,
                   torch.from_numpy(bias), ts, act="silu", nnz=nnz, **tkw)
    assert LAUNCHES == before
    assert got.dtype == torch.bfloat16
    _close_bf16(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
