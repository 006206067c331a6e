"""The routes to the split-K bodies of dbb_gemm_skinny and dbb_gemm, on the
CPU.

The CUDA launchers pick a body by a rule on the operands:
csrc/dbb_gemm_skinny.cu's ``split_body`` (float x runs the split-K body,
int8 x the int8 body of split_k_s8.cuh) and csrc/dbb_gemm.cu's
``narrow_body`` (f32 x at N <= 16 runs the narrow split-K body). The
wrappers mirror the rules to count ``dbb_gemm_skinny_split`` /
``dbb_gemm_narrow`` launches. Here each mirror is held against its
launcher's own source, and the rules and the K-slice counts are shown
never to read M (a row's bits must not depend on how many rows share the
call). Then the CPU route of the shapes the new
bodies take on the card is held against the Pallas kernels in interpret
mode: dbb_gemm with f32 x at N 10 and 16 with K that splits raggedly, and
dbb_gemm_skinny at M 1, 7, 8, 9, 24 and 32 on the f32, INT8 and w4 planes
with f32 and bf16 x, at N 10 and 48. Inputs come from numpy seeds.
Tolerances: f32 outputs rtol 1e-5, atol 1e-5 of max |want| (the two sum K
in different orders); bf16 outputs 2^-7 of |want| + 1e-5 of max |want|
(one bf16 rounding step of the output).

tests/test_torch_gpu.py holds the bodies themselves against the plain
versions on the card.
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
from repro_torch.core import dbb as tdbb
from repro_torch.core import quant as tquant
from repro_torch.kernels import build
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.dbb_gemm import dbb_gemm
from repro_torch.kernels.dbb_gemm.ops import narrow_body
from repro_torch.kernels.skinny import dbb_gemm_skinny
from repro_torch.kernels.skinny.ops import split_body

torch.set_num_threads(1)
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
DTYPES = (torch.float32, torch.bfloat16, torch.int8)
NS = (1, 3, 8, 10, 15, 16, 17, 32, 64, 2048, 50304)
CODES = {f"DT_{k}": v for k, v in
         (("F32", 0), ("BF16", 1), ("I8", 2), ("I32", 3))}


def _c_rule(source: str, name: str):
    """A launcher's ``bool <name>(int a, ...) { return <expr>; }``: its
    parameters and the rule as a Python function of them (``&&``, ``||``,
    ``==``, ``<=`` and the DType enum)."""
    m = re.search(rf"bool {name}\(([^)]*)\)\s*\{{\s*return (.*?);\s*\}}",
                  (CSRC / source).read_text(), re.S)
    assert m, f"no {name} rule in {source}"
    params = [p.split()[-1] for p in m.group(1).split(",")]
    expr = re.sub(r"\s+", " ", m.group(2)).replace("repro::", "")
    expr = expr.replace("&&", " and ").replace("||", " or ")
    return params, lambda **kw: bool(eval(expr, dict(CODES), kw))


def _c_params(source: str, name: str):
    """The parameter names of ``int <name>(...)`` in a launcher's source."""
    m = re.search(rf"\bint {name}\(([^)]*)\)", (CSRC / source).read_text())
    assert m, f"no {name} in {source}"
    return [p.split()[-1] for p in m.group(1).split(",")]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_split_rule_mirrors_the_launcher(dtype):
    params, rule = _c_rule("dbb_gemm_skinny.cu", "split_body")
    assert params == ["dtype"]
    assert split_body(dtype) == rule(dtype=build.dtype_code(dtype))
    assert split_body(dtype) == (dtype != torch.int8)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_narrow_rule_mirrors_the_launcher(dtype):
    params, rule = _c_rule("dbb_gemm.cu", "narrow_body")
    assert params == ["dtype", "N"]
    code = build.dtype_code(dtype)
    for n in NS:
        assert narrow_body(dtype, n) == rule(dtype=code, N=n), (dtype, n)
        assert narrow_body(dtype, n) == (dtype == torch.float32
                                         and n <= 16)


def test_new_rules_and_splits_never_read_m():
    """Neither body rule nor the K-slice counts (the cluster sizes, which
    set each row's K order) has an M to read, in Python or in C."""
    assert list(inspect.signature(split_body).parameters) == ["dtype"]
    assert list(inspect.signature(narrow_body).parameters) == ["dtype", "n"]
    for source, name in (("dbb_gemm_skinny.cu", "split_body"),
                         ("dbb_gemm.cu", "narrow_body")):
        params, _ = _c_rule(source, name)
        assert "M" not in params
    assert _c_params("dbb_gemm_skinny.cu", "splits") == ["K", "N"]
    assert _c_params("dbb_gemm.cu", "narrow_splits") == ["K"]


def test_the_tensor_core_rule_comes_first():
    """bf16 x at N <= 16 stays on dbb_gemm's tensor-core body: the
    launcher tests tc_body before narrow_body, and the narrow rule takes
    f32 alone."""
    src = (CSRC / "dbb_gemm.cu").read_text()
    assert src.index("if (tc_body(dtype))") < src.index(
        "if (narrow_body(dtype, N))")
    assert not narrow_body(torch.bfloat16, 10)


def _planes(w: np.ndarray, plane: str, nnz: int, group: int):
    """The JAX and torch DBB operands of ``w`` in one values format:
    (jax values, bitmask, scale, kwargs), (torch ...)."""
    if plane == "w4":
        jp = jdbb.pack_dbb(jnp.asarray(w), 8, nnz, bits=4, group=group)
        tp = tdbb.pack_dbb(torch.from_numpy(w), 8, nnz, bits=4, group=group)
        return ((jp.values, jp.bitmask, None,
                 dict(bits=4, group=group, gscale=jp.scale)),
                (tp.values, tp.bitmask, None,
                 dict(bits=4, group=group, gscale=tp.scale)))
    if plane == "i8":
        qw = jquant.quantize_weight(jnp.asarray(w))
        tq = tquant.quantize_weight(torch.from_numpy(w))
        jp, tp = jdbb.pack_dbb(qw.q, 8, nnz), tdbb.pack_dbb(tq.q, 8, nnz)
        assert tp.values.dtype == torch.int8
        return ((jp.values, jp.bitmask, qw.scale, {}),
                (tp.values, tp.bitmask, tq.scale, {}))
    jp = jdbb.pack_dbb(jnp.asarray(w), 8, nnz)
    tp = tdbb.pack_dbb(torch.from_numpy(w), 8, nnz)
    return (jp.values, jp.bitmask, None, {}), (tp.values, tp.bitmask, None,
                                               {})


def _close(got: torch.Tensor, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    scale = np.abs(want).max()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    else:
        bound = 2.0 ** -7 * np.abs(want) + 1e-5 * scale
        assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


def _run(m, k, n, plane, dtype, nnz, group, skinny, seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((m, k)).astype(np.float32)
    w = r.standard_normal((k, n)).astype(np.float32)
    bias = r.standard_normal(n).astype(np.float32)
    (jv, jb, js, jkw), (tv, tb, ts, tkw) = _planes(w, plane, nnz, group)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jdbb_gemm(jnp.asarray(x, jdt), jv, jb, jnp.asarray(bias), js,
                     act="silu", block=8, nnz=nnz, skinny=skinny, **jkw)
    fn = dbb_gemm_skinny if skinny else dbb_gemm
    before = dict(LAUNCHES)
    got = fn(torch.from_numpy(x).to(dtype), tv, tb, torch.from_numpy(bias),
             ts, act="silu", nnz=nnz, **tkw)
    assert LAUNCHES == before              # the CPU path launches nothing
    assert got.dtype == dtype and tuple(got.shape) == (m, n)
    _close(got, want, dtype)


@pytest.mark.parametrize("plane", ["f32", "i8", "w4"])
@pytest.mark.parametrize("n", [10, 16])
@pytest.mark.parametrize("k,nnz,group", [(784, 2, 8), (1048, 4, 8)])
def test_dbb_gemm_narrow_cpu_route_matches_pallas(plane, n, k, nnz, group):
    """f32 x at N <= 16 (the shapes the narrow body takes on the card),
    M 70 (a ragged last 4-row tile); K 784 splits into 64 + 34 DBB blocks,
    K 1048 into 64 + 64 + 3."""
    assert narrow_body(torch.float32, n)
    _run(70, k, n, plane, torch.float32, nnz, group, False, k + n)


@pytest.mark.parametrize("m", [1, 7, 8, 9, 24, 32])
@pytest.mark.parametrize("plane", ["f32", "i8", "w4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("n", [10, 48])
def test_dbb_gemm_skinny_cpu_route_matches_pallas(m, plane, dtype, n):
    """Every skinny M bucket on every values plane and float x: K 264 (33
    DBB blocks: two K slices of 24 and 9 on the card), w4 groups of 24 (a
    64-K stage spans three), N 10 (the classifier's width) and 48."""
    assert split_body(dtype)
    nnz = 4 if plane == "w4" else 3
    _run(m, 264, n, plane, dtype, nnz, 24, True, m * 100 + n)
