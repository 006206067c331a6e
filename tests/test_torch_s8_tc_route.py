"""The route to the int8 tensor-core body of sta_gemm and dbb_gemm, on the
CPU.

The int8 launchers (sta_gemm_s8_launch in csrc/sta_gemm.cu,
dbb_gemm_s8_launch in csrc/dbb_gemm.cu) pick one of two bodies by a rule
on K and N (both multiples of 16: TMA's 16-byte rows): the int8
tensor-core body (csrc/tc_gemm_s8.cuh: s8 wgmma on
TMA-fed tiles) or the IMAD one (gemm_tile.cuh, dbb_gemm.cu's plain body).
The wrappers mirror each rule in ``s8_tc_body`` to count
``sta_gemm_s8_tc`` / ``dbb_gemm_s8_tc`` launches. Here the mirrors are
held against the launchers' own source (the rules are parsed out of it),
the rules are shown never to read M and to be read by the int8 launchers
alone (no float dtype reaches the s8 body), and the CPU route of shapes
the s8 body takes on the card (int8 x and w from numpy seeds, ragged M,
K off the 128-deep stage, N off the 64-wide tile, DBB nnz 1, 3, 4 and 8)
is held against the Pallas kernels in interpret mode.

Tolerances (tests/test_torch_int8.py's): int32 outputs and int8 outputs
after relu bit-equal; f32 outputs (scale, bias, gelu) rtol 1e-6 with atol
1e-7·max|want| (the two libraries' tanh may differ by an ulp).

tests/test_torch_gpu.py holds the body itself against the plain versions
and the IMAD body's neighbours on the card.
"""
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dbb import pack_dbb as jpack
from repro.kernels.dbb_gemm.ops import dbb_gemm as jdbb_gemm
from repro.kernels.sta_gemm.ops import sta_gemm as jsta_gemm
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.dbb_gemm import dbb_gemm
from repro_torch.kernels.dbb_gemm.ops import s8_tc_body as dbb_s8_tc_body
from repro_torch.kernels.sta_gemm import sta_gemm
from repro_torch.kernels.sta_gemm.ops import s8_tc_body as sta_s8_tc_body

torch.set_num_threads(1)
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
KS = (0, 8, 16, 24, 100, 136, 144, 200, 272, 1179, 1184, 2048, 4096, 8192)
NS = (1, 8, 10, 16, 24, 80, 200, 208, 2048, 4104, 8192, 50304)
I8, I32, F32 = torch.int8, torch.int32, torch.float32


def _c_rule(source: str, name: str):
    """Rule ``name``'s parameters and its expression as a Python function
    of them, read from a launcher's source: ``bool name(int a, ...) {
    return <expr>; }`` with ``&&`` / ``==`` / ``%``."""
    m = re.search(rf"bool {name}\(([^)]*)\)\s*\{{\s*return (.*?);\s*\}}",
                  (CSRC / source).read_text(), re.S)
    assert m, f"no {name} rule in {source}"
    params = [p.split()[-1] for p in m.group(1).split(",")]
    expr = re.sub(r"\s+", " ", m.group(2)).replace("&&", " and ")
    assert re.fullmatch(r"[\w %=!<>()and]+", expr), expr
    return params, lambda **kw: bool(eval(expr, {}, kw))


def _functions(source: str):
    """{name: body} of every top-level function in a launcher's source
    (its text between the braces), found by brace matching."""
    text = (CSRC / source).read_text()
    out = {}
    for m in re.finditer(r"^(?:extern \"C\" )?[\w:<>]+ (\w+)\([^;{]*\)\s*\{",
                         text, re.M):
        depth, i = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        out[m.group(1)] = text[m.end():i - 1]
    return out


def test_sta_gemm_s8_rule_mirrors_the_launcher():
    params, rule = _c_rule("sta_gemm.cu", "s8_tc_body")
    assert params == ["K", "N"]
    for k in KS:
        for n in NS:
            assert sta_s8_tc_body(k, n) == rule(K=k, N=n), (k, n)


def test_dbb_gemm_s8_rule_mirrors_the_launcher():
    params, rule = _c_rule("dbb_gemm.cu", "s8_tc_body")
    assert params == ["K", "N"]
    for k in KS:
        for n in NS:
            assert dbb_s8_tc_body(k, n) == rule(K=k, N=n), (k, n)


def test_s8_rules_never_read_m():
    """A row's body must not depend on how many rows share the call: the
    rules have no M to read, in Python or in C."""
    for rule in (sta_s8_tc_body, dbb_s8_tc_body):
        assert list(inspect.signature(rule).parameters) == ["k", "n"]
    for source in ("sta_gemm.cu", "dbb_gemm.cu"):
        params, _ = _c_rule(source, "s8_tc_body")
        assert "M" not in params


@pytest.mark.parametrize("source,kernel", [("sta_gemm.cu", "sta_gemm"),
                                           ("dbb_gemm.cu", "dbb_gemm")])
def test_only_the_int8_launcher_reaches_the_s8_body(source, kernel):
    """No float dtype reaches the s8 body: its rule and its launch
    (repro::tc8) are read only in the int8-operand launcher
    (``<kernel>_s8_launch``) and the rule's export."""
    funcs = _functions(source)
    assert {f"{kernel}_s8_launch", f"{kernel}_s8_tc_body",
            "s8_tc_body"} <= set(funcs)
    users = {name for name, body in funcs.items()
             if re.search(r"\bs8_tc_body\(", body)}
    assert users == {f"{kernel}_s8_launch", f"{kernel}_s8_tc_body"}
    launches = {name for name, body in funcs.items() if "tc8::" in body}
    assert launches == {f"{kernel}_s8_launch"}
    export = funcs[f"{kernel}_s8_tc_body"]
    assert re.fullmatch(r"\s*return s8_tc_body\(K, N\) \? 1 : 0;\s*",
                        export), export


@pytest.mark.parametrize("k,n,want", [(2048, 2048, True), (2048, 8192, True),
                                      (8192, 2048, True), (1184, 48, True),
                                      (0, 16, True), (1179, 256, False),
                                      (200, 300, False), (136, 96, False),
                                      (256, 200, False), (4096, 10, False)])
@pytest.mark.parametrize("kernel", ["sta_gemm", "dbb_gemm"])
def test_s8_takes_the_tensor_cores_on_16_byte_rows(kernel, k, n, want):
    """olmo-1b's layer GEMMs take the s8 body; the odd DBB block counts
    (K 136, 1224), N 200 and convnet's INT8 classifier (K 4096, N 10: 10-
    byte plane rows) the IMAD body."""
    rule = sta_s8_tc_body if kernel == "sta_gemm" else dbb_s8_tc_body
    assert rule(k, n) is want


# ---------------------------------------------------------------------------
# the CPU routes of shapes the s8 body takes, against the Pallas kernels
# ---------------------------------------------------------------------------

def _ints(r, shape):
    return r.integers(-127, 128, shape).astype(np.int8)


def _epilogues(r, n):
    """(label, keyword operands, act, out dtype) of the three epilogues:
    the raw int32 sum; f32 after scale, bias and gelu; int8 requantized
    after a scale and relu."""
    bias = (r.standard_normal(n) * 50).astype(np.float32)
    scale = ((r.random(n) + 0.5) * 2e-3).astype(np.float32)
    return (("int32", {}, "none", None),
            ("f32", dict(bias=bias, scale=scale), "gelu", F32),
            ("int8", dict(scale=scale), "relu", I8))


def _check(got, want, od):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if od == F32:
        np.testing.assert_allclose(
            got, want, rtol=1e-6, atol=1e-7 * float(np.abs(want).max()))
    else:
        np.testing.assert_array_equal(got, want)


_JNP = {I8: jnp.int8, I32: jnp.int32, F32: jnp.float32, None: None}


def _run_both(jfn, tfn, n, r):
    for _, kw, act, od in _epilogues(r, n):
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}
        tkw = {k: torch.tensor(v) for k, v in kw.items()}
        want = jfn(act=act, out_dtype=_JNP[od], **jkw)
        before = dict(LAUNCHES)
        got = tfn(act=act, out_dtype=od, **tkw)
        assert LAUNCHES == before              # the CPU path launches nothing
        _check(got, want, od)


@pytest.mark.parametrize("m", [1, 63, 65, 300])
@pytest.mark.parametrize("k,n", [(16, 16), (144, 80), (272, 208)])
def test_sta_gemm_s8_cpu_route_matches_pallas(m, k, n):
    """Dense int8: K 144 / 272 leave the last 128-deep stage short, N 80 /
    208 the last 64-wide column tile; N 200 is off the dense rule (it runs
    the IMAD body), so 208 stands in."""
    assert sta_s8_tc_body(k, n)
    r = np.random.default_rng(m * 1000 + k + n)
    x, w = _ints(r, (m, k)), _ints(r, (k, n))
    tx, tw = torch.tensor(x), torch.tensor(w)
    _run_both(
        lambda **kw: jsta_gemm(jnp.asarray(x), jnp.asarray(w),
                               kw.pop("bias", None), kw.pop("scale", None),
                               skinny=False, **kw),
        lambda **kw: sta_gemm(tx, tw, kw.pop("bias", None),
                              kw.pop("scale", None), **kw), n, r)


@pytest.mark.parametrize("m", [1, 63, 65, 300])
@pytest.mark.parametrize("k,n,nnz", [(16, 16, 1), (144, 80, 3),
                                     (272, 208, 4), (272, 208, 8)])
def test_dbb_gemm_s8_cpu_route_matches_pallas(m, k, n, nnz):
    """int8 x on the INT8 values plane: nnz 1, 3 (slots past nnz are zero
    bytes), 4 (the serving path's k) and 8 (no zero slot: the kept-byte
    mask), K 144 / 272 off the stage, N 80 / 208 off the tile (N 200 is
    off the rule, so 208 stands in)."""
    assert dbb_s8_tc_body(k, n)
    r = np.random.default_rng(m * 1000 + k + n + nnz)
    x, w = _ints(r, (m, k)), _ints(r, (k, n))
    p = jpack(jnp.asarray(w), 8, nnz)
    values = torch.tensor(np.asarray(p.values))
    bitmask = torch.tensor(np.asarray(p.bitmask).view(np.int32))
    assert values.dtype == torch.int8
    tx = torch.tensor(x)
    _run_both(
        lambda **kw: jdbb_gemm(jnp.asarray(x), p.values, p.bitmask,
                               kw.pop("bias", None), kw.pop("scale", None),
                               nnz=nnz, skinny=False, **kw),
        lambda **kw: dbb_gemm(tx, values, bitmask, kw.pop("bias", None),
                              kw.pop("scale", None), nnz=nnz, **kw), n, r)
