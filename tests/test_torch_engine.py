"""`ServeEngine.generate` of the port against the reference's on the same
packed weights (smoke width, f32; prefill attention unpinned — the flash
kernels' plain versions against the Pallas kernels in interpret mode — and
pinned to the naive route): greedy token streams must be equal.

Cases: a uniform batch, a ragged (left-padded) batch, and a cache length
(prompt + new tokens) that is not a multiple of 8, where decode attention
takes the plain route in both packages instead of the paged kernel. The
prefill GEMMs run at M = 8·T > 32 (the M-tiled DBB route), decode at
M = 8 (the skinny routes). No step needed the top-2-margin exclusion at
these seeds: the streams are compared whole.

The dense-weights case serves the same weights unpacked: its prefill MLP
takes the M-tiled dense route (``sta``), decode the skinny one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fixtures import configs, dense_params, packed_params, prompts
from repro.models import registry as jreg
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.kernels import dispatch
from repro_torch.models import registry as treg
from repro_torch.kernels.common import LAUNCHES
from repro_torch.serve.engine import ServeEngine

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params():
    return packed_params(seed=1)


@pytest.mark.parametrize("lengths,new", [
    ([6] * 8, 10),                        # uniform; 6 + 10 = 16
    ([6, 3, 6, 2, 5, 1, 6, 4], 10),       # ragged; start rides along
    ([7, 4, 7, 7, 2, 7, 5], 10),          # 7 + 10 = 17: plain decode route
])
def test_generate_tokens_equal_reference(params, lengths, new):
    jcfg, tcfg = configs()
    jp, tp = params
    ps = prompts(lengths, seed=len(lengths) + new)
    want = JEngine(jcfg, jp, max_batch=8).generate(ps, max_new_tokens=new)
    before = dict(LAUNCHES)
    got = ServeEngine(tcfg, tp, max_batch=8, device="cpu").generate(
        ps, max_new_tokens=new)
    assert got == want
    assert LAUNCHES == before             # plain versions on the CPU


def test_generate_tokens_equal_reference_pinned_naive(params):
    """Prefill attention pinned to the naive route in both packages."""
    jcfg, tcfg = configs(pin=True)
    jp, tp = params
    ps = prompts([6, 3, 6, 2, 5, 1, 6, 4], seed=18)
    want = JEngine(jcfg, jp, max_batch=8).generate(ps, max_new_tokens=10)
    got = ServeEngine(tcfg, tp, max_batch=8, device="cpu").generate(
        ps, max_new_tokens=10)
    assert got == want


def test_plain_route_tokens_equal_kernel_route(params):
    """gemm_impl="xla" (plain torch everywhere) gives the kernel route's
    tokens on the same weights."""
    _, tcfg = configs()
    _, xcfg = configs("xla")
    _, tp = params
    ps = prompts([6, 3, 6, 2, 5, 1, 6, 4], seed=5)
    a = ServeEngine(tcfg, tp, max_batch=8, device="cpu").generate(ps, 12)
    b = ServeEngine(xcfg, tp, max_batch=8, device="cpu").generate(ps, 12)
    assert a == b


def test_eos_cuts_rows_and_pads_rows_are_dropped(params):
    _, tcfg = configs()
    _, tp = params
    ps = prompts([5, 5, 3], seed=9)
    eng = ServeEngine(tcfg, tp, max_batch=8, device="cpu")
    first = eng.generate(ps, max_new_tokens=6)
    assert len(first) == 3
    eos = first[0][2]                     # make row 0's third token the EOS
    eng.eos_id = eos
    out = eng.generate(ps, max_new_tokens=6)
    assert out[0] == first[0][:first[0].index(eos) + 1]
    for row in out:
        assert eos not in row[:-1]


def test_entry_points_need_a_card_unless_cpu_is_asked(params,
                                                      monkeypatch):
    from repro_torch.models import registry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = configs()
    _, tp = params
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(tcfg, tp, max_batch=8)
    with pytest.raises(RuntimeError, match="cuda"):
        registry.init_params(tcfg, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        registry.init_cache(tcfg, 8, 16)
    ServeEngine(tcfg, tp, max_batch=8, device="cpu")
    registry.init_params(tcfg, seed=0, device="cpu")


@pytest.fixture(scope="module")
def dense():
    jp, tp = dense_params(seed=1)
    return jax.tree_util.tree_map(jnp.asarray, jp), tp


def test_dense_weight_generate_equals_reference(dense, monkeypatch):
    """Unpacked weights, gemm_impl="pallas": the prefill MLP (M = 8·6 =
    48) takes ``sta``, decode ``skinny_sta``, no DBB route runs; tokens
    equal the JAX engine's, and so do the prefill's last-position logits
    within 1e-4."""
    jcfg, tcfg = configs()
    jp, tp = dense
    ps = prompts([6, 3, 6, 2, 5, 1, 6, 4], seed=21)
    want = JEngine(jcfg, jp, max_batch=8).generate(ps, max_new_tokens=10)
    seen = set()
    real = dispatch.select

    def spy(spec, cfg_routes=None):
        name, reasons = real(spec, cfg_routes)
        if spec.domain == "matmul":
            seen.add(name)
        return name, reasons
    monkeypatch.setattr(dispatch, "select", spy)
    got = ServeEngine(tcfg, tp, max_batch=8, device="cpu").generate(
        ps, max_new_tokens=10)
    assert got == want
    assert seen == {"sta", "skinny_sta", "xla"}

    tokens = np.zeros((8, 6), np.int32)
    start = np.array([6 - len(p) for p in ps], np.int32)
    for i, p in enumerate(ps):
        tokens[i, start[i]:] = p
    jh, _ = jreg.prefill(jp, jcfg, tokens=jnp.asarray(tokens),
                         cache=jreg.init_cache(jcfg, 8, 7),
                         start=jnp.asarray(start))
    th, _ = treg.prefill(tp, tcfg, torch.from_numpy(tokens),
                         treg.init_cache(tcfg, 8, 7, device="cpu"),
                         start=torch.from_numpy(start))
    head = tp["embed"]["table"].float().T
    want_logits = np.asarray(jh[:, -1]) @ head.numpy()
    got_logits = (th[:, -1].float() @ head).numpy()
    scale = np.abs(want_logits).max()
    np.testing.assert_allclose(got_logits, want_logits, rtol=1e-4,
                               atol=1e-4 * scale)
