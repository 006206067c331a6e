"""The port's train step against the JAX package's, on the CPU.

Both sides start from the reference's `init_params` (carried into the
port through numpy) and read the same batches. olmo-1b smoke and
convnet-dbb smoke, f32:

* the first step's gradients at the projected params equal ``jax.grad``'s
  within 1e-5 of each leaf's max |grad| (the same f32 forward, summed in
  another order);
* five steps whose density bound ramps 8 → 4 give the reference's losses
  within rtol 1e-4 under AdamW (its m / sqrt(v) turns a 1e-9 gradient
  difference into a full-size update, so states are compared loosely),
  and SGD's five-step params within 1e-5 of max |param|;
* microbatched gradients equal the full batch's within 1e-6 of max.

Also: the LM-head CE (`dense_ce_chunked` == `dense_ce`), the remat
policies (the same loss and gradients as none), and the guard against
autograd through a kernel route.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import RunConfig as JRun, ShapeSpec as JShape
from repro.config import TrainConfig as JTrain
from repro.configs import get_config as jget
from repro.dist.collectives import dense_ce as j_dense_ce
from repro.launch.train import train_loop as j_train_loop
from repro.models import registry as jreg
from repro.train.loop import make_loss_fn as j_loss_fn
from repro_torch.config import RunConfig, ShapeSpec, TrainConfig
from repro_torch.configs import get_config as tget
from repro_torch.core.dbb import DbbWeight
from repro_torch.dist.collectives import dense_ce, dense_ce_chunked
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.launch.train import train_loop
from repro_torch.train.loop import (TrainState, init_train_state,
                                    loss_and_grads, make_eval_step,
                                    make_loss_fn, make_train_step)
from repro_torch.train.tree import tree_leaves

ARCHS = ("olmo-1b", "convnet-dbb")
SHAPE = (32, 4)                     # LM seq_len, batch (the CNN takes 64)


def _cfgs(arch, **kw):
    kw = dict(dtype="float32", **kw)
    return (jget(arch, smoke=True).replace(**kw),
            tget(arch, smoke=True).replace(**kw))


def _ref_params(jcfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jreg.init_params(jax.random.PRNGKey(seed), jcfg))


def _batch(arch, step=0, seed=1):
    from repro_torch.data.pipeline import make_pipeline
    _, tcfg = _cfgs(arch)
    return make_pipeline(tcfg, ShapeSpec("t", *SHAPE, "train"),
                         seed=seed).batch_at(step)


def _close_by_leaf(got, want, rel):
    for g, w in zip(tree_leaves(got), want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= rel * scale, (
            np.abs(g - w).max() / scale)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("nnz", [None, 4])
def test_first_step_gradients_match_jax_grad(arch, nnz):
    """Gradients of the loss at the projected params (the STE's gradient),
    leaf by leaf, against jax.grad of the reference's loss."""
    jcfg, tcfg = _cfgs(arch)
    from repro.core.sparsity import apply_dbb_to_tree as j_apply
    p = _ref_params(jcfg)
    k = jcfg.dbb.nnz if nnz is not None else jcfg.dbb.block
    p_eff = jax.tree_util.tree_map(np.asarray, j_apply(
        p, jcfg.dbb, nnz=k, straight_through=False))
    b = _batch(arch)
    (jl, _), jg = jax.value_and_grad(
        j_loss_fn(jcfg, project_dbb=False), has_aux=True)(
        p_eff, {k_: jnp.asarray(v) for k_, v in b.items()})
    tg, tm = loss_and_grads(make_loss_fn(tcfg, project_dbb=False),
                            params_from_numpy(p_eff),
                            {k_: torch.from_numpy(v) for k_, v in b.items()})
    assert float(tm["loss"]) == pytest.approx(float(jl), rel=1e-6)
    _close_by_leaf(tg, jax.tree_util.tree_leaves(jg), 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_ste_loss_gradients_flow_to_the_masters(arch):
    """With the projection inside the loss (``project_dbb=True``, the
    straight-through estimator), every master leaf gets the gradient the
    reference's custom VJP gives."""
    jcfg, tcfg = _cfgs(arch)
    p = _ref_params(jcfg)
    b = _batch(arch)
    nnz = jcfg.dbb.nnz
    (_, _), jg = jax.value_and_grad(j_loss_fn(jcfg, nnz=nnz), has_aux=True)(
        p, {k: jnp.asarray(v) for k, v in b.items()})
    tg, _ = loss_and_grads(make_loss_fn(tcfg, nnz=nnz),
                           params_from_numpy(p),
                           {k: torch.from_numpy(v) for k, v in b.items()})
    _close_by_leaf(tg, jax.tree_util.tree_leaves(jg), 1e-5)


def _run_cfgs(arch, opt, steps=5, **tkw):
    jcfg, tcfg = _cfgs(arch)
    kw = dict(steps=steps, learning_rate=3e-3, optimizer=opt, log_every=1,
              warmup_steps=2, dbb_prune_start=1, dbb_prune_ramp=3, seed=1,
              **tkw)
    return (JRun(model=jcfg, train=JTrain(**kw)),
            RunConfig(model=tcfg, train=TrainConfig(**kw)))


@pytest.mark.parametrize("arch", ARCHS)
def test_five_steps_track_the_reference(arch):
    """train_loop on both sides, AdamW, the bound ramping from 8 to the
    config's nnz (olmo 8, 8, 7, 5, 4; convnet 8, 8, 6, 4, 2): the logged
    losses and grad norms within rtol 1e-4."""
    jrc, trc = _run_cfgs(arch, "adamw")
    p = _ref_params(jrc.model, seed=jrc.train.seed)
    _, jh = j_train_loop(jrc, JShape("t", *SHAPE, "train"),
                         log=lambda *_: None)
    _, th = train_loop(trc, ShapeSpec("t", *SHAPE, "train"),
                       log=lambda *_: None, device="cpu",
                       params=params_from_numpy(p))
    nnz = [h["nnz"] for h in th]
    assert nnz == [h["nnz"] for h in jh]
    assert nnz[:2] == [8, 8] and nnz[-1] == trc.model.dbb.nnz
    for a, b in zip(th, jh):
        assert set(a) == set(b)
        for key in ("loss", "grad_norm", "lr"):
            assert a[key] == pytest.approx(b[key], rel=1e-4), (key, a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_sgd_five_steps_params_match(arch):
    """SGD-momentum has no normalizer to amplify rounding: after five steps
    (the same ramp) every param leaf within 1e-5 of its max |value|."""
    jrc, trc = _run_cfgs(arch, "sgd")
    p = _ref_params(jrc.model, seed=jrc.train.seed)
    js, _ = j_train_loop(jrc, JShape("t", *SHAPE, "train"),
                         log=lambda *_: None)
    ts, _ = train_loop(trc, ShapeSpec("t", *SHAPE, "train"),
                       log=lambda *_: None, device="cpu",
                       params=params_from_numpy(p))
    assert ts.step == int(js.step) == 5
    _close_by_leaf(ts.params, jax.tree_util.tree_leaves(js.params), 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatched_gradients_equal_full_batch(arch, monkeypatch):
    """microbatches=2 accumulates f32 gradients and averages: the
    gradients the step clips equal the full batch's within 1e-6 of each
    leaf's max, and so do the metrics."""
    import repro_torch.train.optimizer as opt_mod
    _, tcfg = _cfgs(arch)
    jp = _ref_params(_cfgs(arch)[0])
    b = {k: torch.from_numpy(v) for k, v in _batch(arch).items()}
    seen = []
    real = opt_mod.clip_by_global_norm

    def spy(tree, max_norm):
        seen.append(tree_leaves(tree))
        return real(tree, max_norm)
    monkeypatch.setattr(opt_mod, "clip_by_global_norm", spy)
    mets = []
    for m in (1, 2):
        rc = RunConfig(model=tcfg, train=TrainConfig(microbatches=m))
        st = init_train_state(rc, device="cpu", params=params_from_numpy(jp))
        mets.append(make_train_step(rc, nnz=4)(st, b)[1])
    for a, c in zip(*seen):
        assert (a - c).abs().max() <= 1e-6 * a.abs().max()
    assert float(mets[1]["loss"]) == pytest.approx(float(mets[0]["loss"]),
                                                   rel=1e-6)


def test_step_builds_a_new_state():
    """A step modifies none of the old state's tensors (a retry starts
    from the same state)."""
    _, tcfg = _cfgs("olmo-1b")
    rc = RunConfig(model=tcfg, train=TrainConfig())
    st = init_train_state(rc, seed=0, device="cpu")
    before = [t.clone() for t in tree_leaves([st.params, st.opt_state])]
    b = {k: torch.from_numpy(v) for k, v in _batch("olmo-1b").items()}
    new, _ = make_train_step(rc, nnz=4)(st, b)
    assert new.step == 1 and st.step == 0
    for t0, t1 in zip(before, tree_leaves([st.params, st.opt_state])):
        assert torch.equal(t0, t1)


@pytest.mark.parametrize("arch", ARCHS)
def test_eval_step_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    from repro.train.loop import make_eval_step as j_eval
    p = _ref_params(jcfg)
    b = _batch(arch, step=100_000)
    nnz = jcfg.dbb.nnz
    jm = j_eval(JRun(model=jcfg), nnz=nnz)(
        p, {k: jnp.asarray(v) for k, v in b.items()})
    tm = make_eval_step(RunConfig(model=tcfg), nnz=nnz)(
        params_from_numpy(p), {k: torch.from_numpy(v) for k, v in b.items()})
    assert set(tm) == set(jm)
    for k in tm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6,
                                             abs=1e-7)


# ---------------------------------------------------------------------------
# the LM-head cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [7, 16, 64])
def test_dense_ce_chunked_equals_dense_ce(rows):
    """Chunked CE (padding the 3·13 = 39 tokens up to a rows multiple):
    the loss and both gradients equal the dense form's within 1e-6, and
    the dense form equals the reference's."""
    g = torch.Generator().manual_seed(0)
    h = torch.randn(3, 13, 24, generator=g, requires_grad=True)
    w = torch.randn(24, 50, generator=g, requires_grad=True)
    lab = torch.randint(0, 50, (3, 13), generator=g)
    mask = (torch.rand(3, 13, generator=g) > 0.2).float()
    a = dense_ce(h, w, lab, mask)
    ga = torch.autograd.grad(a, [h, w])
    c = dense_ce_chunked(h, w, lab, mask, rows=rows)
    gc = torch.autograd.grad(c, [h, w])
    assert float(c.detach()) == pytest.approx(float(a.detach()), rel=1e-6)
    for x, y in zip(gc, ga):
        assert (x - y).abs().max() <= 1e-6 * y.abs().max()
    ref = j_dense_ce(jnp.asarray(h.detach().numpy()),
                     jnp.asarray(w.detach().numpy()),
                     jnp.asarray(lab.numpy()), jnp.asarray(mask.numpy()))
    assert float(a.detach()) == pytest.approx(float(ref), rel=1e-6)


def test_cross_entropy_picks_the_chunked_form(monkeypatch):
    """tokens · V above 2^28 takes `dense_ce_chunked`, else `dense_ce`."""
    import repro_torch.dist.collectives as C
    taken = []
    monkeypatch.setattr(C, "dense_ce_chunked",
                        lambda *a, **k: taken.append("chunked"))
    monkeypatch.setattr(C, "dense_ce", lambda *a, **k: taken.append("dense"))
    h = torch.zeros(1, 4, 2)
    C.cross_entropy(h, torch.zeros(2, 1 << 26), torch.zeros(1, 4).long())
    C.cross_entropy(h, torch.zeros(2, (1 << 26) + 1),
                    torch.zeros(1, 4).long())
    assert taken == ["dense", "chunked"]


# ---------------------------------------------------------------------------
# remat and the autograd guard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", ["full", "dots", "auto"])
def test_remat_keeps_values_and_gradients(remat):
    """Every remat policy gives "none"'s loss and gradients (auto at d_model
    1024 takes the selective policy)."""
    base = tget("olmo-1b", smoke=True).replace(
        d_model=1024, num_heads=8, num_kv_heads=8, d_ff=1536,
        num_layers=2, vocab_size=256)
    rc = RunConfig(model=base.replace(remat="none"))
    params = init_train_state(rc, seed=0, device="cpu").params
    g = torch.Generator().manual_seed(0)
    b = {"tokens": torch.randint(0, 256, (2, 8), generator=g),
         "labels": torch.randint(0, 256, (2, 8), generator=g)}
    res = [loss_and_grads(make_loss_fn(base.replace(remat=r)), params, b)
           for r in ("none", remat)]
    (g0, m0), (g1, m1) = res
    assert torch.equal(m0["loss"], m1["loss"])
    for a, c in zip(tree_leaves(g0), tree_leaves(g1)):
        assert (a - c).abs().max() <= 1e-6 * a.abs().max()


def test_flash_attention_in_the_loss_raises():
    """attn_impl="flash" pins the flash kernel route even on the plain GEMM
    route: the guard refuses to train through it instead of letting its
    CPU version differentiate."""
    _, tcfg = _cfgs("olmo-1b")
    p = init_train_state(RunConfig(model=tcfg), seed=0, device="cpu").params
    b = {k: torch.from_numpy(v) for k, v in _batch("olmo-1b").items()}
    with pytest.raises(RuntimeError, match="attn_flash.*no backward"):
        loss_and_grads(make_loss_fn(tcfg.replace(attn_impl="flash")), p, b)
    # the same forward without gradients (evaluation) is allowed
    make_eval_step(RunConfig(model=tcfg.replace(attn_impl="flash")))(p, b)


def test_kernel_route_pins_in_the_loss_raise():
    """A kernel_routes pin of the dense GEMM onto its kernel, and a conv
    through the conv kernel, refuse operands that require grad; dense
    serving tensors (no grad) pass."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(16, 32, generator=g)
    w = torch.randn(32, 24, generator=g, requires_grad=True)
    cfg = tget("olmo-1b", smoke=True).replace(
        kernel_routes=(("matmul", "sta"),))
    with pytest.raises(RuntimeError, match="'sta'"):
        dispatch.matmul(x, w, cfg=cfg, pallas=True)
    with torch.no_grad():
        dispatch.matmul(x, w, cfg=cfg, pallas=True)
    dispatch.matmul(x, w.detach(), cfg=cfg, pallas=True)
    dispatch.matmul(x, w, cfg=cfg, pallas=False)      # plain: fine
    img = torch.randn(2, 8, 8, 8, generator=g)
    wc = torch.randn(72, 16, generator=g, requires_grad=True)
    ccfg = cfg.replace(kernel_routes=(("conv", "conv_sta"),))
    with pytest.raises(RuntimeError, match="conv_sta"):
        dispatch.conv(img, wc, kh=3, kw=3, cfg=ccfg)
    dispatch.conv(img, wc, kh=3, kw=3, use_kernel=False)


def test_training_forward_takes_no_kernel_route(monkeypatch):
    """A CNN and an LM loss with gemm_impl="pallas" in the config still
    train: the loss forces the plain route, so no kernel route is even
    selected."""
    chosen = []
    real = dispatch.select

    def spy(spec, *a, **k):
        name, d = real(spec, *a, **k)
        chosen.append(name)
        return name, d
    monkeypatch.setattr(dispatch, "select", spy)
    for arch in ARCHS:
        _, tcfg = _cfgs(arch, gemm_impl="pallas")
        p = init_train_state(RunConfig(model=tcfg), seed=0,
                             device="cpu").params
        b = {k: torch.from_numpy(v) for k, v in _batch(arch).items()}
        loss_and_grads(make_loss_fn(tcfg, nnz=4), p, b)
    assert chosen and not set(chosen) & dispatch.KERNEL_ROUTES, set(chosen)


def test_train_state_leaves_are_dense_masters():
    """After a DBB step the masters stay dense (the projection is not
    written back) and no leaf is packed."""
    _, tcfg = _cfgs("convnet-dbb")
    rc = RunConfig(model=tcfg)
    st = init_train_state(rc, seed=0, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch("convnet-dbb").items()}
    new, _ = make_train_step(rc, nnz=2)(st, b)
    assert isinstance(new, TrainState)
    assert not any(isinstance(t, DbbWeight) for t in tree_leaves(new.params))
    assert float((new.params["conv1"]["w"] == 0).float().mean()) < 0.01
