"""The optimizers, schedule, clipping and gradient compression against the
JAX package's, on the same gradients.

Tolerances: updates and states within 1e-6 of each leaf's max |value| for
three steps (f32 arithmetic in the same order; the last digit may differ
where XLA fuses). The schedule within 5e-7 relative (4 f32 ulps: torch's
and XLA's cos may differ in the last bits). Compression round
trips bit-equal (bf16) or within one INT8 step's rounding of the scale's
last bit (int8_ef)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrain
from repro.train import grad_compress as jgc
from repro.train import optimizer as jopt
from repro_torch.config import TrainConfig
from repro_torch.train import grad_compress as tgc
from repro_torch.train import optimizer as topt
from repro_torch.train.tree import tree_leaves


def _tree(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"layers": {"w": f(2, 16, 8), "b": f(2, 8)},
            "head": {"w": f(8, 12)}, "scale": f(12)}


def _close(got, want, rel=1e-6):
    gl, wl = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.abs(g - w).max() <= rel * max(np.abs(w).max(), 1e-30)


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


@pytest.mark.parametrize("opt", ["adamw", "adafactor", "sgd"])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_three_steps_match(opt, wd):
    kw = dict(optimizer=opt, learning_rate=1e-2, warmup_steps=2, steps=10,
              weight_decay=wd)
    jinit, jupd = jopt.make_optimizer(JTrain(**kw))
    tinit, tupd = topt.make_optimizer(TrainConfig(**kw))
    jp, tp = _tree(0), _torch(_tree(0))
    js, ts_ = jinit(jp), tinit(tp)
    _close(ts_, js)
    for step in range(3):
        g = _tree(step + 10)
        jups, js = jupd(g, js, jp, jnp.asarray(step))
        tups, ts_ = tupd(_torch(g), ts_, tp, step)
        _close(tups, jups)
        _close(ts_, js)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, jups)
        tp = jax.tree_util.tree_map(lambda p, u: p + u, tp, tups)
    _close(tp, jp)


def test_adafactor_state_is_factored():
    init, _ = topt.make_optimizer(TrainConfig(optimizer="adafactor"))
    st = init({"w": torch.zeros(3, 64, 32), "b": torch.zeros(64)})
    assert st["s"]["w"]["vr"].shape == (3, 64)
    assert st["s"]["w"]["vc"].shape == (3, 32)
    assert st["s"]["b"]["v"].shape == (64,)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        topt.make_optimizer(TrainConfig(optimizer="lamb"))


@pytest.mark.parametrize("warm,total", [(0, 1), (10, 100), (5, 5), (3, 40)])
def test_lr_schedule_matches(warm, total):
    kw = dict(learning_rate=3e-3, warmup_steps=warm, steps=total)
    jf, tf = jopt.lr_schedule(JTrain(**kw)), topt.lr_schedule(
        TrainConfig(**kw))
    for step in range(0, total + 5):
        got, want = tf(step), jf(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), rel=5e-7)


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 1e6])
def test_clip_and_global_norm_match(max_norm):
    g = _tree(3)
    jg, jn = jopt.clip_by_global_norm(g, max_norm)
    tg, tn = topt.clip_by_global_norm(_torch(g), max_norm)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    assert float(topt.global_norm(_torch(g))) == pytest.approx(
        float(jopt.global_norm(g)), rel=1e-6)
    _close(tg, jg)


def test_bf16_compression_is_bit_equal():
    g = _tree(4)
    jg, jef = jgc.compress_grads(g, None, "bf16")
    tg, tef = tgc.compress_grads(_torch(g), None, "bf16")
    assert jef is None and tef is None
    for a, b in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    same, ef = tgc.compress_grads(_torch(g), None, "none")
    assert ef is None and tree_leaves(same)[0].shape == (8, 12)


def test_int8_ef_matches_over_steps():
    """Three steps of INT8 + error feedback: what is sent and the carried
    error equal the reference's (within one f32 rounding of a scale)."""
    p = _tree(0)
    jef = jgc.init_ef_state(p, "int8_ef")
    tef = tgc.init_ef_state(_torch(p), "int8_ef")
    assert tgc.init_ef_state(_torch(p), "bf16") is None
    for step in range(3):
        g = _tree(step + 20)
        js_, jef = jgc.compress_grads(g, jef, "int8_ef")
        ts_, tef = tgc.compress_grads(_torch(g), tef, "int8_ef")
        _close(ts_, js_, rel=1e-6)
        _close(tef, jef, rel=1e-5)
    assert tgc.wire_bytes_per_elem("int8_ef") == 1.0
    with pytest.raises(ValueError):
        tgc.compress_grads(_torch(p), None, "fp8")
