"""Checkpoints in the JAX package's format: round trips, atomic writes,
pruning, a bit-exact resume on the CPU, and checkpoints that cross between
the two packages in both directions (bit-equal leaves)."""
import os

import jax
import numpy as np
import pytest
import torch

from repro.config import RunConfig as JRun
from repro.configs import get_config as jget
from repro.train import checkpoint as jck
from repro.train.loop import init_train_state as j_init
from repro_torch.config import RunConfig, ShapeSpec, TrainConfig
from repro_torch.configs import get_config as tget
from repro_torch.interop import params_from_numpy
from repro_torch.launch.train import train_loop
from repro_torch.train import checkpoint as ck
from repro_torch.train.loop import TrainState, init_train_state
from repro_torch.train.tree import tree_leaves


def _state(optimizer="adamw", compress="none"):
    cfg = tget("convnet-dbb", smoke=True)
    rc = RunConfig(model=cfg, train=TrainConfig(optimizer=optimizer,
                                                grad_compress=compress))
    st = init_train_state(rc, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    return TrainState(
        params=st.params,
        opt_state=jax.tree_util.tree_map(
            lambda t: torch.randn(t.shape, generator=g), st.opt_state),
        ef=st.ef, step=7)


def _bits_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("opt,compress", [("adamw", "none"),
                                          ("adafactor", "none"),
                                          ("sgd", "int8_ef")])
def test_round_trip(tmp_path, opt, compress):
    st = _state(opt, compress)
    path = ck.save(str(tmp_path), 7, st, {"note": "x"})
    assert os.path.basename(path) == "step_000000007"
    names = sorted(os.listdir(path))
    assert names[-1] == "meta.json" and names[0] == "leaf_00000.npy"
    blank = _state(opt, compress)
    blank = TrainState(params=jax.tree_util.tree_map(torch.zeros_like,
                                                     blank.params),
                       opt_state=blank.opt_state, ef=blank.ef, step=0)
    got, meta = ck.restore(str(tmp_path), blank)
    _bits_equal(got, st)
    assert meta["step"] == 7 and meta["extra"] == {"note": "x"}
    assert meta["num_leaves"] == len(tree_leaves(st))


def test_bf16_leaves_round_trip_exactly(tmp_path):
    """A bf16 leaf is stored as f32 (exact) and cast back."""
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(5, 3, generator=g).to(torch.bfloat16),
            "b": {"c": torch.randn(4, generator=g)}}
    ck.save(str(tmp_path), 1, tree)
    arr = np.load(tmp_path / "step_000000001" / "leaf_00000.npy")
    assert arr.dtype == np.float32
    got, _ = ck.restore(str(tmp_path), {"a": torch.zeros(5, 3,
                                                          dtype=torch.bfloat16),
                                        "b": {"c": torch.zeros(4)}})
    _bits_equal(got, tree)
    # the reference reads it into a bf16 template with the same bits
    jt = {"a": jax.numpy.zeros((5, 3), jax.numpy.bfloat16),
          "b": {"c": jax.numpy.zeros((4,))}}
    jgot, _ = jck.restore(str(tmp_path), jt)
    assert np.asarray(jgot["a"]).view(np.uint16).tobytes() == \
        tree["a"].view(torch.int16).numpy().tobytes()


def test_reference_bf16_leaf_restores(tmp_path):
    a = np.random.default_rng(0).standard_normal((6, 2)).astype(np.float32)
    jtree = {"w": jax.numpy.asarray(a).astype(jax.numpy.bfloat16)}
    jck.save(str(tmp_path), 2, jtree)
    got, _ = ck.restore(str(tmp_path),
                        {"w": torch.zeros(6, 2, dtype=torch.bfloat16)})
    assert got["w"].view(torch.int16).numpy().tobytes() == \
        np.asarray(jtree["w"]).view(np.uint16).tobytes()


def test_atomic_save_and_prune(tmp_path, monkeypatch):
    """A save that dies mid-write leaves the latest complete checkpoint in
    place; older steps are pruned to keep_last."""
    root = str(tmp_path)
    st = _state()
    for s in (1, 2, 3, 4):
        ck.save(root, s, st, keep_last=2)
    assert ck.available_steps(root) == [3, 4]
    calls = {"n": 0}
    real = np.save

    def dying_save(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise OSError("disk gone")
        return real(*a, **k)
    monkeypatch.setattr(np, "save", dying_save)
    with pytest.raises(OSError):
        ck.save(root, 5, st, keep_last=2)
    monkeypatch.setattr(np, "save", real)
    assert ck.latest_step(root) == 4
    got, _ = ck.restore(root, _state())
    _bits_equal(got, st)
    assert ck.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ck.restore(str(tmp_path / "none"), st)


def test_template_mismatch_raises(tmp_path):
    ck.save(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="leaves"):
        ck.restore(str(tmp_path), {"a": torch.zeros(3), "b": torch.zeros(1)})
    with pytest.raises(ValueError, match="stored"):
        ck.restore(str(tmp_path), {"a": torch.zeros(4)})


def test_manager_cadence(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), save_every=3, keep_last=5)
    st = {"a": torch.ones(2)}
    saved = [s for s in range(0, 10) if mgr.maybe_save(s, st)]
    assert saved == [3, 6, 9]
    assert mgr.maybe_save(10, st, force=True)
    assert ck.available_steps(str(tmp_path)) == [3, 6, 9, 10]


def _cnn_run(steps, ckdir="", every=0):
    cfg = tget("lenet5-dbb", smoke=True)
    rc = RunConfig(model=cfg, train=TrainConfig(
        steps=steps, learning_rate=1e-2, log_every=1, seed=3,
        checkpoint_dir=ckdir, checkpoint_every=every, dbb_prune_start=1,
        dbb_prune_ramp=3))
    return train_loop(rc, ShapeSpec("t", 16, 8, "train"),
                      log=lambda *_: None, device="cpu")


def test_resume_from_a_periodic_checkpoint_is_bit_exact(tmp_path):
    """6 straight steps == 6 steps saving every 3, the final checkpoint
    dropped, then a resume from step 3: the same params, optimizer state
    and logged losses, bit for bit."""
    straight, sh = _cnn_run(6)
    d = str(tmp_path / "ck")
    first, fh = _cnn_run(6, d, every=3)
    assert ck.available_steps(d) == [3, 6]
    import shutil
    shutil.rmtree(os.path.join(d, "step_000000006"))
    resumed, rh = _cnn_run(6, d, every=3)
    assert [h["step"] for h in rh] == [3, 4, 5]
    assert [h["loss"] for h in rh] == [h["loss"] for h in sh[3:]]
    _bits_equal(resumed, straight)
    _bits_equal(first, straight)


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A reference TrainState checkpoint restores into the port's TrainState
    (same leaf count, bit-equal leaves) and the port's into the
    reference's."""
    jcfg = jget("convnet-dbb", smoke=True)
    jst = j_init(jax.random.PRNGKey(0), JRun(model=jcfg))
    jst = jst.__class__(params=jst.params,
                        opt_state=jax.tree_util.tree_map(
                            lambda a: a + 0.5, jst.opt_state),
                        ef=None, step=jax.numpy.asarray(9, jax.numpy.int32))
    jck.save(str(tmp_path / "j"), 9, jst)
    tcfg = tget("convnet-dbb", smoke=True)
    template = init_train_state(RunConfig(model=tcfg), seed=1, device="cpu")
    got, meta = ck.restore(str(tmp_path / "j"), template)
    assert got.step == 9 and meta["step"] == 9
    for a, b in zip(tree_leaves(got),
                    jax.tree_util.tree_leaves(jst)):
        want = np.asarray(b)
        if isinstance(a, torch.Tensor):
            assert a.numpy().tobytes() == want.tobytes()
        else:
            assert a == int(want)
    # and back: the port writes, the reference reads
    ck.save(str(tmp_path / "t"), 9, got)
    jback, _ = jck.restore(str(tmp_path / "t"), jst)
    for a, b in zip(jax.tree_util.tree_leaves(jback),
                    jax.tree_util.tree_leaves(jst)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    ported = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                      jst.params))
    _bits_equal(got.params, ported)
