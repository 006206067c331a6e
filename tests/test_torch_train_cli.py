"""The training CLI and its fault-tolerance pieces against the JAX
package's: the parser's flags and defaults, `train_loop`'s metric lines
(keys and, from the same initial weights, losses within rtol 1e-4 over
six AdamW steps with the bound annealing), the sparsity report at the
end, the refusals (a malformed ``--mesh``, no card), `StragglerMonitor` and
`retry_step` (device faults are never retried)."""
import argparse
import json
import signal

import jax
import numpy as np
import pytest
import torch

from repro.config import RunConfig as JRun, ShapeSpec as JShape
from repro.config import TrainConfig as JTrain
from repro.configs import get_config as jget
from repro.launch import train as jtrain
from repro.models import registry as jreg
from repro.train import fault_tolerance as jft
from repro_torch.config import RunConfig, ShapeSpec, TrainConfig
from repro_torch.configs import get_config as tget
from repro_torch.interop import params_from_numpy
from repro_torch.launch import train as ttrain
from repro_torch.train import fault_tolerance as tft


class _Captured(Exception):
    pass


def _reference_parser(monkeypatch) -> argparse.ArgumentParser:
    """The parser the reference's ``main`` builds, caught at parse time."""
    seen = {}

    def catch(self, argv=None, namespace=None):
        seen["parser"] = self
        raise _Captured
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Captured):
        jtrain.main(["--arch", "olmo-1b"])
    monkeypatch.undo()
    return seen["parser"]


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices,
                     a.required, a.nargs, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


def test_parser_takes_the_reference_flags_and_defaults(monkeypatch):
    assert _options(ttrain.build_parser()) == _options(
        _reference_parser(monkeypatch))
    args = ttrain.build_parser().parse_args(["--arch", "olmo-1b", "--full"])
    assert not args.smoke and args.steps == 50 and args.mesh == "none"


def test_train_loop_logs_the_reference_metrics():
    """convnet-dbb smoke, 6 AdamW steps, the bound annealing 8 → 2: the
    same metric keys in every line, the same nnz, losses within rtol
    1e-4 (both sides start from the reference's initial weights)."""
    kw = dict(steps=6, learning_rate=3e-3, log_every=1, seed=2,
              dbb_prune_start=1, dbb_prune_ramp=3)
    jcfg = jget("convnet-dbb", smoke=True)
    tcfg = tget("convnet-dbb", smoke=True)
    jlog, tlog = [], []
    _, jh = jtrain.train_loop(JRun(model=jcfg, train=JTrain(**kw)),
                              JShape("t", 16, 32, "train"), log=jlog.append)
    p = jax.tree_util.tree_map(
        np.asarray, jreg.init_params(jax.random.PRNGKey(2), jcfg))
    _, th = ttrain.train_loop(RunConfig(model=tcfg, train=TrainConfig(**kw)),
                              ShapeSpec("t", 16, 32, "train"),
                              log=tlog.append, device="cpu",
                              params=params_from_numpy(p))
    assert len(th) == len(jh) == 6
    for a, b, line in zip(th, jh, tlog):
        assert list(a) == list(b)
        assert json.loads(line) == a
        assert a["nnz"] == b["nnz"] and a["step"] == b["step"]
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
        assert a["acc"] == pytest.approx(b["acc"], abs=1e-6)
    assert th[-1]["nnz"] == 2 and th[-1]["loss"] < th[0]["loss"]


def test_main_runs_and_reports_sparsity(capsys):
    """``main`` on the CPU: JSON metric lines, then the reference's
    sparsity line (the masters stay dense: ~0 zeros)."""
    lines, rep = [], {}
    rc = ttrain.main(["--arch", "lenet5-dbb", "--steps", "3",
                      "--dbb-ramp", "2", "--optimizer", "sgd"],
                     device="cpu", log=lines.append, report=rep)
    assert rc == 0
    assert json.loads(lines[0])["step"] == 0
    assert lines[-1].startswith("sparsity (first 5 leaves): ")
    rep_json = json.loads(lines[-1].split(": ", 1)[1])
    assert set(rep_json) <= {"conv0/w", "conv1/w", "fc/w"}
    assert rep["state"].step == 3
    rep2 = {}
    ttrain.main(["--arch", "lenet5-dbb", "--steps", "1", "--dense"],
                device="cpu", log=lines.append, report=rep2)
    assert not rep2["cfg"].dbb.enabled


def test_refusals(monkeypatch):
    # --mesh DxM trains (tests/test_torch_tp_train.py); a mesh that is not
    # one exits before any rank starts
    with pytest.raises(SystemExit, match="expected none or DxM"):
        ttrain.main(["--arch", "olmo-1b", "--mesh", "2by4"], device="cpu")
    with pytest.raises(SystemExit, match="axis sizes must be positive"):
        ttrain.main(["--arch", "olmo-1b", "--mesh", "0x2"], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ttrain.main(["--arch", "lenet5-dbb", "--steps", "1"])


def test_straggler_monitor_matches_reference():
    times = [1.0, 1.2, 0.9, 1.1, 5.0, 1.0, 0.95, 3.1, 1.05, 9.0]
    a, b = tft.StragglerMonitor(), jft.StragglerMonitor()
    assert [a.update(i, t) for i, t in enumerate(times)] == \
        [b.update(i, t) for i, t in enumerate(times)]
    assert a.straggler_steps == b.straggler_steps == 3
    assert a.mean_step_time == b.mean_step_time
    assert a.last_flagged == b.last_flagged == 9


def test_retry_step_retries_transients_only():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("collective timed out")
        return "ok"
    assert tft.retry_step(flaky, retries=2, backoff_s=0.0) == "ok"
    assert len(calls) == 3
    for msg in ("CUDA error: an illegal memory access was encountered",
                "dbb_gemm launch failed: cudaError 700",
                "CUBLAS_STATUS_EXECUTION_FAILED"):
        seen = []

        def fault(msg=msg):
            seen.append(1)
            raise RuntimeError(msg)
        with pytest.raises(RuntimeError):
            tft.retry_step(fault, retries=3, backoff_s=0.0)
        assert len(seen) == 1, msg
    with pytest.raises(ValueError):
        tft.retry_step(lambda: (_ for _ in ()).throw(ValueError("x")))


def test_preemption_guard_flags_and_restores():
    prev = signal.getsignal(signal.SIGUSR1)
    with tft.PreemptionGuard(signals=(signal.SIGUSR1,)) as g:
        assert not g.should_stop
        signal.raise_signal(signal.SIGUSR1)
        assert g.should_stop
    assert signal.getsignal(signal.SIGUSR1) == prev
