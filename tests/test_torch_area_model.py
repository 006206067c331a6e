"""The STA area / power model against the JAX package's: the PE resource
counts, Table II, the Fig. 5 sweep and the calibration fit are equal
(plain float arithmetic in the same order: exact equality)."""
import dataclasses

import pytest

from repro.core import area_model as J
from repro.core import sta as jsta
from repro_torch.config import StaConfig
from repro_torch.core import area_model as T
from repro_torch.core import sta as tsta


@pytest.mark.parametrize("abc", [(1, 1, 1), (4, 8, 4), (2, 16, 8), (8, 4, 1)])
def test_pe_resources_equal(abc):
    a, b, c = abc
    assert dataclasses.asdict(tsta.sa_pe_resources()) == \
        dataclasses.asdict(jsta.sa_pe_resources())
    assert dataclasses.asdict(tsta.sta_pe_resources(a, b, c)) == \
        dataclasses.asdict(jsta.sta_pe_resources(a, b, c))
    for nnz in range(1, b + 1):
        assert dataclasses.asdict(tsta.dbb_pe_resources(a, b, c, nnz)) == \
            dataclasses.asdict(jsta.dbb_pe_resources(a, b, c, nnz))


@pytest.mark.parametrize("act", [0.0, 0.5, 0.8])
def test_table2_equal(act):
    assert T.table2(act_sparsity=act) == J.table2(act_sparsity=act)
    assert T.PAPER_TABLE2 == J.PAPER_TABLE2
    assert dataclasses.asdict(T.DEFAULT_PARAMS) == \
        dataclasses.asdict(J.DEFAULT_PARAMS)


def test_evaluate_design_equal_on_every_kind():
    for d in J._standard_designs():
        td = T.DesignPoint(**dataclasses.asdict(d))
        assert T.evaluate_design(td) == J.evaluate_design(d)


def test_fig5_sweep_equal():
    got, want = T.fig5_sweep(), J.fig5_sweep()
    assert len(got) == len(want) == 79
    assert got == want


@pytest.mark.parametrize("seed", [0, 3])
def test_fit_calibration_equal(seed):
    gp, gl = T.fit_calibration(seed=seed, iters=200)
    wp, wl = J.fit_calibration(seed=seed, iters=200)
    assert gl == wl
    assert dataclasses.asdict(gp) == dataclasses.asdict(wp)


def test_sta_config_fields():
    from repro.config import StaConfig as JSta
    assert dataclasses.asdict(StaConfig()) == dataclasses.asdict(JSta())
    assert StaConfig().macs_per_pe() == JSta().macs_per_pe() == 128
