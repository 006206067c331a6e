"""Analytical area/power model reproducing the paper's Table II and Fig. 5.

The paper synthesizes RTL in TSMC 16nm (Design Compiler + PrimeTimePX).
This model reproduces the *evaluation methodology* analytically instead:
per-PE resource counts (`core/sta.py`) × per-unit area/energy costs, with
gate-count priors refined by a calibration fit against the paper's own
reported numbers:

  Table II (iso-throughput, 50% sparse activations, normalized to gated SA):
    SA-NCG 1×1×1: area eff 0.95, power eff 0.65
    SA     1×1×1: 1.00 / 1.00 (baseline)
    STA    4×8×4: 2.08 / 1.36
    SMT-SA T2Q4 : 1.21 / 0.80   (62.5% random-sparse weights)
    STA-DBB 4×8×4 (50% DBB): 3.14 / 1.97

Units are arbitrary (normalized out); only ratios matter, exactly as in the
paper. `fit_calibration()` documents how constants were obtained. Plain
float and numpy arithmetic, the JAX package's term for term, so its
numbers are equal.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core import sta as sta_geom

__all__ = [
    "CostParams", "DEFAULT_PARAMS", "DesignPoint", "evaluate_design",
    "table2", "fig5_sweep", "fit_calibration", "PAPER_TABLE2",
]


@dataclasses.dataclass(frozen=True)
class CostParams:
    """Per-unit costs. Defaults are the `fit_calibration(seed=3)` result
    (loss 0.014 ≈ 3.4% mean relative error over the 12 paper targets),
    starting from gate-count priors: INT8 mult ~260 GE, INT32 adder ~210 GE,
    FF ~6.4 GE/bit."""
    # --- area (gate-equivalents) ---
    a_mult: float = 600.0      # INT8×INT8 multiplier
    a_add32: float = 400.0     # INT32 accumulate adder
    a_addt_per_bit: float = 3.559   # adder-tree adder, per output bit
    a_ff: float = 12.0         # per flip-flop bit
    a_mux_leg: float = 7.022   # per 8-bit mux input leg
    a_fifo_bit: float = 6.0    # FIFO storage + control, per bit
    a_gate_ctrl: float = 24.0  # clock-gating control per gated operand reg
    a_pe_overhead: float = 30.18  # per-PE pipeline/control overhead
    # --- dynamic power (normalized energy/cycle at 100% activity) ---
    p_mult: float = 1.8201
    p_add32: float = 0.05
    p_addt_per_bit: float = 0.11358
    p_ff: float = 0.026271     # data switching per FF bit
    p_clk_ff: float = 0.017238  # clock-tree load per FF bit
    p_mux_leg: float = 0.13981
    p_fifo_bit: float = 0.004
    p_pe_overhead: float = 0.31918


DEFAULT_PARAMS = CostParams()

# Paper Table II, exactly as printed.
PAPER_TABLE2 = {
    "SA-NCG 1x1x1": (0.95, 0.65),
    "SA 1x1x1": (1.00, 1.00),
    "STA 4x8x4": (2.08, 1.36),
    "SMT-SA T2Q4": (1.21, 0.80),
    "STA-DBB 4x8x4": (3.14, 1.97),
}


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    name: str
    kind: str                   # "sa" | "sa_ncg" | "sta" | "sta_dbb" | "smt"
    a: int = 1
    b: int = 1
    c: int = 1
    nnz: int = 0                # sta_dbb: density bound
    threads: int = 2            # smt
    queue: int = 4              # smt
    weight_sparsity: float = 0.0


def _resources(d: DesignPoint) -> sta_geom.PeResources:
    if d.kind in ("sa", "sa_ncg"):
        return sta_geom.sa_pe_resources()
    if d.kind == "sta":
        return sta_geom.sta_pe_resources(d.a, d.b, d.c)
    if d.kind == "sta_dbb":
        return sta_geom.dbb_pe_resources(d.a, d.b, d.c, d.nnz)
    if d.kind == "smt":
        # SMT-SA: T threads share one multiplier; non-zero *weights* wait in
        # a Q-deep FIFO per thread, activations stream through one register
        # per thread. Speedup min(T, 1/(1-s)) degraded by queue stalls.
        fifo_bits = d.threads * d.queue * 8
        acc_ff = d.threads * 32
        s = d.weight_sparsity
        ideal = min(d.threads, 1.0 / max(1e-6, 1.0 - s))
        stall = 1.0 - 0.5 / max(1, d.queue)       # deeper queue, fewer stalls
        eff = max(1.0, ideal * stall)
        return sta_geom.PeResources(
            macs=1, eff_macs=eff, operand_ff=d.threads * 8,
            acc_ff=acc_ff, tree_adds=0, acc_adds=1,
            mux_inputs=8 * d.threads, fifo_bits=fifo_bits)
    raise ValueError(d.kind)


def _tree_adder_bits(b: int) -> float:
    """Total adder output bits in a B-input product tree (16-bit products)."""
    bits, width, cnt = 0.0, 17, b // 2
    while cnt >= 1:
        bits += cnt * width
        width += 1
        if cnt == 1:
            break
        cnt //= 2
    return bits


def evaluate_design(d: DesignPoint, p: CostParams = DEFAULT_PARAMS,
                    act_sparsity: float = 0.5) -> Dict[str, float]:
    """Absolute area and power per *effective* MAC (pre-normalization)."""
    r = _resources(d)
    gated = d.kind != "sa_ncg"

    tree_bits = 0.0
    if r.tree_adds:
        per_unit_bits = _tree_adder_bits(d.b if d.kind == "sta" else d.nnz)
        units = r.tree_adds / max(1, (d.b if d.kind == "sta" else d.nnz) - 1)
        tree_bits = per_unit_bits * units

    area = (r.macs * p.a_mult
            + r.acc_adds * p.a_add32
            + tree_bits * p.a_addt_per_bit
            + (r.operand_ff + r.index_ff + r.acc_ff) * p.a_ff
            + r.mux_inputs * p.a_mux_leg
            + r.fifo_bits * p.a_fifo_bit
            + p.a_pe_overhead)
    if gated:
        # one gating cell per operand register word (8b)
        area += (r.operand_ff / 8) * p.a_gate_ctrl / 8

    act = (1.0 - act_sparsity) if gated else 1.0
    datapath_activity = act
    power = (r.macs * p.p_mult * datapath_activity
             + r.acc_adds * p.p_add32 * datapath_activity
             + tree_bits * p.p_addt_per_bit * datapath_activity
             + (r.operand_ff + r.index_ff) * p.p_ff * act
             + r.acc_ff * p.p_ff * datapath_activity
             + (r.operand_ff + r.index_ff + r.acc_ff) * p.p_clk_ff
             + r.mux_inputs * p.p_mux_leg * datapath_activity
             + r.fifo_bits * (p.p_fifo_bit + p.p_clk_ff)
             + p.p_pe_overhead)

    return {
        "area_per_eff_mac": area / r.eff_macs,
        "power_per_eff_mac": power / r.eff_macs,
        "area_regs_frac": (r.operand_ff + r.index_ff + r.acc_ff + r.fifo_bits)
                          * p.a_ff / area,
        "power_regs_frac": ((r.operand_ff + r.index_ff) * p.p_ff * act
                            + r.acc_ff * p.p_ff * datapath_activity
                            + (r.operand_ff + r.index_ff + r.acc_ff)
                            * p.p_clk_ff
                            + r.fifo_bits * (p.p_fifo_bit + p.p_clk_ff))
                           / power,
        "eff_macs": r.eff_macs,
        "phys_macs": r.macs,
    }


def _standard_designs() -> List[DesignPoint]:
    return [
        DesignPoint("SA-NCG 1x1x1", "sa_ncg"),
        DesignPoint("SA 1x1x1", "sa"),
        DesignPoint("STA 4x8x4", "sta", a=4, b=8, c=4),
        DesignPoint("SMT-SA T2Q4", "smt", threads=2, queue=4,
                    weight_sparsity=0.625),
        DesignPoint("STA-DBB 4x8x4", "sta_dbb", a=4, b=8, c=4, nnz=4,
                    weight_sparsity=0.5),
    ]


def table2(p: CostParams = DEFAULT_PARAMS,
           act_sparsity: float = 0.5) -> Dict[str, Tuple[float, float]]:
    """Throughput-normalized area/power *efficiency* vs the gated SA baseline
    (higher is better) — the exact quantity in the paper's Table II."""
    base = evaluate_design(DesignPoint("SA 1x1x1", "sa"), p, act_sparsity)
    out = {}
    for d in _standard_designs():
        m = evaluate_design(d, p, act_sparsity)
        out[d.name] = (base["area_per_eff_mac"] / m["area_per_eff_mac"],
                       base["power_per_eff_mac"] / m["power_per_eff_mac"])
    return out


def fig5_sweep(p: CostParams = DEFAULT_PARAMS,
               act_sparsity: float = 0.5) -> List[Dict[str, float]]:
    """Fig. 5 analogue: sweep tensor-PE dims, report area/power at
    iso-throughput (lower is better, normalized to SA) with STA and
    STA-DBB(50%) variants."""
    base = evaluate_design(DesignPoint("SA 1x1x1", "sa"), p, act_sparsity)
    rows = []
    for a, b, c in itertools.product((1, 2, 4, 8), (1, 2, 4, 8, 16), (1, 2, 4, 8)):
        if a * b * c == 1 or a * b * c > 1024:
            continue
        sta = evaluate_design(DesignPoint(f"STA {a}x{b}x{c}", "sta",
                                          a=a, b=b, c=c), p, act_sparsity)
        row = dict(a=a, b=b, c=c,
                   sta_area=sta["area_per_eff_mac"] / base["area_per_eff_mac"],
                   sta_power=sta["power_per_eff_mac"] / base["power_per_eff_mac"])
        if b % 2 == 0 and b >= 2:
            dbb = evaluate_design(
                DesignPoint(f"STA-DBB {a}x{b}x{c}", "sta_dbb", a=a, b=b, c=c,
                            nnz=b // 2, weight_sparsity=0.5), p, act_sparsity)
            row["dbb_area"] = dbb["area_per_eff_mac"] / base["area_per_eff_mac"]
            row["dbb_power"] = dbb["power_per_eff_mac"] / base["power_per_eff_mac"]
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Calibration: refine gate-count priors against the paper's reported table.
# ---------------------------------------------------------------------------

# Fields refined by the fit, with physically-sensible bounds (gate-count
# priors: INT8 mult 200-600 GE, INT32 adder ~0.3-1x mult, FF 5-12 GE/bit,
# a FIFO bit costs at least an FF bit, every unit dissipates something).
_FIT_BOUNDS = {
    "a_mult": (200.0, 600.0),
    "a_add32": (80.0, 400.0),
    "a_addt_per_bit": (2.0, 12.0),
    "a_ff": (5.0, 12.0),
    "a_mux_leg": (1.0, 24.0),
    "a_fifo_bit": (6.0, 20.0),
    "a_pe_overhead": (5.0, 120.0),
    "p_mult": (0.5, 2.0),
    "p_add32": (0.05, 1.0),
    "p_addt_per_bit": (0.002, 0.12),
    "p_ff": (0.005, 0.12),
    "p_clk_ff": (0.005, 0.12),
    "p_fifo_bit": (0.004, 0.06),
    "p_mux_leg": (0.002, 0.2),
    "p_pe_overhead": (0.01, 0.5),
}
_FIT_FIELDS = tuple(_FIT_BOUNDS)


def _loss(p: CostParams) -> float:
    t2 = table2(p)
    err = 0.0
    for name, (pa, pp) in PAPER_TABLE2.items():
        ma, mp = t2[name]
        err += ((ma - pa) / pa) ** 2 + ((mp - pp) / pp) ** 2
    sa = evaluate_design(DesignPoint("SA 1x1x1", "sa"), p)
    # Fig. 5 text: SA has 36% of area and 54.3% of power in registers.
    err += ((sa["area_regs_frac"] - 0.36) / 0.36) ** 2
    err += ((sa["power_regs_frac"] - 0.543) / 0.543) ** 2
    return err


def fit_calibration(seed: int = 0, iters: int = 4000,
                    start: CostParams = DEFAULT_PARAMS) -> Tuple[CostParams, float]:
    """Coordinate-wise stochastic hill-climb on the relative-error loss.

    Used once to derive DEFAULT_PARAMS; kept here so the calibration is
    reproducible.
    """
    rng = np.random.default_rng(seed)
    best, best_loss = start, _loss(start)
    cur = dataclasses.asdict(start)
    for i in range(iters):
        f = _FIT_FIELDS[rng.integers(len(_FIT_FIELDS))]
        trial = dict(cur)
        scale = 1.0 + rng.normal() * (0.25 if i < iters // 2 else 0.08)
        lo, hi = _FIT_BOUNDS[f]
        trial[f] = float(np.clip(trial[f] * abs(scale), lo, hi))
        cand = CostParams(**trial)
        l = _loss(cand)
        if l < best_loss:
            best, best_loss, cur = cand, l, trial
    return best, best_loss
