"""Per-PE resources of the paper's systolic arrays (§III-B, Fig. 2/3).

The paper's ``A×B×C @ M×N`` is an M×N grid of tensor PEs, each an A×C
array of B-input dot-product units, output-stationary. These functions
count one PE's datapath units and register bits per effective MAC — what
the analytical area model (`core/area_model.py`) prices. The JAX
package's TPU tiling helpers in the same module (`choose_block_shape`,
`mxu_utilization`, the VMEM budgets) are Pallas block-shape rules; the
CUDA bodies carry their own.
"""
from __future__ import annotations

import dataclasses

__all__ = ["PeResources", "sa_pe_resources", "sta_pe_resources",
           "dbb_pe_resources"]


@dataclasses.dataclass(frozen=True)
class PeResources:
    """Per-PE resource counts, normalized per effective MAC/cycle.

    Units: flip-flop bits and datapath units; the area model multiplies
    them by calibrated per-unit costs.
    """
    macs: int                # physical multipliers
    eff_macs: int            # effective MACs/cycle (throughput)
    operand_ff: int          # operand pipeline register bits
    acc_ff: int              # accumulator register bits
    tree_adds: int           # adder-tree 2-input adders (narrow)
    acc_adds: int            # INT32 accumulate adders
    mux_inputs: int          # total mux input legs (DBB's activation select)
    fifo_bits: int = 0       # SMT-SA FIFO storage bits
    index_ff: int = 0        # DBB non-zero index register bits


def sa_pe_resources() -> PeResources:
    """Classic SA scalar PE: 2 INT8 operand regs, INT32 acc, 1 MAC."""
    return PeResources(macs=1, eff_macs=1, operand_ff=16, acc_ff=32,
                       tree_adds=0, acc_adds=1, mux_inputs=0)


def sta_pe_resources(a: int, b: int, c: int) -> PeResources:
    """Tensor-PE A×B×C: A·C dot units of depth B. Operand registers hold A
    row vectors and C column vectors of B INT8 values each; every row
    register feeds C dot units and every column register A (the paper's
    intra-PE operand reuse)."""
    macs = a * b * c
    return PeResources(macs=macs, eff_macs=macs, operand_ff=(a + c) * b * 8,
                       acc_ff=a * c * 32, tree_adds=a * c * (b - 1),
                       acc_adds=a * c, mux_inputs=0)


def dbb_pe_resources(a: int, b: int, c: int, nnz: int) -> PeResources:
    """STA-DBB tensor-PE: each B-input dot unit keeps only ``nnz``
    multipliers, each fed by a B:1 activation mux and a log2(B)-bit index
    register (§IV-B: two 8-bit multipliers traded for two 8-bit 4:1
    muxes). Weight registers shrink to the nnz values (and indices);
    activation registers still hold all B inputs. Effective throughput
    stays A·B·C."""
    idx_bits = max(1, (b - 1).bit_length())
    return PeResources(
        macs=a * nnz * c, eff_macs=a * b * c,
        operand_ff=a * b * 8 + c * nnz * 8,   # acts full, weights compressed
        acc_ff=a * c * 32, tree_adds=a * c * (nnz - 1), acc_adds=a * c,
        mux_inputs=a * c * nnz * b,           # nnz muxes of radix B per unit
        index_ff=c * nnz * idx_bits)
