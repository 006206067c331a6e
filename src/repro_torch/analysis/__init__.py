"""The port's kernel verifier (the counterpart of ``repro.analysis``).

Six passes, run by ``python -m repro_torch.analysis.lint``:

  smem           each CUDA body's dynamic shared memory (the Python mirror
                 of its formula) against the H100's per-block limit, in
                 both directions against the guards; on the card plus the
                 static shared memory ptxas reports, against the card's
                 opt-in limit; and the limit spelled only at its two
                 definition sites
  materialize    a TorchDispatchMode walker and the allocator's peak
                 proving the absence claims per kernel route: no score
                 tensor, no dense DBB weight, no im2col matrix, no logits,
                 no gathered decode K/V
  workspace      the wrappers' workspace functions against their dense
                 bounds; on the card each Python split count against the
                 library's
  dispatch       the route tables swept over the configs' shapes:
                 unreachable, shadowed, non-monotone-cost
  tp-smem        the matmul guards on each TP-split instance of that sweep
                 (tp 2, 4, 8; column and row splits) against the local
                 shape a rank runs: tp-smem-overflow, tp-route-loss
  layering       the reference's import rules, mapped to the port

The reference's ``races`` and ``bounds`` passes are not ported: they
evaluate the BlockSpec index maps of a Pallas grid over the whole grid,
and a CUDA body has no declarative grid to evaluate. Their bug classes
(overlapping writes, revisited accumulators, out-of-bounds tiles) are
what the card tests' ragged edges in tests/test_torch_gpu.py hold each
body to. The reference's ``tp_vmem`` is ``tp_smem`` here.
"""
from repro_torch.analysis.contracts import SmemContract, Violation
from repro_torch.analysis.materialize import (Case, MaterializationCheck,
                                              assert_no_intermediate_larger_than,
                                              device_peak, iter_outputs,
                                              max_intermediate_elems)

__all__ = ["SmemContract", "Violation", "Case", "MaterializationCheck",
           "assert_no_intermediate_larger_than", "device_peak",
           "iter_outputs", "max_intermediate_elems"]
