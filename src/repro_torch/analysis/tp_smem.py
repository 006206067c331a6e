"""Per-shard route survival under tensor parallelism (the reference's
``repro.analysis.tp_vmem`` pass, on the H100's guards).

A TP rank runs every kernel on local shapes: a column split hands it
N/tp, a row split K/tp. The dispatch guards are what keeps a shard from
launching a kernel its shared memory or its body's rules cannot take, so
their answer on a TP-split spec must equal their answer on the local spec
the rank will actually run (the dims `dispatch._shard_dims` reports, at
tp=1). Two obligations, swept over the matmul sweep × tp ∈ {2, 4, 8} ×
both split layouts:

  * ``tp-smem-overflow`` — a guard admits the TP-split spec but refuses
    its local spec: the rank would launch a kernel whose rules refuse the
    shape it is given.
  * ``tp-route-loss`` — a guard refuses the TP-split spec although it
    admits the local spec, for a reason that is not an axis split that
    does not divide: it read a global dim somewhere, and the shard loses
    a kernel it could run.

Only the matmul domain is swept: attention shards KV heads, which the
(t, s, d) attention specs do not carry, and no conv takes the TP wrap
(the cnn family never does).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.analysis.contracts import Violation

__all__ = ["check_registry", "TP_SWEEP"]

TP_SWEEP = (2, 4, 8)

# refusals that rightly differ between the split and the local spec: the
# declared axis does not divide tp, so no local instance exists
_SPLIT_MARKERS = ("unsupported axis split", "splits inside a block")


def check_registry(routes_by_domain: Dict[str, Dict],
                   specs_by_domain: Dict[str, Sequence],
                   tps: Sequence[int] = TP_SWEEP,
                   ) -> Tuple[int, List[Violation]]:
    """``(specs checked, violations)`` over the matmul routes: each route
    flagged once per code."""
    from repro_torch.kernels.dispatch import _shard_dims
    out: List[Violation] = []
    flagged = set()
    checked = 0
    table = routes_by_domain.get("matmul", {})
    specs = [s for s in specs_by_domain.get("matmul", ())
             if getattr(s, "pallas", False)]
    for spec in specs if table else ():
        for tp in tps:
            for coll in ("", "all-reduce"):       # column, row split
                sharded = dataclasses.replace(spec, tp=tp, collective=coll)
                m, k, n = _shard_dims(sharded)
                local = dataclasses.replace(spec, m=m, k=k, n=n)
                layout = "row" if coll else "column"
                what = (f"the tp={tp} {layout}-split instance of m={spec.m} "
                        f"k={spec.k} n={spec.n}")
                checked += 1
                for name, route in table.items():
                    g_sh, g_loc = route.guard(sharded), route.guard(local)
                    if g_sh == "" and g_loc != "":
                        code = "tp-smem-overflow"
                        msg = (f"guard admits {what} but refuses its local "
                               f"shape m={m} k={k} n={n}: {g_loc}")
                    elif (g_sh != "" and g_loc == ""
                          and not any(t in g_sh for t in _SPLIT_MARKERS)):
                        code = "tp-route-loss"
                        msg = (f"guard refuses {what} (\"{g_sh}\") although "
                               f"it admits its local shape m={m} k={k} "
                               f"n={n}: the guard reads a global dim")
                    else:
                        continue
                    if (name, code) in flagged:
                        continue
                    flagged.add((name, code))
                    out.append(Violation(pass_name="tp-smem", code=code,
                                         subject=f"matmul:{name}",
                                         message=msg))
    return checked, out
