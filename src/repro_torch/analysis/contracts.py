"""The verifier's inputs that are not code: findings (`Violation`) and the
shared-memory contract of each CUDA body (`SmemContract`).

The reference describes each Pallas kernel by its grid and BlockSpecs
(``repro.analysis.contracts.KernelContract``); a hand-written CUDA body has
no declarative grid, so the port states what the checks can hold it to:
the dynamic shared memory one block asks for (the Python mirror of the
body's ``smem_bytes`` / ``layout``, which the CPU tests hold against the C
source), the verdict of the guard that admits or refuses the instance, and
whether a refusal was for shared memory. ``repro_torch.analysis.smem``
checks both directions, as the reference's vmem pass does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["Violation", "SmemContract"]


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding: which pass, which rule, on what, and why."""
    pass_name: str
    code: str                    # stable rule id, e.g. "smem-overflow"
    subject: str                 # contract / route / file the rule hit
    message: str

    def as_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class SmemContract:
    """One instance of a CUDA body with dynamic shared memory.

    ``smem_bytes`` is the Python formula's value for this instance (what
    the launcher passes as the launch's dynamic shared memory);
    ``admitted`` the real guard's verdict on it; ``smem_reject`` whether a
    refusal was for shared memory. ``kernel`` names the library
    (``csrc/<kernel>.cu``) and ``entry`` a substring of the ``__global__``
    function's name in ptxas's report, so that on the card the pass can add
    the entry's static shared memory."""
    name: str                    # unique, e.g. "paged_decode[G1 D128 bf16]"
    body: str                    # source file:line of the formula
    kernel: str
    entry: str
    smem_bytes: int
    budget: int = 0              # the limit it must fit (0: none declared)
    admitted: bool = True
    smem_reject: bool = False
    notes: str = ""
