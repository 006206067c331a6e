"""Known-bad fixture for the port's smem pass: guard drift in both
directions (the reference's ``bad_vmem.py``; its ``vmem-*`` codes are
``smem-*`` here).

``overflow`` is admitted by its guard although its dynamic shared memory
is 4x the H100's per-block limit — the admits-what-doesn't-fit direction.
``headroom`` is refused for shared memory although it asks for 4 KB —
the dead-headroom (refuses-what-fits) direction. Expected codes:
``smem-overflow`` and ``dead-headroom``.
"""
from repro_torch.analysis.contracts import SmemContract
from repro_torch.kernels.common import SMEM_LIMIT

overflow = SmemContract(
    name="bad_smem_overflow", body="fixture", kernel="fixture",
    entry="fixture", smem_bytes=4 * SMEM_LIMIT, budget=SMEM_LIMIT,
    admitted=True)                      # guard bug: this does not fit

headroom = SmemContract(
    name="bad_smem_dead_headroom", body="fixture", kernel="fixture",
    entry="fixture", smem_bytes=4096, budget=SMEM_LIMIT,
    admitted=False, smem_reject=True)   # guard bug: this fits easily

SMEM_CONTRACTS = [overflow, headroom]
