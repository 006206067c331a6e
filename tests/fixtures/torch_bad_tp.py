"""Known-bad fixture for the port's tp-smem pass (the bug class of the
reference's ``test_tp_vmem_pass_catches_global_dim_guard``): the ``sta``
route's guard, wrapped so that under a TP split it also refuses on the
GLOBAL weight's size — a shape whose local instance it admits. The pass
must report ``tp-route-loss``."""
import dataclasses

from repro_torch.kernels.dispatch import ROUTES, OpSpec

_REAL = next(r for r in ROUTES["matmul"] if r.name == "sta")


def _global_dim_guard(spec):
    g = _REAL.guard(dataclasses.replace(spec, tp=1, collective=""))
    if g:
        return g
    if spec.tp > 1 and spec.k * spec.n * spec.itemsize > 2 ** 22:
        return "weight tile exceeds the shared-memory budget"  # global k·n
    return ""


ROUTES = {"matmul": {"sta": _REAL._replace(guard=_global_dim_guard)}}

SPECS = {"matmul": [OpSpec(domain="matmul", m=256, k=2048, n=2048,
                           pallas=True)]}
