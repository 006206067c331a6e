"""Production meshes (the reference's `repro.launch.mesh`).

The shapes stay the reference's, so that the dry run's cells compare one
to one: one pod of 16 × 16 ranks (``data × model``), or two of them
(``pod × data × model``). A mesh here is one rank's view over the
initialised default process group (`dist.mesh_ctx.make_mesh`), which
must hold the product of the shape's ranks; the dry run initialises a
fake world of that size and builds the mesh as rank 0.

The roofline's collective model (`roofline.analysis.collective_bw`)
prices every link as NVLink 4 at the data sheet's rate. That holds inside
one 8-card node only: a 256-rank pod spans 32 such nodes, and traffic
between nodes runs at the network's rate, far below NVLink's, so the
collective terms of a production mesh are optimistic lower bounds.
"""
from __future__ import annotations

from repro_torch.dist.mesh_ctx import Mesh, make_mesh, make_smoke_mesh

__all__ = ["make_production_mesh", "make_smoke_mesh", "POD_SHAPE",
           "MULTI_POD_SHAPE"]

POD_SHAPE = (16, 16)                       # 256 ranks: data × model
MULTI_POD_SHAPE = (2, 16, 16)              # 512 ranks: pod × data × model


def make_production_mesh(*, multi_pod: bool = False,
                         backend: str) -> Mesh:
    """This rank's view of the pod (or the two pods) over the initialised
    world, whose size must be 256 (512)."""
    if multi_pod:
        pod, data, model = MULTI_POD_SHAPE
        return make_mesh(data, model, backend=backend, pod=pod)
    data, model = POD_SHAPE
    return make_mesh(data, model, backend=backend)
