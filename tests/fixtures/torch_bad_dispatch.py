"""Known-bad fixture for the port's dispatch pass: a registry with all
three route-table rot modes (the reference's ``bad_dispatch.py``, on the
port's `Route` and `OpSpec`).

  * ``dead_route`` — guard rejects every spec: ``unreachable``;
  * ``overpriced`` — applicable everywhere but its cost is 1000x the
    winner's, so auto-dispatch can never pick it: ``shadowed``;
  * ``inverse`` — typo'd cost model whose modeled time *falls* as M
    grows: ``non-monotone-cost`` (and, since the inflated floor also
    keeps it from ever winning, ``shadowed``).
"""
from repro_torch.kernels.dispatch import OpSpec, Route


def _ok(spec):
    return ""


def _never(spec):
    return "fixture: permanently disabled"


def _cost_good(spec):
    flops = 2.0 * spec.m * spec.k * spec.n
    nbytes = 4.0 * (spec.m * spec.k + spec.k * spec.n + spec.m * spec.n)
    return flops, nbytes


def _cost_overpriced(spec):
    flops, nbytes = _cost_good(spec)
    return 1e3 * flops, 1e3 * nbytes


def _cost_inverse(spec):
    # the monotonicity bug class: a divided-instead-of-multiplied term
    wrong = float(2 ** 40) / max(spec.m, 1)
    return wrong, wrong


ROUTES = {
    "matmul": {
        "good": Route("good", _ok, 0, _cost_good),
        "dead_route": Route("dead_route", _never, 1, _cost_good),
        "overpriced": Route("overpriced", _ok, 2, _cost_overpriced),
        "inverse": Route("inverse", _ok, 3, _cost_inverse),
    },
}

SPECS = {
    "matmul": [
        OpSpec(domain="matmul", m=8, k=256, n=256, itemsize=4, pallas=True),
        OpSpec(domain="matmul", m=64, k=512, n=512, itemsize=4,
               pallas=True),
    ],
}
