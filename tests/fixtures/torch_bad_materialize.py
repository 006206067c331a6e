"""Known-bad fixture for the port's materialization pass: a "pairwise
scores" computation that builds the full [M, K, N] outer-product tensor
before reducing — exactly the intermediate a fused kernel exists to
avoid (the reference's ``bad_materialize.py``, in torch). The declared
limit is the output size, so the walker must flag ``materialized``.
"""
import torch

from repro_torch.analysis.materialize import Case, MaterializationCheck

_M = _K = _N = 32


def _build(device):
    a = torch.ones((_M, _K), device=device)
    b = torch.ones((_K, _N), device=device)

    def fn(x, y):
        # materializes [M, K, N] = 32768 elems before the reduction
        return (x[:, :, None] * y[None, :, :]).sum(dim=1)

    return Case(label=f"{_M}x{_K}x{_N}", fn=fn, args=(a, b),
                limit_elems=_M * _N)


MATERIALIZATION_CHECKS = [
    MaterializationCheck(
        name="bad-materialize-outer-product",
        describe=f"[{_M},{_K}]x[{_K},{_N}] matmul via explicit "
                 f"[{_M},{_K},{_N}] outer product",
        build=_build),
]
