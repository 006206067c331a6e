"""Plain PyTorch versions of the skinny (M ≤ 32) kernels. Each computes
the same function as its M-tiled counterpart, so the DBB variant is
`dbb_gemm_ref` and the dense variant `sta_gemm_ref`."""
from repro_torch.kernels.dbb_gemm.ref import dbb_gemm_ref
from repro_torch.kernels.sta_gemm.ref import sta_gemm_ref

__all__ = ["sta_gemm_ref", "dbb_gemm_ref"]
