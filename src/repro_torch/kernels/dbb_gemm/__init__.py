from repro_torch.kernels.dbb_gemm.ops import dbb_gemm
from repro_torch.kernels.dbb_gemm.ref import dbb_gemm_ref

__all__ = ["dbb_gemm", "dbb_gemm_ref"]
