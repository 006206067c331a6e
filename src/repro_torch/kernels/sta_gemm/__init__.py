from repro_torch.kernels.sta_gemm.ops import sta_gemm
from repro_torch.kernels.sta_gemm.ref import sta_gemm_ref

__all__ = ["sta_gemm", "sta_gemm_ref"]
