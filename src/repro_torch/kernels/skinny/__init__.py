from repro_torch.kernels.skinny.ops import dbb_gemm_skinny, sta_gemm_skinny
from repro_torch.kernels.skinny.ref import sta_gemm_ref

__all__ = ["dbb_gemm_skinny", "sta_gemm_skinny", "sta_gemm_ref"]
