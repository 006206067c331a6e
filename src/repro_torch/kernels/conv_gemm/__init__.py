from repro_torch.kernels.conv_gemm.ops import (conv_gemm, conv_gemm_dbb,
                                               conv_gemm_packed, out_spatial)
from repro_torch.kernels.conv_gemm.ref import (conv_gemm_dbb_ref,
                                               conv_gemm_ref, im2col)

__all__ = ["conv_gemm", "conv_gemm_dbb", "conv_gemm_packed", "out_spatial",
           "conv_gemm_ref", "conv_gemm_dbb_ref", "im2col"]
