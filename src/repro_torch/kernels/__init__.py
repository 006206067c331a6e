"""Hand-written Hopper kernels (``repro_torch/csrc``) behind their wrappers,
with a plain PyTorch version of each.

dbb_gemm:  DBB structured-sparse GEMM, M-tiled (prefill projections).
sta_gemm:  dense GEMM, M-tiled (dense-weight prefill MLP).
skinny:    M ≤ 32 weight-streaming GEMMs — DBB-compressed (decode
           projections) and dense (dense-weight decode, the head GEMV).
conv_gemm: implicit-GEMM NHWC convolution, dense or DBB-compressed
           weight (the CNN's conv layers).
attn:      causal and packed (block-diagonal) flash prefill, and one-token
           paged decode attention; a contiguous cache is the
           identity block table.
sample:    the fused sampling head (head GEMV → penalties → 1/T → Gumbel
           → argmax, no logits in device memory) and the sampling math.
epilogue:  the fused scale → bias → act → store order all of them share.
dispatch:  route tables and the front doors the model layers call
           (matmul, conv, attention, attn_decode, head_sample).
build:     nvcc + ctypes loader (builds at first use, never at import).
"""
from repro_torch.kernels.epilogue import apply_act

# the one kernel helper the model layer's plain paths share with the
# epilogue (so fused and unfused activations cannot drift): the model layer
# takes it from this root, never from the private ``epilogue`` module
__all__ = ["apply_act"]
