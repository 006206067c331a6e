"""Model configuration for the PyTorch port.

Plain frozen dataclasses with the `ModelConfig` / `DbbConfig` fields the
serving path reads, under the same names and defaults as the JAX
package's configs, so a config (and its ``kernel_routes`` overrides)
carries over field for field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

__all__ = ["DbbConfig", "ModelConfig"]


@dataclass(frozen=True)
class DbbConfig:
    """Density-bound block sparsity (paper §IV-A): at most ``nnz``
    non-zeros in every ``block`` consecutive weights along K.

    apply_to names the weight families that get packed; attention
    score/value products are activation × activation and never are.
    weight_bits: value-plane width of `pack_tree`: 8 keeps one value per
    element; 4 nibble-packs the surviving values with groupwise scales on
    every leaf whose K divides ``quant_group`` (others stay 8-bit packed).
    quant_group: scale-group length G along dense K for weight_bits=4 (a
    multiple of ``block``).
    """
    block: int = 8
    nnz: int = 4
    enabled: bool = False
    apply_to: Tuple[str, ...] = ("mlp", "attn_proj", "expert")
    weight_bits: int = 8
    quant_group: int = 128

    @property
    def weight_footprint_ratio(self) -> float:
        """Compressed bytes / dense INT8 bytes: per block of B values, k
        value bytes + ceil(B/8) mask bytes (62.5% at B=8, k=4);
        weight_bits=4 halves the value term and adds 4 scale bytes per
        G-group."""
        mask_bytes = (self.block + 7) // 8
        if self.weight_bits == 4 and self.quant_group > 0:
            return ((self.nnz * 0.5 + mask_bytes) / self.block
                    + 4.0 / self.quant_group)
        return (self.nnz + mask_bytes) / self.block


@dataclass(frozen=True)
class ModelConfig:
    """The fields the ported paths read (the dense LM family, the CNN).

    gemm_impl:     "pallas" selects the fused kernel route family (the
                   hand-written CUDA kernels on the card, their plain
                   versions on the CPU); "xla" keeps plain torch matmuls.
    kernel_routes: ((domain, route), ...) pins a dispatch route per
                   domain. Precedence: REPRO_FORCE_ROUTE > kernel_routes
                   > auto.
    attn_impl:     "auto" lets the route table choose (flash on the kernel
                   route family, else chunked or naive by sequence
                   length); "flash", "chunked" or "naive" pins one.
    attn_chunk:    query / key block of the chunked prefill attention; it
                   takes self-attention calls whose S divides it, from
                   S > 2 · attn_chunk.
    kv_page_size:  decode KV page (cache slots); 0 picks
                   gcd(cache length, 64).
    norm:          "rmsnorm", "layernorm" or "nonparam_ln" (OLMo's
                   LayerNorm without affine parameters).
    cnn_*:         the cnn family (the paper's own models): conv output
                   channels per layer, square kernel size, classes,
                   square input size and input channels.
    """
    name: str = "model"
    family: str = "dense_lm"
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0               # 0 => d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 32000
    norm: str = "rmsnorm"           # rmsnorm | layernorm | nonparam_ln
    act: str = "silu"
    mlp_gated: bool = True
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    rope: bool = True
    dbb: DbbConfig = field(default_factory=DbbConfig)
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    gemm_impl: str = "xla"
    kernel_routes: Tuple[Tuple[str, str], ...] = ()
    remat: str = "auto"             # read by training only; kept for parity
    attn_impl: str = "auto"
    attn_chunk: int = 1024
    sliding_window: int = 0
    attn_logit_softcap: float = 0.0
    kv_page_size: int = 0
    cnn_channels: Tuple[int, ...] = ()
    cnn_kernel: int = 3
    cnn_classes: int = 10
    cnn_img: int = 32
    cnn_in_ch: int = 3

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
