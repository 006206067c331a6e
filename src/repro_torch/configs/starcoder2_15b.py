"""starcoder2-15b [dense] — GQA kv=4, RoPE, LayerNorm and a plain
(non-gated) GeLU MLP, QKV bias, a 4096-token sliding window
[arXiv:2402.19173]. The MLP carries no biases, as in the JAX package's
model code."""
from repro_torch.config import DbbConfig, ModelConfig

ARCH = "starcoder2-15b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense_lm",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4,
        d_ff=24576, vocab_size=49152,
        norm="layernorm", act="gelu", mlp_gated=False, qkv_bias=True,
        rope=True, rope_theta=100_000.0, sliding_window=4096,
        dbb=DbbConfig(enabled=True, block=8, nnz=4),
    )


def smoke() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=1, d_ff=512,
        vocab_size=512, sliding_window=0, dtype="float32", remat="none",
    )
