"""yi-34b [dense] — llama-architecture GQA [arXiv:2403.04652]."""
from repro_torch.config import DbbConfig, ModelConfig

ARCH = "yi-34b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense_lm",
        num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
        d_ff=20480, vocab_size=64000,
        norm="rmsnorm", act="silu", mlp_gated=True, qkv_bias=False,
        rope=True, rope_theta=5_000_000.0,
        dbb=DbbConfig(enabled=True, block=8, nnz=4),
    )


def smoke() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=128, num_heads=8, num_kv_heads=2, d_ff=256,
        vocab_size=512, dtype="float32", remat="none",
    )
