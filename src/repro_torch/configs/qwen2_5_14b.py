"""qwen2.5-14b [dense] — GQA with QKV bias [hf:Qwen/Qwen2.5 family]."""
from repro_torch.config import DbbConfig, ModelConfig

ARCH = "qwen2.5-14b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense_lm",
        num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
        d_ff=13824, vocab_size=152064,
        norm="rmsnorm", act="silu", mlp_gated=True, qkv_bias=True,
        rope=True, rope_theta=1_000_000.0,
        dbb=DbbConfig(enabled=True, block=8, nnz=4),
    )


def smoke() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
        vocab_size=512, dtype="float32", remat="none",
    )
