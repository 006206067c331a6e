"""olmo-1b [dense] — non-parametric LayerNorm, MHA, tied embeddings
[arXiv:2402.00838]."""
from repro_torch.config import DbbConfig, ModelConfig

ARCH = "olmo-1b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense_lm",
        num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=8192, vocab_size=50304,
        norm="nonparam_ln", act="silu", mlp_gated=True, qkv_bias=False,
        tie_embeddings=True, rope=True,
        dbb=DbbConfig(enabled=True, block=8, nnz=4),
    )


def smoke() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, d_ff=256,
        vocab_size=512, dtype="float32", remat="none",
    )
