"""paligemma-3b [vlm] — SigLIP + Gemma backbone [arXiv:2407.07726].
The SigLIP vision tower is a STUB per the brief: ``input_specs()`` supplies
256 precomputed patch embeddings as a prefix (prefix_embed_len)."""
from repro_torch.config import DbbConfig, ModelConfig

ARCH = "paligemma-3b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="vlm_lm",
        num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
        head_dim=256, d_ff=16384, vocab_size=257216,
        norm="rmsnorm", act="gelu", mlp_gated=True, qkv_bias=False,
        tie_embeddings=True, rope=True,
        prefix_embed_len=256,
        dbb=DbbConfig(enabled=True, block=8, nnz=4),
    )


def smoke() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=1, head_dim=32,
        d_ff=256, vocab_size=512, prefix_embed_len=16,
        dtype="float32", remat="none",
    )
