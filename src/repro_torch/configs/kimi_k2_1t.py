"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8 + one
shared expert (expressed as dense_residual_ff) [paper-table; unverified]."""
from repro_torch.config import DbbConfig, ModelConfig, MoeConfig

ARCH = "kimi-k2-1t-a32b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="moe_lm",
        num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
        head_dim=112, d_ff=2048, vocab_size=163840,
        norm="rmsnorm", act="silu", mlp_gated=True, qkv_bias=False,
        rope=True,
        moe=MoeConfig(num_experts=384, top_k=8, capacity_factor=1.25,
                      dense_residual_ff=2048),
        dbb=DbbConfig(enabled=True, block=8, nnz=4,
                      apply_to=("mlp", "attn_proj", "expert")),
    )


def smoke() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=512, dtype="float32", remat="none",
        moe=MoeConfig(num_experts=8, top_k=2, capacity_factor=1.25,
                      dense_residual_ff=128),
    )
