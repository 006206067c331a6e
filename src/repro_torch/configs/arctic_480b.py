"""arctic-480b [moe] — 128 experts top-2 + dense residual MLP
[hf:Snowflake/snowflake-arctic-base]. dense_residual_ff=4864 mirrors the
expert hidden size (gives the published ~480B total)."""
from repro_torch.config import DbbConfig, ModelConfig, MoeConfig

ARCH = "arctic-480b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="moe_lm",
        num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
        d_ff=4864, vocab_size=32000,
        norm="rmsnorm", act="silu", mlp_gated=True, qkv_bias=False,
        rope=True,
        moe=MoeConfig(num_experts=128, top_k=2, capacity_factor=1.25,
                      dense_residual_ff=4864),
        dbb=DbbConfig(enabled=True, block=8, nnz=4,
                      apply_to=("mlp", "attn_proj", "expert")),
    )


def smoke() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=512, dtype="float32", remat="none",
        moe=MoeConfig(num_experts=8, top_k=2, capacity_factor=1.25,
                      dense_residual_ff=128),
    )
