"""zamba2-1.2b [hybrid] — Mamba2 backbone + one shared attention block
[arXiv:2411.15242]: recurrent Mamba2 state plus a sliding-window shared
attention block, for long contexts."""
from repro_torch.config import DbbConfig, ModelConfig, SsmConfig

ARCH = "zamba2-1.2b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="zamba2",
        num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=32000,
        norm="rmsnorm", act="gelu", mlp_gated=True, rope=True,
        ssm=SsmConfig(state_size=64, head_dim=64, expand=2, conv_width=4,
                      chunk=128, shared_period=6, shared_window=4096),
        dbb=DbbConfig(enabled=True, block=8, nnz=4),
    )


def smoke() -> ModelConfig:
    return full().replace(
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=4, d_ff=256,
        vocab_size=512, dtype="float32", remat="none",
        ssm=SsmConfig(state_size=16, head_dim=32, expand=2, conv_width=4,
                      chunk=16, shared_period=2, shared_window=64),
    )
