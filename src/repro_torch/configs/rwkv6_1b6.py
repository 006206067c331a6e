"""rwkv6-1.6b [ssm] — "Finch", attention-free, data-dependent decay
[arXiv:2404.05892]. Runs long_500k (O(1) state)."""
from repro_torch.config import DbbConfig, ModelConfig, SsmConfig

ARCH = "rwkv6-1.6b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="rwkv6",
        num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=7168, vocab_size=65536,
        norm="layernorm", act="relu",   # squared-relu channel mix (in-model)
        mlp_gated=False, rope=False,
        ssm=SsmConfig(head_dim=64, chunk=32),
        dbb=DbbConfig(enabled=True, block=8, nnz=4),
    )


def smoke() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=128, num_heads=2, num_kv_heads=2, d_ff=256,
        vocab_size=512, dtype="float32", remat="none",
        ssm=SsmConfig(head_dim=64, chunk=16),
    )
