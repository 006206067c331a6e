"""musicgen-medium [audio] — decoder-only transformer over EnCodec tokens
[arXiv:2306.05284]. The EnCodec frontend is a STUB per the brief:
``input_specs()`` supplies precomputed frame embeddings (embeds_input=True);
the backbone is the standard MusicGen decoder (MHA, LayerNorm, GeLU MLP)."""
from repro_torch.config import DbbConfig, ModelConfig

ARCH = "musicgen-medium"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="audio_lm",
        num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
        d_ff=6144, vocab_size=2048,
        norm="layernorm", act="gelu", mlp_gated=False, qkv_bias=False,
        rope=True,                      # positional mechanism (adaptation:
        embeds_input=True,              # sinusoidal → RoPE, DESIGN.md §2)
        dbb=DbbConfig(enabled=True, block=8, nnz=4),
    )


def smoke() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, d_ff=256,
        vocab_size=256, dtype="float32", remat="none",
    )
