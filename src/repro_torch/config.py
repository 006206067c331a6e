"""Configuration for the PyTorch port.

Plain frozen dataclasses with the `ModelConfig` / `DbbConfig` fields the
serving and training paths read, and the run-level `ShapeSpec`,
`MeshConfig`, `TrainConfig`, `ServeConfig` and `RunConfig`, under the
same names and defaults as the JAX package's configs, so a config (and
its ``kernel_routes`` overrides) carries over field for field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

__all__ = ["DbbConfig", "StaConfig", "MoeConfig", "SsmConfig", "ModelConfig",
           "ShapeSpec", "SHAPES", "shape_applicable",
           "MeshConfig", "TrainConfig", "ServeConfig", "RunConfig"]


@dataclass(frozen=True)
class DbbConfig:
    """Density-bound block sparsity (paper §IV-A): at most ``nnz``
    non-zeros in every ``block`` consecutive weights along K.

    apply_to names the weight families that get packed; attention
    score/value products are activation × activation and never are.
    weight_bits: value-plane width of `pack_tree`: 8 keeps one value per
    element; 4 nibble-packs the surviving values with groupwise scales on
    every leaf whose K divides ``quant_group`` (others stay 8-bit packed).
    quant_group: scale-group length G along dense K for weight_bits=4 (a
    multiple of ``block``).
    """
    block: int = 8
    nnz: int = 4
    enabled: bool = False
    apply_to: Tuple[str, ...] = ("mlp", "attn_proj", "expert")
    weight_bits: int = 8
    quant_group: int = 128

    @property
    def weight_footprint_ratio(self) -> float:
        """Compressed bytes / dense INT8 bytes: per block of B values, k
        value bytes + ceil(B/8) mask bytes (62.5% at B=8, k=4);
        weight_bits=4 halves the value term and adds 4 scale bytes per
        G-group."""
        mask_bytes = (self.block + 7) // 8
        if self.weight_bits == 4 and self.quant_group > 0:
            return ((self.nnz * 0.5 + mask_bytes) / self.block
                    + 4.0 / self.quant_group)
        return (self.nnz + mask_bytes) / self.block


@dataclass(frozen=True)
class StaConfig:
    """The paper's A×B×C tensor-PE geometry (§III-B): an M×N grid of
    tensor PEs, each an A×C array of B-input dot-product units. The area
    model (`core/area_model.py`) prices PEs of this shape; the block
    fields are the reference's Pallas tiling, carried for parity (the CUDA
    bodies pick their own tiles)."""
    a: int = 4
    b: int = 8
    c: int = 4
    block_m: int = 128
    block_k: int = 128
    block_n: int = 128

    def macs_per_pe(self) -> int:
        return self.a * self.b * self.c


@dataclass(frozen=True)
class MoeConfig:
    """Mixture-of-experts FFN (the moe_lm family): ``num_experts`` experts,
    each token routed to its ``top_k``; an expert takes at most
    ``capacity_factor`` times its even share of the routed tokens (the
    rest drop). ``dense_residual_ff`` > 0 adds an always-active MLP of that
    width beside the experts (Arctic's dense residual, Kimi's shared
    expert). ``aux_loss_weight`` scales the load-balance loss in training.
    ``impl``: "local" runs every expert on each device; "ep" (expert
    parallelism) splits the experts over a live mesh's model axis; "auto"
    takes "ep" under such a mesh when the experts divide it, else
    "local". ``router_jitter`` is carried
    as the reference carries it (neither package reads it)."""
    num_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    dense_residual_ff: int = 0
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    impl: str = "auto"


@dataclass(frozen=True)
class SsmConfig:
    """The recurrent families' settings (the reference's one sub-config
    for both): rwkv6 reads ``head_dim`` (its WKV heads) and ``chunk`` (the
    chunked WKV, capped at 32); the zamba2 hybrid's Mamba2 layers and
    shared attention block read them all:
    ``state_size`` N and ``head_dim`` P of the SSD state (one [P, N] state
    per head, ``expand * d_model / head_dim`` heads), the depthwise causal
    conv's ``conv_width``, the chunked scan's ``chunk``, and the one shared
    attention + MLP block applied after every ``shared_period`` Mamba
    layers with a ``shared_window``-token sliding window (its ring-buffer
    K/V cache holds that many slots)."""
    state_size: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128
    shared_period: int = 6
    shared_window: int = 4096


@dataclass(frozen=True)
class ModelConfig:
    """The fields the ported paths read (the dense_lm, moe_lm, zamba2,
    rwkv6, vlm_lm and audio_lm LM families, the CNN).

    gemm_impl:     "pallas" selects the fused kernel route family (the
                   hand-written CUDA kernels on the card, their plain
                   versions on the CPU); "xla" keeps plain torch matmuls.
    kernel_routes: ((domain, route), ...) pins a dispatch route per
                   domain. Precedence: REPRO_FORCE_ROUTE > kernel_routes
                   > auto.
    attn_impl:     "auto" lets the route table choose (flash on the kernel
                   route family, else chunked or naive by sequence
                   length); "flash", "chunked" or "naive" pins one.
    attn_chunk:    query / key block of the chunked prefill attention; it
                   takes self-attention calls whose S divides it, from
                   S > 2 · attn_chunk.
    remat:         activation checkpointing of the layer bodies in a
                   training forward (`transformer.forward`): "none",
                   "full", "dots", or "auto" (by d_model).
    kv_page_size:  decode KV page (cache slots); 0 picks
                   gcd(cache length, 64).
    parallel:      "tp": the mesh's model axis carries tensor
                   parallelism; "dp": it joins the batch axes (params
                   replicated, ZeRO), so no TP split (`dist.sharding`).
    norm:          "rmsnorm", "layernorm" or "nonparam_ln" (OLMo's
                   LayerNorm without affine parameters).
    prefix_embed_len, embeds_input: the vlm and audio families' inputs
                   (``prefix_embeds`` in front of the token embeddings;
                   frame ``embeds`` in place of them), which the data
                   pipeline draws and `transformer.forward` / `prefill`
                   take.
    cnn_*:         the cnn family (the paper's own models): conv output
                   channels per layer, square kernel size, classes,
                   square input size and input channels.
    """
    name: str = "model"
    family: str = "dense_lm"
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0               # 0 => d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 32000
    norm: str = "rmsnorm"           # rmsnorm | layernorm | nonparam_ln
    act: str = "silu"
    mlp_gated: bool = True
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    rope: bool = True
    prefix_embed_len: int = 0       # vlm: prefix embedding positions
    embeds_input: bool = False      # audio / vlm: the frontend gives embeds
    moe: MoeConfig = field(default_factory=MoeConfig)
    ssm: SsmConfig = field(default_factory=SsmConfig)
    dbb: DbbConfig = field(default_factory=DbbConfig)
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    gemm_impl: str = "xla"
    kernel_routes: Tuple[Tuple[str, str], ...] = ()
    remat: str = "auto"             # auto | none | full | dots (training)
    attn_impl: str = "auto"
    attn_chunk: int = 1024
    sliding_window: int = 0
    attn_logit_softcap: float = 0.0
    kv_page_size: int = 0
    parallel: str = "tp"            # tp | dp (the model axis joins ZeRO)
    cnn_channels: Tuple[int, ...] = ()
    cnn_kernel: int = 3
    cnn_classes: int = 10
    cnn_img: int = 32
    cnn_in_ch: int = 3

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "rwkv6"

    @property
    def supports_long_context(self) -> bool:
        """long_500k eligibility: the SSM / hybrid families only."""
        return self.family in ("rwkv6", "zamba2")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (embedding, layers, head), the
        reference's formula for every family (it counts no norm or bias
        parameters; zamba2's is the reference's rough estimate: the Mamba
        projections, conv and head vectors per layer plus the MLP's share
        spread over the layers; rwkv6's its approximation ``5 d² + 2 d f +
        2 · d · 96`` a layer: the r, k, v, g, o projections, the channel
        mix's two d × f matrices and the decay LoRA at a nominal rank)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        if self.family == "cnn":
            n, cin, k = 0, self.cnn_in_ch, self.cnn_kernel
            for cout in self.cnn_channels:
                n += cin * cout * k * k + cout
                cin = cout
            img = self.cnn_img // (2 ** len(self.cnn_channels))
            return n + cin * img * img * self.cnn_classes
        n = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "rwkv6":
            return n + self.num_layers * (5 * d * d + 2 * d * f + 2 * d * 96)
        attn = (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                + self.num_heads * hd * d)
        mats = 3 if self.mlp_gated else 2
        if self.family == "moe_lm":
            ff = self.moe.num_experts * mats * d * f + d * self.moe.num_experts
            ff += mats * d * self.moe.dense_residual_ff
        else:
            ff = mats * d * f
        per_layer = attn + ff
        if self.family == "zamba2":
            di = self.ssm.expand * d
            mamba = d * 2 * di + di * d + di * (self.ssm.conv_width + 3)
            per_layer = mamba + ff // max(1, self.num_layers)
        return n + self.num_layers * per_layer

    def active_param_count(self) -> int:
        """Parameters a token uses: a MoE layer's ``top_k`` experts of its
        ``num_experts`` (every parameter elsewhere)."""
        if self.family != "moe_lm" or not self.moe.num_experts:
            return self.param_count()
        per_expert = (3 if self.mlp_gated else 2) * self.d_model * self.d_ff
        inactive = ((self.moe.num_experts - self.moe.top_k) * per_expert
                    * self.num_layers)
        return self.param_count() - inactive


# ---------------------------------------------------------------------------
# run-level configs (shapes, mesh, training, serving)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    """One input shape: sequence length, global batch and its kind
    ("train" | "prefill" | "decode")."""
    name: str
    seq_len: int
    global_batch: int
    kind: str


# the four cells of every assigned arch (the reference's)
SHAPES = {
    "train_4k":    ShapeSpec("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeSpec("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeSpec("long_500k",   524_288, 1,   "decode"),
}


def shape_applicable(model: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell runs, and why not if it doesn't."""
    if shape.name == "long_500k" and not model.supports_long_context:
        return False, ("long_500k requires sub-quadratic attention; "
                       f"{model.name} is a pure full-attention arch (skip per brief)")
    return True, ""


@dataclass(frozen=True)
class MeshConfig:
    """The device mesh's shape and axis names. Carried only: serving and
    training build their mesh with `dist.mesh_ctx.make_mesh` (the training
    CLI from ``--mesh``)."""
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axes if a in ("pod", "data"))


@dataclass(frozen=True)
class TrainConfig:
    """One training run. ``dbb_prune_start`` / ``dbb_prune_ramp``: the
    density bound stays dense until the start step, then shrinks from
    ``block`` to ``dbb.nnz`` non-zeros over the ramp
    (`core.sparsity.dbb_schedule_nnz`)."""
    steps: int = 100
    microbatches: int = 1            # gradient-accumulation microbatches
    learning_rate: float = 3e-4
    warmup_steps: int = 10
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    optimizer: str = "adamw"         # adamw | adafactor | sgd
    grad_compress: str = "none"      # none | bf16 | int8_ef
    seed: int = 0
    checkpoint_every: int = 0
    checkpoint_dir: str = ""
    log_every: int = 10
    dbb_prune_start: int = 0
    dbb_prune_ramp: int = 0


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_seq_len: int = 2048
    prefill_chunk: int = 512
    eos_id: int = 1
    temperature: float = 0.0


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
