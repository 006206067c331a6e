"""Shared model building blocks: init, norms, RoPE, embeddings."""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.config import ModelConfig

__all__ = ["dtype_of", "param_dtype_of", "init_generator", "normal_init",
           "linear_init",
           "linear_apply", "norm_init", "norm_apply", "rope_freqs",
           "apply_rope", "embed_init", "embed_apply", "embed_scale"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def param_dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


# ---------------------------------------------------------------------------
# init (explicit generator; the reference's jax.random draws differ, so
# cross-checks move weights across with `repro_torch.interop` instead)
# ---------------------------------------------------------------------------

def init_generator(device: torch.device,
                   seed: int) -> Optional[torch.Generator]:
    """The generator an init draws from on ``device``, seeded with
    ``seed``; None on the meta device, whose tensors carry shapes and
    dtypes but no values (the dry run's trees), so nothing is drawn."""
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def normal_init(gen: torch.Generator, shape, scale: float,
                dtype: torch.dtype, device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def linear_init(gen: torch.Generator, lead, d_in: int, d_out: int,
                dtype: torch.dtype, device, scale: Optional[float] = None,
                bias: bool = False) -> Dict:
    """Fan-in normal init in ``[..., K, N]`` layout (contraction first);
    ``lead`` stacks it (the layer axis)."""
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    p = {"w": normal_init(gen, (*lead, d_in, d_out), scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=device)
    return p


def linear_apply(p: Dict, x: torch.Tensor, *, act: str = "none",
                 fused: bool = False,
                 cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """``act(x @ w + b)`` for a `linear_init` dict through
    `dispatch.matmul`: ``fused=True`` takes the kernel route family (bias
    and activation in the kernel's epilogue, the output in x's dtype),
    ``fused=False`` the plain route."""
    from repro_torch.kernels import dispatch
    w = p["w"]
    if isinstance(w, torch.Tensor):
        w = w.to(x.dtype)
    return dispatch.matmul(x, w, p.get("b"), act=act,
                           out_dtype=x.dtype if fused else None, cfg=cfg,
                           pallas=fused)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(kind: str, lead, d: int, dtype: torch.dtype, device) -> Dict:
    """The norm's parameters, stacked ``[*lead, d]``: RMSNorm a scale of
    ones, LayerNorm a scale of ones and a bias of zeros, OLMo's
    non-parametric LayerNorm none."""
    if kind == "rmsnorm":
        return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((*lead, d), dtype=dtype, device=device),
                "bias": torch.zeros((*lead, d), dtype=dtype, device=device)}
    if kind == "nonparam_ln":
        return {}
    raise ValueError(kind)


def norm_apply(kind: str, p: Dict, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm, LayerNorm or the non-parametric LayerNorm over the last
    axis: statistics in f32 (the biased variance), the scale and bias taken
    to f32 before the product, the result in x's dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        return (y * p["scale"].float()).to(x.dtype)
    if kind not in ("layernorm", "nonparam_ln"):
        raise ValueError(kind)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (half-split layout: the first and second halves of D rotate as pairs)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions broadcastable to [..., S]; angles in
    f32, result in x's dtype."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # [D/2]
    angles = positions[..., None].float() * freqs            # [..., S, D/2]
    angles = angles[..., None, :]                            # [..., S, 1, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embed_init(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype,
               device) -> Dict:
    return {"table": normal_init(gen, (vocab, d), 1.0, dtype, device)}


def embed_apply(p: Dict, tokens: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """The embedding gather. Where the table arrives split by row over the
    vocab (inside a TP shard body, or in a training step on a mesh whose
    layout splits it: "vocab"), each rank gathers its slice's rows and one
    sum over "model" assembles them (`dist.collectives.
    vocab_parallel_embed`; the reference's branch for a live model axis
    over 1). Otherwise the plain gather."""
    from repro_torch.dist.mesh_ctx import shard_tp, train_layout
    lay = train_layout()
    if shard_tp() > 1 or (lay is not None and "vocab" in lay.split
                          and tokens.ndim == 2):
        from repro_torch.dist.collectives import vocab_parallel_embed
        return vocab_parallel_embed(p["table"], tokens, dtype)
    # gather, then cast: the same values as casting the whole table first
    return p["table"][tokens.long()].to(dtype)


def embed_scale(x: torch.Tensor, d_model: int) -> torch.Tensor:
    """``x * sqrt(d_model)`` with the factor rounded to x's dtype first, as
    the reference multiplies by a weakly typed scalar."""
    return x * torch.tensor(d_model ** 0.5, dtype=x.dtype, device=x.device)
