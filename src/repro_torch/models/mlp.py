"""Gated / plain MLP blocks (the main DBB surface of the model)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import apply_act, dispatch
from repro_torch.models.common import linear_init

__all__ = ["mlp_init", "mlp_apply", "mlp_up", "mlp_down"]


def mlp_init(gen: torch.Generator, lead, d: int, f: int, cfg: ModelConfig,
             dtype: torch.dtype, device) -> Dict:
    p = {"wi": linear_init(gen, lead, d, f, dtype, device),
         "wo": linear_init(gen, lead, f, d, dtype, device,
                           scale=1.0 / (f ** 0.5
                                        * (2 * cfg.num_layers) ** 0.5))}
    if cfg.mlp_gated:
        p["wg"] = linear_init(gen, lead, d, f, dtype, device)
    return p


def _fused_gemm(x: torch.Tensor, pp: Dict, act: str,
                cfg: ModelConfig) -> torch.Tensor:
    return dispatch.matmul(x, pp["w"], pp.get("b"), act=act,
                           out_dtype=x.dtype, cfg=cfg, pallas=True)


def _mlp_fused(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Every GEMM through the dispatch's kernel routes; a gated MLP's
    activation runs in the gate GEMM's epilogue, so the pre-activation
    never reaches memory, and the product with the up-projection is one
    elementwise multiply."""
    h = _fused_gemm(x, p["wi"], "none" if cfg.mlp_gated else cfg.act, cfg)
    if cfg.mlp_gated:
        h = _fused_gemm(x, p["wg"], cfg.act, cfg) * h
    return _fused_gemm(h, p["wo"], "none", cfg)


def mlp_up(p: Dict, cfg: ModelConfig, x: torch.Tensor
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain MLP's up-projections ``(x @ wi, x @ wg or None)`` against
    dense weights."""
    hg = x @ p["wg"]["w"].to(x.dtype) if cfg.mlp_gated else None
    return x @ p["wi"]["w"].to(x.dtype), hg


def mlp_down(p: Dict, cfg: ModelConfig, hi: torch.Tensor,
             hg: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain MLP's rest: the (gated) activation, then ``@ wo``."""
    h = apply_act(hg, cfg.act) * hi if cfg.mlp_gated else apply_act(
        hi, cfg.act)
    return h @ p["wo"]["w"].to(h.dtype)


def _mlp_plain(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Plain matmuls against dense weights (the layer was decompressed)."""
    return mlp_down(p, cfg, *mlp_up(p, cfg, x))


def mlp_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The MLP block. Inside a TP shard body ``wi`` / ``wg`` arrive
    column-split and ``wo`` row-split, so the block runs on the local
    d_ff slice and one boundary all-reduce in x's dtype sums the partial
    outputs (issued once: see `dist.collectives`). The
    reference's explicit-TP branch for a global graph under a mesh (with
    sequence parallelism) is not ported: outside a shard body every rank
    holds the whole MLP."""
    from repro_torch.dist.mesh_ctx import shard_tp
    y = (_mlp_fused(p, cfg, x) if dispatch.pallas_route_active(cfg)
         else _mlp_plain(p, cfg, x))
    if shard_tp() > 1:
        from repro_torch.dist.collectives import all_reduce
        y = all_reduce(y)
    return y
