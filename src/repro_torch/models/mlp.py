"""Gated / plain MLP blocks (the main DBB surface of the model), with
Megatron's tensor- and sequence-parallel form for a training step on a
mesh."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import apply_act, dispatch
from repro_torch.models.common import linear_init

__all__ = ["mlp_init", "mlp_apply", "mlp_up", "mlp_down", "seq_parallel_ok",
           "replicated_block"]


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


def seq_parallel_ok(cfg: ModelConfig, seq: int, tp: int) -> bool:
    """Megatron-SP eligibility: the standard transformer stacks whose
    sequence divides the model axis (the hybrid stacks keep full-sequence
    residuals: a recurrence would need halo exchanges)."""
    return (cfg.parallel != "dp"
            and cfg.family in ("dense_lm", "moe_lm", "vlm_lm", "audio_lm")
            and seq % tp == 0 and seq > tp)


def replicated_block(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` on a whole-sequence copy of ``x`` on every rank (a block whose
    weights arrive whole): inside a sequence-parallel training step the
    split stream is gathered first and the output cut back to this rank's
    block; elsewhere ``fn(x)``."""
    from repro_torch.dist.mesh_ctx import train_layout
    lay = train_layout()
    if lay is None or not lay.sp:
        return fn(x)
    from repro_torch.dist.collectives import gather_replicated, scatter
    return scatter(fn(gather_replicated(x, "model", 1)), "model", 1)


def _mlp_tp(p: Dict, cfg: ModelConfig, x: torch.Tensor, tp: int,
            sp: bool) -> torch.Tensor:
    """The block on this rank's d_ff slice (``wi`` / ``wg`` split by
    column, ``wo`` by row): a sequence-parallel stream is gathered at the
    entry and reduce-scattered at the exit, a replicated one enters
    through `copy_to` and leaves through one all-reduce."""
    from repro_torch.dist import collectives as col
    f_loc = p["wi"]["w"].shape[-1]
    if f_loc * tp != cfg.d_ff:
        raise ValueError(f"mlp: wi holds {f_loc} of d_ff {cfg.d_ff} columns "
                         f"on a model axis of {tp}: not its slice")
    xl = col.gather_partial(x, "model", 1) if sp else col.copy_to(x, "model")
    y = _mlp_plain(p, cfg, xl)
    return (col.reduce_scatter(y, "model", 1) if sp
            else col.reduce_from(y, "model"))


def mlp_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The MLP block. Inside a TP shard body ``wi`` / ``wg`` arrive
    column-split and ``wo`` row-split, so the block runs on the local
    d_ff slice and one boundary all-reduce in x's dtype sums the partial
    outputs (issued once: see `dist.collectives`). Inside a training step
    on a mesh whose layout splits the MLPs ("mlp", d_ff dividing the
    model axis: the reference's explicit-TP branch), `_mlp_tp`; with the
    weights whole, the plain block on the whole sequence
    (`replicated_block`)."""
    from repro_torch.dist.mesh_ctx import shard_tp, train_layout
    lay = train_layout()
    if shard_tp() == 0 and lay is not None:
        if "mlp" in lay.split and x.ndim == 3 and cfg.d_ff % lay.tp == 0:
            return _mlp_tp(p, cfg, x, lay.tp, lay.sp)
        return replicated_block(lambda xx: _mlp_plain(p, cfg, xx), x)
    y = (_mlp_fused(p, cfg, x) if dispatch.pallas_route_active(cfg)
         else _mlp_plain(p, cfg, x))
    if shard_tp() > 1:
        from repro_torch.dist.collectives import all_reduce
        y = all_reduce(y)
    return y
