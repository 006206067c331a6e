"""The paper's own model family: small CNNs whose convolutions are
lowered to GEMM. Every conv/fc weight is a GEMM weight matrix ``[K, N]``
with K = kh·kw·c_in in the reference's im2col order, so DBB 8×1 blocks
run along the contraction dim, the layout the DBB kernels take.

``matmul="sta" | "dbb"`` sends each conv through the conv dispatch
domain: dense weights to the implicit-GEMM kernel, packed `DbbWeight`s to
its DBB variant (the im2col matrix never exists in device memory);
``use_kernel=False`` pins the explicit im2col route. ``matmul="xla"``
builds the patches explicitly and multiplies through the matmul domain.
The classifier always goes through the matmul domain.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.dbb import DbbWeight
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.kernels.conv_gemm.ref import im2col
from repro_torch.models.common import (init_generator, normal_init,
                                       param_dtype_of)

__all__ = ["cnn_init", "cnn_apply", "max_pool_2x2"]


def _matmul(x: torch.Tensor, w, mode: str, bias=None, act: str = "none",
            cfg: ModelConfig = None) -> torch.Tensor:
    return dispatch.matmul(x, w, bias, act=act, cfg=cfg,
                           pallas=(mode == "sta" or isinstance(w, DbbWeight)))


def cnn_init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Dict:
    """Random weights from ``torch.Generator`` seeded with ``seed`` (the
    reference's fan-in scales, zero biases; its jax.random draws are not
    reproduced)."""
    dev = resolve_device(device)
    gen = init_generator(dev, seed)
    dt = param_dtype_of(cfg)
    params: Dict = {}
    cin, k = cfg.cnn_in_ch, cfg.cnn_kernel
    for i, cout in enumerate(cfg.cnn_channels):
        kdim = k * k * cin
        params[f"conv{i}"] = {
            "w": normal_init(gen, (kdim, cout), 1.0 / math.sqrt(kdim), dt,
                             dev),
            "b": torch.zeros((cout,), dtype=dt, device=dev)}
        cin = cout
    img = cfg.cnn_img // (2 ** len(cfg.cnn_channels))
    fdim = cin * img * img
    params["fc"] = {
        "w": normal_init(gen, (fdim, cfg.cnn_classes), 1.0 / math.sqrt(fdim),
                         dt, dev),
        "b": torch.zeros((cfg.cnn_classes,), dtype=dt, device=dev)}
    return params


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 VALID max pool of NHWC ``x`` (an odd last row or column
    is dropped), as the reference's ``reduce_window``."""
    b, h, w, c = x.shape
    x = x[:, :2 * (h // 2), :2 * (w // 2)]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def cnn_apply(params: Dict, cfg: ModelConfig, images: torch.Tensor,
              matmul: str = "xla", use_kernel: bool = True) -> torch.Tensor:
    """images ``[B, H, W, C]`` (NHWC) → logits ``[B, classes]``."""
    if matmul not in ("xla", "sta", "dbb"):
        raise ValueError(f"matmul={matmul!r} not in ('xla', 'sta', 'dbb')")
    x = images
    k = cfg.cnn_kernel
    for i, cout in enumerate(cfg.cnn_channels):
        p = params[f"conv{i}"]
        if matmul in ("sta", "dbb"):
            y = dispatch.conv(x, p["w"], p["b"], kh=k, kw=k, act="relu",
                              cfg=cfg, use_kernel=use_kernel)
        else:
            b, h, w, _ = x.shape
            cols = im2col(x, k, k)
            y = _matmul(cols.reshape(b * h * w, -1), p["w"], matmul,
                        bias=p["b"], act="relu", cfg=cfg)
            y = y.reshape(b, h, w, cout)
        x = max_pool_2x2(y)
    flat = x.reshape(x.shape[0], -1)
    return _matmul(flat, params["fc"]["w"], matmul, bias=params["fc"]["b"],
                   cfg=cfg)
