"""Serving engine: batched greedy generation from (DBB-packed) weights.

`ServeEngine.generate` runs one static batch: a prefill, then decode
steps. Generated tokens and the per-row done mask stay on the device; the
host reads one all-done flag per ``fetch_chunk`` decode steps and pulls
the token buffer once at the end. A chunk always runs all its steps: once
every row is done, the rest of its tokens are trimmed on the host, as the
reference's skipped steps are (neither feeds an output).

With ``gemm_impl="pallas"`` the stacked layer weights stay packed on the
device and stream through the DBB kernels; non-layer packed leaves are
expanded once at construction, and the tied head is made a contiguous f32
``[d, V]`` once there too, so no step copies it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.dbb import DbbWeight
from repro_torch.core.dbb_linear import decompress
from repro_torch.core.sparsity import map_with_path
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.models import registry
from repro_torch.models.common import dtype_of

__all__ = ["greedy_from_hidden", "make_prefill_step", "make_decode_step",
           "ServeEngine"]


def greedy_from_hidden(hidden: torch.Tensor, w_head: torch.Tensor,
                       impl: str = "xla",
                       cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """hidden [B, T, d] → greedy next token [B] (int32) from the last
    position, in f32. impl="pallas" hands the head GEMV to the dispatch
    (the skinny dense kernel at B ≤ 32). Ties go to the first maximum, as
    in the reference."""
    h = hidden[:, -1].float().contiguous()
    logits = dispatch.matmul(h, w_head.float(), cfg=cfg,
                             pallas=(impl == "pallas"))
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _gemm_impl(cfg: ModelConfig) -> str:
    return "pallas" if dispatch.pallas_route_active(cfg) else "xla"


def make_prefill_step(cfg: ModelConfig):
    """step(params, head, cache, tokens [B, S], start [B] | None) →
    (first generated token [B], cache)."""

    def step(params, head, cache, tokens, start=None):
        hidden, cache = registry.prefill(params, cfg, tokens, cache,
                                         start=start)
        return greedy_from_hidden(hidden[:, -1:], head,
                                  impl=_gemm_impl(cfg), cfg=cfg), cache

    return step


def make_decode_step(cfg: ModelConfig):
    """step(params, head, cache, tokens [B]) → (next tokens [B], cache)."""

    def step(params, head, cache, tokens):
        hidden, cache = registry.decode_step(params, cfg, tokens, cache)
        return greedy_from_hidden(hidden, head, impl=_gemm_impl(cfg),
                                  cfg=cfg), cache

    return step


@dataclasses.dataclass
class ServeEngine:
    """Batched greedy-decoding engine over one device.

    Construction strips the diagnostic ``indices`` plane of every packed
    leaf, moves the tree to ``device``, expands packed leaves outside the
    layer stack once and builds the contiguous f32 head. Ragged prompt
    batches are left-padded; the per-row pad counts travel as ``start``
    (only when some row is padded) so each row decodes as it would alone.
    """
    cfg: ModelConfig
    params: Any
    max_batch: int = 8
    eos_id: int = 1
    fetch_chunk: int = 8
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        dev = self.device

        def to_dev(_path, leaf):
            if isinstance(leaf, DbbWeight):
                return dataclasses.replace(leaf, indices=None).map(
                    lambda a: a.to(dev))
            return leaf.to(dev) if isinstance(leaf, torch.Tensor) else leaf

        def expand(path, leaf):
            if isinstance(leaf, DbbWeight) and not path.startswith("layers"):
                return decompress(leaf, dtype=dtype_of(self.cfg))
            return leaf

        self.params = map_with_path(
            expand, map_with_path(to_dev, self.params))
        self.head = registry.lm_head_weight(
            self.params, self.cfg).to(torch.float32).contiguous()
        self._prefill = make_prefill_step(self.cfg)
        self._decode = make_decode_step(self.cfg)
        self.last_decode_steps = 0

    def generate(self, prompts: List[List[int]],
                 max_new_tokens: int = 16) -> List[List[int]]:
        """Greedy continuation of each prompt (at most ``max_new_tokens``
        tokens, cut after ``eos_id``)."""
        if not 1 <= len(prompts) <= self.max_batch:
            raise ValueError(f"{len(prompts)} prompts for max_batch="
                             f"{self.max_batch}")
        b = len(prompts)
        max_len = max(len(p) for p in prompts)
        total = max_len + max_new_tokens
        toks = np.zeros((self.max_batch, max_len), np.int32)
        start = np.zeros((self.max_batch,), np.int32)
        for i, p in enumerate(prompts):
            toks[i, max_len - len(p):] = p          # left-pad
            start[i] = max_len - len(p)
        dev = self.device
        cache = registry.init_cache(self.cfg, self.max_batch, total,
                                    device=dev)
        st = torch.as_tensor(start, device=dev) if start.any() else None
        cur, cache = self._prefill(self.params, self.head, cache,
                                   torch.as_tensor(toks, device=dev), st)
        done = (torch.arange(self.max_batch, device=dev) >= b) | (
            cur == self.eos_id)
        chunks = [cur[None]]
        remaining = max_new_tokens - 1
        steps = 0
        while remaining > 0 and not bool(done.all()):   # one sync per chunk
            block = []
            for _ in range(self.fetch_chunk):
                cur, cache = self._decode(self.params, self.head, cache, cur)
                done = done | (cur == self.eos_id)
                block.append(cur)
            chunks.append(torch.stack(block))
            remaining -= self.fetch_chunk
            steps += self.fetch_chunk
        self.last_decode_steps = steps
        host = torch.cat(chunks).cpu().numpy()
        outs: List[List[int]] = []
        for i in range(b):
            row: List[int] = []
            for t in host[:max_new_tokens, i]:
                row.append(int(t))
                if t == self.eos_id:
                    break
            outs.append(row)
        return outs
