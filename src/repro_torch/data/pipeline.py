"""Deterministic synthetic data, sharded per host.

Stateless addressing: ``batch_at(step)`` derives every batch from (seed,
step, host shard) alone, through ``np.random.SeedSequence(entropy=seed,
spawn_key=(step, host))``, so a resumed run reads exactly the batches it
would have read, skipping ahead costs nothing, and each host draws only
its slice of the global batch. The draws are the JAX package's, so the
batches are byte-equal to its pipeline's.

The LM stream is a seeded order-2 Markov chain over the vocabulary (a
learnable structure, so losses fall and accuracies mean something); the
CNN stream draws class prototypes plus noise. Batches are numpy arrays:
the caller moves them to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.config import ModelConfig, ShapeSpec

__all__ = ["DataState", "SyntheticLM", "SyntheticCNN", "make_pipeline"]


@dataclasses.dataclass
class DataState:
    """Everything needed to resume the pipeline exactly."""
    step: int = 0
    seed: int = 0


def _rng(seed: int, step: int, host: int) -> np.random.Generator:
    # SeedSequence spawn keys are collision-free across (seed, step, host)
    return np.random.default_rng(np.random.SeedSequence(
        entropy=seed, spawn_key=(step, host)))


class SyntheticLM:
    """Order-2 Markov token stream with a host-sharded global batch."""

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
                 host_index: int = 0, host_count: int = 1,
                 markov_states: int = 64):
        if shape.global_batch % host_count:
            raise ValueError(f"global batch {shape.global_batch} does not "
                             f"split over {host_count} hosts")
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = shape.global_batch // host_count
        v = cfg.vocab_size
        self.m = min(markov_states, v)
        # the fixed (per-seed) transition structure
        g = np.random.default_rng(seed)
        self.trans = g.integers(0, self.m, size=(self.m, self.m, 4))
        self.emit = g.integers(0, v, size=(self.m,))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        g = _rng(self.seed, step, self.host_index)
        b, s = self.local_batch, self.shape.seq_len
        st = g.integers(0, self.m, size=(b, 2))
        choices = g.integers(0, 4, size=(b, s))
        toks = np.empty((b, s), np.int32)
        s0, s1 = st[:, 0], st[:, 1]
        rows = np.arange(b)
        for t in range(s):
            nxt = self.trans[s0, s1, choices[rows, t]]
            toks[:, t] = self.emit[nxt]
            s0, s1 = s1, nxt
        # causal LM: input toks[t], label toks[t+1], the last one masked
        labels = np.concatenate([toks[:, 1:], np.zeros((b, 1), np.int32)],
                                axis=1)
        batch = {"tokens": toks.astype(np.int32),
                 "labels": labels.astype(np.int32)}
        batch["loss_mask"] = np.ones((b, s), np.float32)
        batch["loss_mask"][:, -1] = 0.0
        if self.cfg.embeds_input:
            # audio stub: frame embeddings derived from the token ids
            d = self.cfg.d_model
            emb = _rng(self.seed ^ 0x5EED, 0, 0).standard_normal(
                (self.m, d)).astype(np.float32)
            frames = emb[toks % self.m] * 0.1
            batch["embeds"] = frames.astype(np.float32)
            del batch["tokens"]
        prefix = self.cfg.prefix_embed_len
        if prefix:
            d = self.cfg.d_model
            batch["prefix_embeds"] = g.standard_normal(
                (b, prefix, d)).astype(np.float32) * 0.1
            # prefix positions do not contribute to the LM loss
            pm = np.zeros((b, prefix), np.float32)
            batch["loss_mask"] = np.concatenate(
                [pm, batch["loss_mask"]], axis=1)
            batch["labels"] = np.concatenate(
                [np.zeros((b, prefix), np.int32), batch["labels"]], axis=1)
        return batch


class SyntheticCNN:
    """Class-conditional pattern + noise images (the Table I substrate)."""

    def __init__(self, cfg: ModelConfig, batch: int, seed: int = 0,
                 host_index: int = 0, host_count: int = 1):
        if batch % host_count:
            raise ValueError(f"batch {batch} does not split over "
                             f"{host_count} hosts")
        self.cfg = cfg
        self.local_batch = batch // host_count
        self.seed = seed
        self.host_index = host_index
        g = np.random.default_rng(seed)
        c, img, ch = cfg.cnn_classes, cfg.cnn_img, cfg.cnn_in_ch
        self.protos = g.standard_normal((c, img, img, ch)).astype(np.float32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        g = _rng(self.seed, step, self.host_index)
        b = self.local_batch
        labels = g.integers(0, self.cfg.cnn_classes, size=(b,))
        noise = g.standard_normal(
            (b, self.cfg.cnn_img, self.cfg.cnn_img,
             self.cfg.cnn_in_ch)).astype(np.float32)
        images = self.protos[labels] + 0.7 * noise
        return {"images": images.astype(np.float32),
                "labels": labels.astype(np.int32)}


def make_pipeline(cfg: ModelConfig, shape: Optional[ShapeSpec] = None,
                  seed: int = 0, host_index: int = 0, host_count: int = 1,
                  cnn_batch: int = 64):
    """The cnn family's image stream (``cnn_batch`` images a step), or the
    LM token stream at ``shape``."""
    if cfg.family == "cnn":
        return SyntheticCNN(cfg, cnn_batch, seed, host_index, host_count)
    if shape is None:
        raise ValueError("the LM stream needs a ShapeSpec")
    return SyntheticLM(cfg, shape, seed, host_index, host_count)
