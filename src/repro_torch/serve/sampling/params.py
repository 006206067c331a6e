"""Per-request sampling parameters and the device-resident sampling state.

`SamplingParams` is the host-side knob set a request carries. Its device
twin is a plain dict of ``[B]`` tensors, one lane per batch slot:

  * ``temp/top_p/rep/pres/freq`` f32 and ``top_k/seed/step`` i32;
  * ``counts [B, V]`` i32, the output-token history the penalties read,
    updated on the device for every emitted token (no host sync);
  * ``step``, each row's emitted-token ordinal and the RNG counter: the
    prefill-sampled token draws at step 0, every later draw at the number
    of tokens emitted before it, so streams reproduce across chunk sizes
    and speculative steps advance it by the tokens they emit.

Updates run for every lane, finished rows included; admission reinstalls
the slot (`state_install`), which zeroes its lanes. The port updates the
state tensors IN PLACE (the reference returns new arrays).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

__all__ = ["SamplingParams", "sampling_state", "state_from_params",
           "state_install", "pack_params", "fresh_state", "any_uses_tt"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """One request's sampling knobs. Every field at its default is an exact
    identity, so the default request decodes greedily."""
    temperature: float = 0.0
    top_k: int = 0                    # <= 0: off
    top_p: float = 1.0                # >= 1: off
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    seed: int = 0

    @property
    def uses_tt(self) -> bool:
        """Whether this request needs top-k / top-p masking: such a request
        sends the batch's head to the plain sampler."""
        return self.top_k > 0 or self.top_p < 1.0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def sampling_state(max_batch: int, vocab: int, device="cpu"
                   ) -> Dict[str, torch.Tensor]:
    """Fresh all-defaults state for ``max_batch`` slots."""
    def full(v, dt, shape=(max_batch,)):
        return torch.full(shape, v, dtype=dt, device=device)
    f32, i32 = torch.float32, torch.int32
    return {"temp": full(0.0, f32), "top_k": full(0, i32),
            "top_p": full(1.0, f32), "rep": full(1.0, f32),
            "pres": full(0.0, f32), "freq": full(0.0, f32),
            "seed": full(0, i32), "step": full(0, i32),
            "counts": full(0, i32, (max_batch, vocab))}


def pack_params(p: SamplingParams, device="cpu"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One request's knobs as a [5] f32 (temperature, top_p, repetition,
    presence, frequency) and a [2] i32 (top_k, seed) tensor. Seeds are
    arbitrary 32-bit patterns, wrapped into the int32 range."""
    f = torch.tensor([p.temperature, p.top_p, p.repetition_penalty,
                      p.presence_penalty, p.frequency_penalty],
                     dtype=torch.float32, device=device)
    s = p.seed & 0xFFFFFFFF
    i = torch.tensor([p.top_k, s - (1 << 32) if s >= (1 << 31) else s],
                     dtype=torch.int32, device=device)
    return f, i


def state_install(state: Dict[str, torch.Tensor], slot: int,
                  fvals: torch.Tensor, ivals: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """Install one request into batch slot ``slot`` in place: its knob
    lanes, a zero history row and RNG ordinal 0. Returns ``state``."""
    for j, key in enumerate(("temp", "top_p", "rep", "pres", "freq")):
        state[key][slot] = fvals[j]
    state["top_k"][slot] = ivals[0]
    state["seed"][slot] = ivals[1]
    state["step"][slot] = 0
    state["counts"][slot] = 0
    return state


def fresh_state(fvals: torch.Tensor, ivals: torch.Tensor, vocab: int
                ) -> Dict[str, torch.Tensor]:
    """Zero-history state of a batch of new requests from packed knob rows
    (``fvals [G, 5]`` f32, ``ivals [G, 2]`` i32, rows of `pack_params`):
    what the sampled prefills draw the first token with (RNG ordinal 0)."""
    g = fvals.shape[0]
    dev = fvals.device
    return {"temp": fvals[:, 0].contiguous(),
            "top_p": fvals[:, 1].contiguous(),
            "rep": fvals[:, 2].contiguous(),
            "pres": fvals[:, 3].contiguous(),
            "freq": fvals[:, 4].contiguous(),
            "top_k": ivals[:, 0].contiguous(),
            "seed": ivals[:, 1].contiguous(),
            "step": torch.zeros((g,), dtype=torch.int32, device=dev),
            "counts": torch.zeros((g, vocab), dtype=torch.int32,
                                  device=dev)}


def state_from_params(params: Sequence[SamplingParams], max_batch: int,
                      vocab: int, device="cpu") -> Dict[str, torch.Tensor]:
    """Whole-batch state: row i gets ``params[i]``, spare slots keep the
    defaults."""
    state = sampling_state(max_batch, vocab, device)
    for i, p in enumerate(params):
        state_install(state, i, *pack_params(p, device))
    return state


def any_uses_tt(params: Sequence[SamplingParams]) -> bool:
    return any(p.uses_tt for p in params)
