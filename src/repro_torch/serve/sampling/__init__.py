"""On-device sampling: per-request parameters as device-resident [B]
tensors, the penalty → temperature → Gumbel sampling head, and the
self-speculative accept/reject rule."""
from repro_torch.serve.sampling.ops import (accept_speculative,
                                            record_emitted, record_tokens,
                                            sample_from_hidden,
                                            speculative_accept_state)
from repro_torch.serve.sampling.params import (SamplingParams, any_uses_tt,
                                               fresh_state, pack_params,
                                               sampling_state,
                                               state_from_params,
                                               state_install)

__all__ = [
    "SamplingParams", "sampling_state", "state_from_params",
    "state_install", "pack_params", "fresh_state", "any_uses_tt",
    "sample_from_hidden", "record_tokens", "record_emitted",
    "accept_speculative", "speculative_accept_state",
]
