from repro_torch.kernels.sample.ops import (head_sample_fused,
                                           head_sample_fused_ref)
from repro_torch.kernels.sample.ref import (NEG_INF, SALT_ACCEPT,
                                           SALT_RESAMPLE, SALT_TOKEN,
                                           apply_penalties, gumbel_noise,
                                           hash_u32, inv_temperature,
                                           mask_top_k, mask_top_p,
                                           probs_from_logits, sample_argmax,
                                           sample_logits, sample_scores,
                                           uniform_noise)

__all__ = [
    "head_sample_fused", "head_sample_fused_ref",
    "NEG_INF", "SALT_TOKEN", "SALT_ACCEPT", "SALT_RESAMPLE",
    "hash_u32", "uniform_noise", "gumbel_noise", "apply_penalties",
    "inv_temperature", "mask_top_k", "mask_top_p", "sample_scores",
    "sample_argmax", "sample_logits", "probs_from_logits",
]
