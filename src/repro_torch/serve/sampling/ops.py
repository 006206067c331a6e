"""Device-side sampling operations of the serving engine, over the
`sampling_state` dict:

  * `sample_from_hidden`: last-position hidden state → sampled token
    through the dispatch's ``head_sample`` domain (the fused kernel where
    its guard admits, the plain sampler otherwise). Default parameters
    give the greedy token.
  * `record_tokens` / `record_emitted`: the history update (counts
    scatter-add, RNG ordinal advance), for every lane; dead rows fill
    their own lanes, which admission zeroes.
  * `accept_speculative`: the rejection-sampling rule of self-speculative
    decode. Draft token ``d_i`` (drawn from the truncated model's ``q_i``)
    is accepted iff ``u_i < p_i[d_i] / q_i[d_i]`` with ``p_i`` the full
    model's distribution; the first rejected position resamples from
    ``norm(max(p_i - q_i, 0))``, and a fully accepted draft earns a bonus
    token from ``p_k`` (the same formula with ``q_k := 0``). At
    temperature 0 every quantity is deterministic and the stream is the
    full model's greedy one.

Penalty counts are snapshotted at the start of a speculative step and
shared by all k+1 positions, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.sample.ref import (NEG_INF, SALT_ACCEPT,
                                            SALT_RESAMPLE, gumbel_noise,
                                            probs_from_logits, uniform_noise)

__all__ = ["sample_from_hidden", "record_tokens", "record_emitted",
           "accept_speculative", "speculative_accept_state"]

# floor of the draft probability in the acceptance ratio: q[d] > 0 in
# exact arithmetic, but an extreme softmax can underflow in f32
_Q_TINY = 1e-30


def sample_from_hidden(hidden: torch.Tensor, w_head: torch.Tensor,
                       state: Dict[str, torch.Tensor], *, impl: str = "xla",
                       cfg=None, use_tt: bool = False) -> torch.Tensor:
    """hidden [B, T, d] → sampled next token [B] i32 (last position).
    Inside a TP shard body the head arrives as the rank's vocab column
    slice: `dist.collectives.shard_sample` runs the same epilogue on it
    with the noise keyed to global ids and combines [B]-sized (score, id)
    pairs across the ranks."""
    from repro_torch.dist.mesh_ctx import shard_tp
    s = state
    h = hidden[:, -1].float().contiguous()
    if shard_tp() > 1:
        from repro_torch.dist.collectives import shard_sample
        return shard_sample(h, w_head, s["counts"], s["temp"], s["rep"],
                            s["pres"], s["freq"], s["seed"], s["step"],
                            top_k=s["top_k"], top_p=s["top_p"],
                            use_tt=use_tt, impl=impl, cfg=cfg)
    return dispatch.head_sample(
        h, w_head, s["counts"], s["temp"], s["rep"], s["pres"], s["freq"],
        s["seed"], s["step"], top_k=s["top_k"], top_p=s["top_p"],
        use_tt=use_tt, cfg=cfg, pallas=(impl == "pallas"))


def record_tokens(state: Dict[str, torch.Tensor], tok: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """counts[b, tok[b]] += 1 (in place) and the ordinal advances by one;
    returns the state dict with the new ``step``."""
    b = tok.shape[0]
    rows = torch.arange(b, device=tok.device)
    state["counts"].index_put_(
        (rows, tok.long()),
        torch.ones((b,), dtype=torch.int32, device=tok.device),
        accumulate=True)
    return dict(state, step=state["step"] + 1)


def record_emitted(state: Dict[str, torch.Tensor], emit: torch.Tensor,
                   n_emit: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Speculative variant: per row the first ``n_emit[b]`` entries of
    ``emit [B, k+1]`` are real (a token may repeat: the scatter
    accumulates), the rest add zero; the ordinal advances by ``n_emit``."""
    b, ke = emit.shape
    dev = emit.device
    rows = torch.arange(b, device=dev)[:, None].expand(b, ke)
    live = (torch.arange(ke, device=dev)[None, :]
            < n_emit[:, None]).to(torch.int32)
    state["counts"].index_put_((rows.reshape(-1), emit.reshape(-1).long()),
                               live.reshape(-1), accumulate=True)
    return dict(state, step=state["step"] + n_emit)


def accept_speculative(draft_tok: torch.Tensor, p_probs: torch.Tensor,
                       q_probs: torch.Tensor, seed: torch.Tensor,
                       step: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rejection-sampling acceptance of one speculative step.

    draft_tok [B, k] i32; p_probs [B, k+1, V] the full model's
    distributions at the k draft positions and the bonus position;
    q_probs [B, k, V] the draft's; seed/step [B] each row's RNG key and
    emitted-token ordinal at the start of the step. Returns ``(emit
    [B, k+1] i32, n_emit [B] i32 in 1..k+1)``: the accepted prefix, then
    the resampled (or bonus) token; entries past ``n_emit`` are garbage.

    Acceptance uniforms draw from the SALT_ACCEPT stream at ordinal
    ``step + i``, the resample from SALT_RESAMPLE Gumbel noise at
    ``step + n_acc``."""
    b, k = draft_tok.shape
    v = p_probs.shape[-1]
    dev = draft_tok.device
    pos = step[:, None] + torch.arange(k, dtype=torch.int32,
                                       device=dev)[None, :]
    u = uniform_noise(seed[:, None], pos, torch.zeros_like(pos), SALT_ACCEPT)
    d = draft_tok.long()[..., None]
    p_d = torch.gather(p_probs[:, :k], 2, d)[..., 0]            # [B, k]
    q_d = torch.gather(q_probs, 2, d)[..., 0]
    acc = u < p_d / torch.clamp(q_d, min=_Q_TINY)
    # leading run of accepts: position i survives iff 0..i all accepted
    run = torch.cumprod(acc.to(torch.int32), dim=-1)
    n_acc = run.sum(dim=-1).to(torch.int32)                     # [B] 0..k
    q_ext = torch.cat([q_probs, torch.zeros((b, 1, v), dtype=q_probs.dtype,
                                            device=dev)], dim=1)
    resid = torch.clamp(p_probs - q_ext, min=0.0)               # [B, k+1, V]
    rows = torch.arange(b, device=dev)
    r = resid[rows, n_acc.long()]                               # [B, V]
    # Gumbel-argmax over log r draws from r / sum(r); a temperature-0
    # row's r is one-hot, so NEG_INF on the other lanes makes it the argmax
    logr = torch.where(r > 0, torch.log(torch.clamp(r, min=_Q_TINY)),
                       torch.full_like(r, NEG_INF))
    col = torch.arange(v, dtype=torch.int64, device=dev)[None, :]
    g = gumbel_noise(seed[:, None], (step + n_acc)[:, None], col,
                     SALT_RESAMPLE)
    res_tok = torch.argmax(logr + g, dim=-1).to(torch.int32)
    emit = torch.cat([draft_tok.to(torch.int32),
                      torch.zeros((b, 1), dtype=torch.int32, device=dev)],
                     dim=1)
    emit[rows, n_acc.long()] = res_tok
    return emit, n_acc + 1


def speculative_accept_state(draft_tok: torch.Tensor,
                             draft_logits: torch.Tensor,
                             verify_logits: torch.Tensor,
                             state: Dict[str, torch.Tensor]
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """p and q from raw logits under the state's penalties and temperature
    (counts snapshotted for all positions), then `accept_speculative`.
    draft_logits [B, k, V]; verify_logits [B, k+1, V]."""
    s = state
    b = draft_tok.shape[0]

    def bc(x):
        return x.reshape(b, 1, 1)

    counts = s["counts"][:, None]                               # [B, 1, V]
    knobs = (bc(s["temp"]), bc(s["rep"]), bc(s["pres"]), bc(s["freq"]))
    p = probs_from_logits(verify_logits, counts, *knobs)
    q = probs_from_logits(draft_logits, counts, *knobs)
    return accept_speculative(draft_tok, p, q, s["seed"], s["step"])
