"""Serving engine: batched greedy, sampled and self-speculative generation
from (DBB-packed) weights.

`ServeEngine.generate` runs one static batch: a prefill, then decode
steps. `ServeEngine.serve` is continuous batching over any number of
requests: requests are admitted into free slots between decode chunks,
finished rows retire at the chunk boundary, and every request decodes
token-identically to running alone (per-row lengths, ``start`` offsets and
RoPE positions isolate the rows); rwkv6 and zamba2, whose recurrent
states have no slot-addressed cache, serve static waves through
`generate` instead and never speculate. With ``cfg.kv_page_size > 0`` serve
keeps K/V in a shared page pool instead of an ``smax`` stripe per slot and
admits a request with the pages it uses (first fit over the queue); both
layouts decode through the same paged kernel in the same page order, so
their token streams are bit-identical.

Generated tokens stay on the device; the host reads them once per
``fetch_chunk`` decode steps (one sync per chunk) and once per packed
prefill call. A chunk always runs all its steps: tokens past a row's EOS
or budget are trimmed on the host, as the reference trims its skipped
steps (neither feeds an output), and the rows' extra cache writes land
where no live row reads (see `_serve_loop_packed`).

With ``gemm_impl="pallas"`` the stacked layer weights stay packed on the
device and stream through the DBB kernels; non-layer packed leaves are
expanded once at construction, and the tied head is made a contiguous f32
``[d, V]`` once there too, so no step copies it.

``sampling=`` (one `SamplingParams` per request) samples every token on the
device — penalties, temperature and counter-hash Gumbel noise in the fused
head — with the per-row history and RNG ordinal in a sampling state that
rides beside the cache. ``draft_k > 0`` adds self-speculative decode: the
first ``draft_layers`` layers draft ``draft_k`` tokens, the full model
verifies them in one pass, and the rejection-sampling rule keeps a prefix
(1 to draft_k + 1 tokens per step).

Tensor-parallel serving: built under ``use_mesh(mesh)`` with a model axis
> 1 (`dist.mesh_ctx.make_mesh`; one process per rank, every rank calling
the same entry point on the same inputs), the engine shards its tree by
the Megatron specs (`dist.sharding.param_specs`: column-parallel QKV and
up-projections, row-parallel ``o_proj`` / ``wo``, vocab-parallel
embedding and head) and runs every step as a shard body: a localized
config (heads ÷ tp, ``head_dim`` pinned), caches of local KV heads, the
kernels at the per-shard shapes, one boundary all-reduce after each
row-parallel block, and the vocab-parallel heads' scalar combine. The host
scheduler is the same on every rank, so the token streams and page tables
are too. ``tp_reason`` says why the wrap is off ("" when it is on).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.dbb import DbbWeight
from repro_torch.core.dbb_linear import decompress
from repro_torch.core.sparsity import map_with_path
from repro_torch.device import resolve_device
from repro_torch.dist.mesh_ctx import current_mesh, shard_tp, shard_tp_ctx
from repro_torch.kernels import dispatch
from repro_torch.kernels.attn.ops import PAGE_MIN, paged_decode_ok
from repro_torch.kernels.common import SKINNY_M_MAX, skinny_ok
from repro_torch.kernels.sample import ref as smp_ref
from repro_torch.models import registry
from repro_torch.models.common import dtype_of
from repro_torch.serve import sampling as smp
from repro_torch.serve.kv_cache import (DUMMY_PAGE, PageAllocator,
                                        init_paged_cache, pages_needed)

# families with a slot-addressed K/V cache: continuous batching and
# speculative verify; the others (rwkv6's and zamba2's recurrent states)
# serve static waves through `generate`
_CONT_BATCH_FAMILIES = ("dense_lm", "moe_lm", "vlm_lm", "audio_lm")

__all__ = ["greedy_from_hidden", "greedy_head", "sample_head",
           "first_sample_head", "make_prefill_step", "make_decode_step",
           "make_packed_prefill_step", "make_chunk_prefill_step",
           "make_spec_decode_step", "ServeEngine", "tp_serve_reason"]


def greedy_from_hidden(hidden: torch.Tensor, w_head: torch.Tensor,
                       impl: str = "xla",
                       cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """hidden [B, T, d] → greedy next token [B] (int32) from the last
    position, in f32. impl="pallas" hands the head GEMV to the dispatch
    (the skinny dense kernel at B ≤ 32, the plain matmul above: as a GEMV
    it never takes the M-tiled route). Ties go to the first maximum, as
    in the reference. Inside a TP shard body the head is the rank's vocab
    column slice ``[d, V/tp]``: the local GEMV and a combine of [B]-sized
    (max, global argmax) pairs pick the token, never [B, V] logits."""
    h = hidden[:, -1].float().contiguous()
    if shard_tp() > 1:
        from repro_torch.dist.collectives import shard_greedy
        return shard_greedy(h, w_head, impl=impl, cfg=cfg)
    logits = dispatch.matmul(h, w_head.float(), cfg=cfg,
                             pallas=(impl == "pallas"), gemv=True)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _gemm_impl(cfg: ModelConfig) -> str:
    return "pallas" if dispatch.pallas_route_active(cfg) else "xla"


# A step's head turns the hidden rows it is given ([G, 1, d]: each row's
# last position) into its output; the step makers below take one, so the
# greedy and sampled steps share one body per step kind.

def greedy_head(cfg: ModelConfig):
    """head(last, w) → greedy tokens [G]."""

    def head(last, w):
        return greedy_from_hidden(last, w, impl=_gemm_impl(cfg), cfg=cfg)

    return head


def sample_head(cfg: ModelConfig, use_tt: bool = False):
    """head(last, w, sstate) → (tokens [G], sstate with them recorded):
    penalties → temperature → Gumbel noise through the dispatch (the fused
    kernel unless ``use_tt``: some row uses top-k / top-p)."""

    def head(last, w, sstate):
        nxt = smp.sample_from_hidden(last, w, sstate, impl=_gemm_impl(cfg),
                                     cfg=cfg, use_tt=use_tt)
        return nxt, smp.record_tokens(sstate, nxt)

    return head


def first_sample_head(cfg: ModelConfig, use_tt: bool = False):
    """head(last, w, fvals [G, 5], ivals [G, 2]) → the first tokens [G] of
    fresh requests (`pack_params` rows; zero history, RNG ordinal 0). The
    caller installs their state (`ServeEngine._sstate_admit`). Under a TP
    split ``w`` is the rank's vocab slice; the history covers all V."""
    sample = sample_head(cfg, use_tt)

    def head(last, w, fvals, ivals):
        vocab = w.shape[-1] * max(1, shard_tp())
        return sample(last, w, smp.fresh_state(fvals, ivals, vocab))[0]

    return head


def make_prefill_step(cfg: ModelConfig, head_fn=None):
    """step(params, head, cache, tokens [B, S], start [B] | None,
    *head_args, **inputs) → (head_fn's output — by default the greedy
    first token [B] — , cache). ``inputs``: the vlm and audio families'
    ``prefix_embeds`` / ``embeds`` (`registry.prefill`)."""
    head_fn = head_fn or greedy_head(cfg)

    def step(params, head, cache, tokens, start=None, *head_args,
             **inputs):
        hidden, cache = registry.prefill(params, cfg, tokens, cache,
                                         start=start, **inputs)
        return head_fn(hidden[:, -1:], head, *head_args), cache

    return step


def make_decode_step(cfg: ModelConfig, head_fn=None):
    """step(params, head, cache, tokens [B], *head_args) → (head_fn's
    output — by default the greedy next tokens [B]; with `sample_head`
    (tokens, sstate) — , cache)."""
    head_fn = head_fn or greedy_head(cfg)

    def step(params, head, cache, tokens, *head_args):
        hidden, cache = registry.decode_step(params, cfg, tokens, cache)
        return head_fn(hidden, head, *head_args), cache

    return step


def make_packed_prefill_step(cfg: ModelConfig, head_fn=None):
    """step(params, head, cache, tokens [1, Tp], seg_ids [Tp], positions
    [1, Tp], rows [Tp], cols [Tp], gather_idx [Gp], *head_args) →
    (next tokens [Gp], cache): one call prefills every request packed on
    the token axis; ``gather_idx`` names each request's last packed
    position, whose hidden state feeds the head (spare rows' tokens are
    never consumed)."""
    head_fn = head_fn or greedy_head(cfg)

    def step(params, head, cache, tokens, seg_ids, positions, rows, cols,
             gather_idx, *head_args):
        hidden, cache = registry.prefill_packed(
            params, cfg, tokens, seg_ids, positions, rows, cols, cache)
        last = hidden[0, gather_idx][:, None]                # [Gp, 1, d]
        return head_fn(last, head, *head_args), cache

    return step


def make_chunk_prefill_step(cfg: ModelConfig, head_fn=None):
    """step(params, head, cache, tokens [1, Cp], positions [1, Cp], rows
    [Cp], cols [Cp], kv_sel, last_idx, *head_args) → (next token [1],
    cache): one continuation chunk of one request's prompt; the token
    (from the chunk's last real position) is consumed only when the chunk
    completes the prompt."""
    head_fn = head_fn or greedy_head(cfg)

    def step(params, head, cache, tokens, positions, rows, cols, kv_sel,
             last_idx, *head_args):
        hidden, cache = registry.prefill_continue(
            params, cfg, tokens, positions, rows, cols, kv_sel, cache)
        last = hidden[:, last_idx:last_idx + 1]             # [1, 1, d]
        return head_fn(last, head, *head_args), cache

    return step


def make_spec_decode_step(cfg: ModelConfig, draft_k: int, draft_layers: int):
    """Self-speculative decode: step(params, head, cache, tokens [B],
    sstate) → ((emit [B, k+1], n_emit [B], sstate), cache).

    The truncated model (the first ``draft_layers`` layers, same embedding
    and head) drafts ``draft_k`` tokens one at a time; the full model
    verifies all k+1 positions in one pass (`registry.verify_step`); the
    rejection-sampling rule keeps a prefix and resamples the first rejected
    position. ``length`` advances by exactly ``n_emit``, so the K/V of
    rejected tokens sit above it, masked, and are rewritten by the next
    step.

    The draft writes the REAL cache in place (the reference drafts on a
    functional copy): its decode steps write slots ``length ..
    length+k-1`` of the first ``draft_layers`` layers (clamped as decode
    clamps), while ``cache["length"]`` and the block table stay as they
    are (decode returns a new dict). Verify then rewrites slots ``length ..
    length+k`` in every layer — a superset of the draft's slots under the
    same clamping and page mapping — before anything reads them, so the
    final cache and every read equal the reference's, without a copy of
    the first layers' K/V per step.

    Top-k / top-p batches never get here (the engine turns speculation off
    for them): the acceptance rule needs untruncated p and q."""
    nd, k = draft_layers, draft_k
    if not 0 < nd < cfg.num_layers:
        raise ValueError(f"draft_layers={nd} outside [1, "
                         f"{cfg.num_layers - 1}]")
    dcfg = cfg.replace(num_layers=nd)
    pallas = _gemm_impl(cfg) == "pallas"

    def head_logits(h2d, head):
        """[M, d] → [M, V] f32 logits (the accept rule needs whole
        distributions): the skinny dense kernel at M ≤ 32, the plain
        matmul above, as the reference's head GEMV. Under a TP split each
        rank's [M, V/tp] columns are gathered (M ≤ B·(k+1) rows)."""
        lg = dispatch.matmul(h2d.float().contiguous(), head, cfg=cfg,
                             pallas=pallas, gemv=True)
        if shard_tp() > 1:
            from repro_torch.dist.collectives import all_gather
            lg = all_gather(lg, dim=-1)
        return lg

    def step(params, head, cache, tokens, sstate):
        s = sstate
        b = tokens.shape[0]
        # draft: decode_step over the first nd layers of the stacked
        # weights and cache (layer-indexed, so nothing is sliced or copied)
        dcache, cur = cache, tokens
        d_toks, d_lgs = [], []
        for i in range(k):
            hidden, dcache = registry.decode_step(params, dcfg, cur, dcache)
            lg = head_logits(hidden[:, -1], head)
            # counts snapshotted for the step; ordinal step+i is the draw
            # counter a token-at-a-time loop would use
            cur = smp_ref.sample_logits(
                lg, s["counts"], s["temp"], s["top_k"], s["top_p"],
                s["rep"], s["pres"], s["freq"], s["seed"], s["step"] + i)
            d_toks.append(cur)
            d_lgs.append(lg)
        draft_tok = torch.stack(d_toks, dim=1)               # [B, k]
        draft_lg = torch.stack(d_lgs, dim=1)                 # [B, k, V]
        # verify: the full model over [tokens, d_0..d_{k-1}]
        vt = torch.cat([tokens[:, None], draft_tok], dim=1)
        hidden, cache = registry.verify_step(params, cfg, vt, cache)
        vlg = head_logits(hidden.reshape(b * (k + 1), -1), head)
        emit, n_emit = smp.speculative_accept_state(
            draft_tok, draft_lg, vlg.reshape(b, k + 1, -1), s)
        new_cache = dict(cache, length=cache["length"] + n_emit)
        return (emit, n_emit, smp.record_emitted(s, emit, n_emit)), new_cache

    return step


def tp_serve_reason(cfg: ModelConfig, mesh=None, params: Any = None) -> str:
    """Why the TP serving wrap is NOT on ("" when it is). The wrap splits
    heads, KV heads, d_ff and the vocab over the model axis, so each must
    divide it; with ``params`` the inferred specs must split every
    TP-eligible leaf (`dist.sharding.tp_spec_violations`: a leaf the
    divisibility fallback kept whole would be summed tp times). The
    reference's reasons, in its order, and one of the port's own: a w4
    row-parallel leaf, whose group scales the reference's row rule keeps
    whole against a K slice (`dist.sharding`), is refused rather than
    served wrong."""
    from repro_torch.dist.sharding import (param_specs, tp_spec_violations,
                                           w4_row_leaves)
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None or "model" not in mesh.axis_names \
            or mesh.shape["model"] <= 1:
        return "no live mesh with a model axis > 1"
    tp = mesh.shape["model"]
    if cfg.gemm_impl != "pallas":
        return (f"gemm_impl={cfg.gemm_impl!r} — the wrap exists to put the "
                "kernels on per-shard shapes; the plain route serves whole "
                "on every rank")
    if cfg.parallel == "dp":
        return 'parallel="dp": the model axis carries ZeRO, not TP'
    if cfg.family not in _CONT_BATCH_FAMILIES or cfg.family == "moe_lm":
        return (f"family {cfg.family!r}: MoE expert dispatch / SSM state "
                "keep their own sharding (no generic KV-head split)")
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        return (f"heads do not divide the model axis: num_heads="
                f"{cfg.num_heads}, num_kv_heads={cfg.num_kv_heads}, "
                f"tp={tp}")
    if cfg.d_ff % tp:
        return f"d_ff={cfg.d_ff} % tp={tp} != 0 (column-parallel MLP split)"
    if cfg.vocab_size % tp:
        return (f"vocab_size={cfg.vocab_size} % tp={tp} != 0 "
                "(vocab-parallel embed/head split)")
    if params is not None:
        gaps = tp_spec_violations(
            params, param_specs(params, mesh, cfg, fsdp_min_shard_elems=None))
        if gaps:
            return ("weight leaves fall back to replication under the TP "
                    "specs (packed K-planes must split on DBB block "
                    "boundaries): " + ", ".join(gaps[:4])
                    + ("..." if len(gaps) > 4 else ""))
        w4 = w4_row_leaves(params)
        if w4:
            return ("bits=4 row-parallel leaves: their K planes split but "
                    "the [K//G, N] group-scale plane stays whole (the "
                    "reference's row rule), so a shard would scale its K "
                    "slice by the first slice's groups: " + ", ".join(w4[:4])
                    + ("..." if len(w4) > 4 else ""))
    return ""


def _consume_slot(host_emit: np.ndarray, host_nem: np.ndarray, slot: int,
                  row: List[int], left: int, eos_id: int
                  ) -> Tuple[int, bool]:
    """Drain one slot's tokens from a fetched chunk into ``row``:
    ``host_emit [steps, B, ke]`` / ``host_nem [steps, B]`` — per step the
    first ``host_nem[s, slot]`` entries are real (speculative steps emit 1
    to k+1, the others 1). Stops at EOS or when the request's remaining
    budget ``left`` runs out (later tokens are discarded). Returns
    (remaining budget, finished)."""
    for s in range(host_emit.shape[0]):
        for j in range(int(host_nem[s, slot])):
            t = int(host_emit[s, slot, j])
            row.append(t)
            left -= 1
            if t == eos_id or left <= 0:
                return left, True
    return left, False


def _bump_spec_stats(stats: Dict[str, Any], host_n: np.ndarray,
                     active: Dict[int, int]) -> None:
    """Speculative accounting over a chunk's live slots: steps run and
    tokens emitted (acceptance rate = ``(spec_emitted / spec_steps - 1) /
    draft_k``; steps past a row's budget count too, as in the
    reference)."""
    stats["spec_steps"] = (stats.get("spec_steps", 0)
                           + host_n.shape[0] * len(active))
    stats["spec_emitted"] = (stats.get("spec_emitted", 0)
                             + sum(int(host_n[:, s].sum()) for s in active))


def _bucket_len(n: int, minimum: int = 8) -> int:
    """``n`` rounded up to a power-of-two bucket (≥ minimum): the padded
    admission's prompt length, serve's cache length and the packed
    prefill's token count, as in the reference (where it bounds the number
    of compiled shapes; the counts in ``serve_stats`` follow it)."""
    b = max(minimum, 1)
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class ServeEngine:
    """Batched decoding engine over one device: greedy, or sampled per
    request (``sampling=``), optionally self-speculative (``draft_k``).

    Construction strips the diagnostic ``indices`` plane of every packed
    leaf, moves the tree to ``device``, expands packed leaves outside the
    layer stack once and builds the contiguous f32 head. Under a live TP
    mesh (module doc) it first cuts this rank's shard out of the tree, so
    the head is the local ``[d, V/tp]`` slice. Ragged prompt
    batches are left-padded; the per-row pad counts travel as ``start``
    (only when some row is padded) so each row decodes as it would alone.

    serve() options: ``kv_pool_pages`` sizes the paged pool (0: as many
    pages as the contiguous cache holds, plus the dummy); ``paged`` None
    pages iff ``cfg.kv_page_size > 0``, False pins the contiguous cache
    (the kernel still decodes in ``kv_page_size`` pages); ``prefill_mode``
    "packed" concatenates admitted prompts on one token axis, "padded"
    prefills each left-padded to its bucket; ``prefill_chunk`` > 0 splits
    packed prefills into chunks of that many tokens between decode chunks.
    ``draft_k`` > 0 drafts that many tokens per step on sampled calls
    (a call's ``draft_k=`` overrides it) with the first ``draft_layers``
    layers (0: half of them).
    """
    cfg: ModelConfig
    params: Any
    max_batch: int = 8
    eos_id: int = 1
    fetch_chunk: int = 8
    kv_pool_pages: int = 0
    paged: Optional[bool] = None
    prefill_mode: str = "packed"
    prefill_chunk: int = 0
    draft_k: int = 0
    draft_layers: int = 0
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        dev = self.device
        mesh = current_mesh()
        self.tp_reason = tp_serve_reason(self.cfg, mesh, self.params)
        self._tp = 0 if self.tp_reason else mesh.shape["model"]
        # the config the model steps and caches run under: heads and KV
        # heads ÷ tp in a shard (head_dim pinned, so it survives)
        self._lcfg = self.cfg
        if self._tp:
            from repro_torch.dist.sharding import param_specs, shard_tree
            self.params = shard_tree(self.params, param_specs(
                self.params, mesh, self.cfg, fsdp_min_shard_elems=None), mesh)
            self._lcfg = self.cfg.replace(
                num_heads=self.cfg.num_heads // self._tp,
                num_kv_heads=self.cfg.num_kv_heads // self._tp,
                head_dim=self.cfg.resolved_head_dim)

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
        self.vocab = self.head.shape[-1] * max(1, self._tp)
        self._prefill = self._tp_step(make_prefill_step)
        self._decode = self._tp_step(make_decode_step)
        self._packed_prefill = self._tp_step(make_packed_prefill_step)
        self._prefill_continue = self._tp_step(make_chunk_prefill_step)
        self._sample_steps: Dict[Tuple[bool, int], Any] = {}
        self.last_decode_steps = 0
        self.serve_stats: Dict[str, Any] = {}

    def _tp_step(self, maker, *head):
        """``maker(cfg, *head)`` on the localized config; under the TP wrap
        each call runs as a shard body (`shard_tp_ctx`). ``head``: head
        makers, called on the same config."""
        inner = maker(self._lcfg, *(h(self._lcfg) for h in head))
        if not self._tp:
            return inner
        tp = self._tp

        def stepped(*args, **kwargs):
            with shard_tp_ctx(tp):
                return inner(*args, **kwargs)

        return stepped

    # -- decode chunks: one host fetch per chunk ----------------------------

    def _resolved_draft_layers(self) -> int:
        return self.draft_layers or max(1, self.cfg.num_layers // 2)

    def _sample_step(self, use_tt: bool, dk: int):
        """The sampled (``dk`` = 0) or speculative decode step."""
        key = (use_tt, dk)
        if key not in self._sample_steps:
            nd = self._resolved_draft_layers()
            self._sample_steps[key] = (
                self._tp_step(lambda c: make_spec_decode_step(c, dk, nd))
                if dk else self._tp_step(
                    make_decode_step, lambda c: sample_head(c, use_tt)))
        return self._sample_steps[key]

    def _fetch_chunk(self, cache: Dict, cur: torch.Tensor, sstate,
                     steps: int, mode: Optional[Tuple[bool, int]]):
        """``steps`` decode steps, then ONE fetch of their tokens: (last
        tokens, cache, sstate, host emit [steps, B, ke], host n_emit
        [steps, B]). ``mode`` None decodes greedily, else ``(use_tt,
        draft_k)`` samples (``ke = draft_k + 1``)."""
        self.last_decode_steps += steps
        dk = mode[1] if mode else 0
        step = self._decode if mode is None else self._sample_step(*mode)
        emits, nems = [], []
        for _ in range(steps):
            if mode is None:
                cur, cache = step(self.params, self.head, cache, cur)
                emit = cur[:, None]
            elif dk:
                (emit, nem, sstate), cache = step(self.params, self.head,
                                                  cache, cur, sstate)
                cur = emit.gather(1, (nem - 1).long()[:, None])[:, 0]
                nems.append(nem)
            else:
                (cur, sstate), cache = step(self.params, self.head, cache,
                                            cur, sstate)
                emit = cur[:, None]
            emits.append(emit)
        host_e = torch.stack(emits).cpu().numpy()
        host_n = (torch.stack(nems).cpu().numpy() if dk
                  else np.ones(host_e.shape[:2], np.int64))
        return cur, cache, sstate, host_e, host_n

    @staticmethod
    def _sstate_admit(sstate, slot: int, fvals, ivals, tok: int) -> None:
        """Install an admitted request's sampling lanes at ``slot`` with its
        prefill-sampled first token already in the history (count 1, RNG
        ordinal 1), as the prefill's own state recorded it."""
        smp.state_install(sstate, slot, fvals, ivals)
        sstate["counts"][slot, tok] += 1
        sstate["step"][slot] = 1

    # -- static batch -------------------------------------------------------

    def _left_pad(self, prompts: List[List[int]]):
        """(tokens [max_batch, max_len] left-padded on the device, start
        [max_batch] or None when no row is padded, max_len)."""
        max_len = max(len(p) for p in prompts)
        toks = np.zeros((self.max_batch, max_len), np.int32)
        start = np.zeros((self.max_batch,), np.int32)
        for i, p in enumerate(prompts):
            toks[i, max_len - len(p):] = p          # left-pad
            start[i] = max_len - len(p)
        st = torch.as_tensor(start, device=self.device) if start.any() \
            else None
        return torch.as_tensor(toks, device=self.device), st, max_len

    def generate(self, prompts: List[List[int]], max_new_tokens: int = 16,
                 sampling: Optional[Sequence[smp.SamplingParams]] = None,
                 draft_k: Optional[int] = None) -> List[List[int]]:
        """Continuation of each prompt (at most ``max_new_tokens`` tokens,
        cut after ``eos_id``): greedy, or sampled with one `SamplingParams`
        per prompt (``draft_k`` > 0: self-speculative). One host fetch per
        decode chunk."""
        b = len(prompts)
        if not 1 <= b <= self.max_batch:
            raise ValueError(f"{b} prompts for max_batch={self.max_batch}")
        if sampling is not None and len(sampling) != b:
            raise ValueError(f"{len(sampling)} SamplingParams for {b} "
                             "prompts")
        mode = None if sampling is None else self._spec_mode(sampling,
                                                             draft_k)
        dk = mode[1] if mode else 0
        ke = dk + 1
        toks, st, max_len = self._left_pad(prompts)
        # speculative verify writes a (k+1)-slot slab at the write cursor:
        # the cache gets that margin past the budget
        total = max_len + max_new_tokens + (ke if dk else 0)
        cache = registry.init_cache(self._lcfg, self.max_batch, total,
                                    device=self.device)
        if (mode is None and st is not None
                and self.cfg.family in ("rwkv6", "zamba2")):
            # the reference warns on its greedy path only
            warnings.warn(
                f"{self.cfg.family}: ragged batch pads feed the "
                "recurrent state — short prompts may decode "
                "differently than solo (needs right-padding + state "
                "masking; see transformer.prefill)", stacklevel=2)
        if mode is None:
            cur, cache = self._prefill(self.params, self.head, cache, toks,
                                       st)
            sstate = None
        else:
            knobs = self._knob_rows(sampling, self.max_batch)
            cur, cache = self._tp_step(
                make_prefill_step, lambda c: first_sample_head(c, mode[0]))(
                    self.params, self.head, cache, toks, st, *knobs)
            sstate = smp.record_tokens(
                smp.fresh_state(*knobs, self.vocab), cur)
        first = np.zeros((1, self.max_batch, ke), np.int64)
        first[0, :, 0] = cur.cpu().numpy()
        he, hn = [first], [np.ones((1, self.max_batch), np.int64)]
        done = (np.arange(self.max_batch) >= b) | (first[0, :, 0]
                                                   == self.eos_id)
        got = np.ones((self.max_batch,), np.int64)
        self.last_decode_steps = 0
        while not np.all(done | (got >= max_new_tokens)):
            cur, cache, sstate, host_e, host_n = self._fetch_chunk(
                cache, cur, sstate, self.fetch_chunk, mode)
            real = np.arange(ke)[None, None, :] < host_n[:, :, None]
            done |= ((host_e == self.eos_id) & real).any(axis=(0, 2))
            got += host_n.sum(axis=0)
            he.append(host_e)
            hn.append(host_n)
        host_e, host_n = np.concatenate(he), np.concatenate(hn)
        outs: List[List[int]] = [[] for _ in range(b)]
        for i, row in enumerate(outs):
            _consume_slot(host_e, host_n, i, row, max_new_tokens,
                          self.eos_id)
        return outs

    def _spec_mode(self, sampling: Sequence[smp.SamplingParams],
                   draft_k: Optional[int]) -> Tuple[bool, int]:
        """A sampled call's (use_tt, draft_k), with speculation turned off
        (a warning, not an error) where the batch or model cannot take
        it."""
        use_tt = smp.any_uses_tt(sampling)
        dk = self.draft_k if draft_k is None else draft_k
        if dk > 0:
            reason = ""
            if self.cfg.family not in _CONT_BATCH_FAMILIES:
                reason = (f"family {self.cfg.family!r} has no "
                          "slot-addressed K/V cache for batched verify")
            elif use_tt:
                reason = ("top-k/top-p requests in the batch — the "
                          "acceptance rule needs untruncated p/q")
            elif self.cfg.num_layers < 2:
                reason = "needs num_layers >= 2 to truncate a draft"
            if reason:
                warnings.warn(f"speculative decode disabled ({reason}) — "
                              "serving with plain sampling", stacklevel=3)
                dk = 0
        return use_tt, dk

    def _knob_rows(self, sampling: Sequence[smp.SamplingParams], rows: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(fvals [rows, 5], ivals [rows, 2]) on the device: row i packs
        ``sampling[i]``; spare rows carry identity knobs (temperature 0,
        top_p 1, repetition 1), whose tokens are never consumed."""
        fv = np.zeros((rows, 5), np.float32)
        fv[:, 1] = fv[:, 2] = 1.0
        iv = np.zeros((rows, 2), np.int32)
        for i, sp in enumerate(sampling):
            f, ivv = smp.pack_params(sp)
            fv[i], iv[i] = f.numpy(), ivv.numpy()
        return (torch.as_tensor(fv, device=self.device),
                torch.as_tensor(iv, device=self.device))

    # -- continuous batching ----------------------------------------------

    def serve(self, prompts: List[List[int]],
              max_new_tokens: Union[int, Sequence[int]] = 16,
              fetch_chunk: Optional[int] = None,
              prompt_bucket: int = 8,
              prefill_mode: Optional[str] = None,
              prefill_chunk: Optional[int] = None,
              sampling: Optional[Sequence[smp.SamplingParams]] = None,
              draft_k: Optional[int] = None) -> List[List[int]]:
        """Continuous-batching decode over any number of requests: greedy,
        or sampled with one `SamplingParams` per request (``draft_k`` > 0:
        self-speculative; it applies to sampled calls only).

        ``max_new_tokens``: one budget for all requests or one per request.
        Requests are admitted into free slots between decode chunks and
        retire when they hit EOS or their budget, so the batch stays full
        while work is queued. ``prefill_mode`` / ``prefill_chunk``
        override the engine's defaults for this call. Counters of the run
        land in ``self.serve_stats``."""
        n_req = len(prompts)
        if isinstance(max_new_tokens, int):
            budgets = [max_new_tokens] * n_req
        else:
            budgets = list(max_new_tokens)
            if len(budgets) != n_req:
                raise ValueError(f"{len(budgets)} budgets for {n_req} "
                                 "prompts")
        if sampling is not None and len(sampling) != n_req:
            raise ValueError(f"{len(sampling)} SamplingParams for {n_req} "
                             "prompts")
        if n_req == 0:
            return []
        if self.cfg.family not in _CONT_BATCH_FAMILIES:
            return self._serve_waves(prompts, budgets, sampling, draft_k)
        mode = None if sampling is None else self._spec_mode(sampling,
                                                             draft_k)
        # speculative margin: verify writes a (k+1)-slot slab at the write
        # cursor, so every reservation (and smax) carries that headroom
        dmargin = mode[1] + 1 if mode and mode[1] else 0
        chunk = fetch_chunk or self.fetch_chunk
        blens = [_bucket_len(len(p), prompt_bucket) for p in prompts]
        smax = _bucket_len(max(blens) + max(budgets) + dmargin,
                           prompt_bucket)
        if self.cfg.kv_page_size > 0:
            # page-align smax for both layouts: the contiguous cache must
            # decode through the same kernel and pages as the paged pool
            page = self.cfg.kv_page_size
            smax = -(-smax // page) * page
        use_paged = (self.cfg.kv_page_size > 0 if self.paged is None
                     else self.paged)
        if use_paged:
            reason = _paged_unsupported_reason(self.cfg)
            if reason:
                warnings.warn(f"paged KV serving unavailable ({reason}) — "
                              "falling back to the contiguous scheduler",
                              stacklevel=2)
                use_paged = False
        backend = (_PagedKvBackend(self, smax) if use_paged
                   else _ContiguousKvBackend(self, smax))
        run = _ServeRun(self, prompts, budgets, blens, chunk, backend,
                        sampling, mode, dmargin)
        self.last_decode_steps = 0
        pmode = prefill_mode if prefill_mode is not None \
            else self.prefill_mode
        if pmode == "packed":
            pchunk = (prefill_chunk if prefill_chunk is not None
                      else self.prefill_chunk)
            return self._serve_loop_packed(run, pchunk)
        if pmode == "padded":
            return self._serve_loop(run, smax)
        raise ValueError(f"prefill_mode={pmode!r}: 'packed' or 'padded'")

    def _serve_waves(self, prompts: List[List[int]], budgets: List[int],
                     sampling, draft_k: Optional[int]) -> List[List[int]]:
        """A family without a slot-addressed K/V cache (rwkv6's or zamba2's
        recurrent state cannot be scattered into a slot) serves as static waves of
        ``max_batch`` requests through `generate`, each output cut to its
        own budget (a warning says so)."""
        warnings.warn(
            f"{self.cfg.family}: continuous batching needs the attention "
            "K/V cache layout — falling back to static waves", stacklevel=3)
        outs: List[List[int]] = []
        for i in range(0, len(prompts), self.max_batch):
            wave_b = budgets[i:i + self.max_batch]
            res = self.generate(
                prompts[i:i + self.max_batch], max_new_tokens=max(wave_b),
                sampling=(None if sampling is None
                          else sampling[i:i + self.max_batch]),
                draft_k=draft_k)
            outs.extend(r[:bud] for r, bud in zip(res, wave_b))
        return outs

    def _decode_and_retire(self, run: "_ServeRun", cache: Dict,
                           cur: torch.Tensor) -> Tuple[Dict, torch.Tensor,
                                                       List[int]]:
        """One decode chunk over the batch, drained into the active
        requests' outputs; returns (cache, cur, the slots whose request
        finished — already out of ``run.active``)."""
        cur, cache, run.sstate, host_e, host_n = self._fetch_chunk(
            cache, cur, run.sstate, run.chunk, run.mode)
        if run.mode and run.mode[1]:
            _bump_spec_stats(run.backend.stats, host_n, run.active)
        retired = []
        for slot, ridx in run.active.items():
            run.left[ridx], fin = _consume_slot(host_e, host_n, slot,
                                                run.outs[ridx],
                                                run.left[ridx], self.eos_id)
            if fin:
                retired.append(slot)
        for slot in retired:
            del run.active[slot]
        return cache, cur, retired

    def _serve_loop(self, run: "_ServeRun", smax: int) -> List[List[int]]:
        """Padded admission: each request prefills alone, left-padded to
        its bucket, into a one-row cache that the backend scatters into
        the shared cache (its slot stripe, or its granted pages)."""
        dev = self.device
        backend, prompts, budgets, blens = (run.backend, run.prompts,
                                            run.budgets, run.blens)
        cache = backend.init_cache()
        cur = torch.zeros((self.max_batch,), dtype=torch.int32, device=dev)
        queue = deque(range(len(prompts)))
        free = list(range(self.max_batch))
        # one scratch cache for every admission: each prefill overwrites
        # slots 0..bucket-1, and slots past a row's length are written by
        # decode before it attends them
        c1_template = registry.init_cache(self._lcfg, 1, smax, device=dev)

        def admit(slot: int, ridx: int):
            grant = backend.reserve(ridx, blens[ridx],
                                    budgets[ridx] + run.dmargin)
            if grant is None:
                return "defer"                       # wait for retirements
            p, bl = prompts[ridx], blens[ridx]
            toks = np.zeros((1, bl), np.int32)
            toks[0, bl - len(p):] = p                # left-pad to bucket
            toks = torch.as_tensor(toks, device=dev)
            st = torch.tensor([bl - len(p)], dtype=torch.int32, device=dev)
            nxt1, c1 = run.prefill("padded")(
                self.params, self.head, c1_template, toks, st,
                *run.knob_rows([ridx]))
            tok = int(nxt1[0])                       # first generated token
            run.outs[ridx].append(tok)
            if tok == self.eos_id or budgets[ridx] <= 1:
                backend.release(grant)
                return False                         # finished at prefill
            backend.admit(cache, c1, slot, grant)
            cur[slot] = tok
            if run.sampled:
                self._sstate_admit(run.sstate, slot, *run.knobs(ridx), tok)
            run.active[slot] = ridx
            run.left[ridx] = budgets[ridx] - 1
            return True

        while queue or run.active:
            # first-fit admission between decode chunks: a request whose
            # reservation does not fit yet is skipped (kept in arrival
            # order), so short requests fill slots behind a deferred long
            # one. The contiguous backend always grants: plain FIFO.
            skipped: List[int] = []
            while queue and free:
                ridx = queue.popleft()
                if budgets[ridx] <= 0:
                    continue
                slot = free.pop()
                r = admit(slot, ridx)
                if r == "defer":
                    free.append(slot)
                    skipped.append(ridx)
                    backend.stats["deferred_admissions"] += 1
                    continue
                if not r:
                    free.append(slot)
            queue.extendleft(reversed(skipped))
            if not run.active:
                if queue:        # deferred with nothing left to retire
                    backend.starved(queue[0], blens, budgets)
                continue
            backend.stats["peak_active"] = max(
                backend.stats["peak_active"], len(run.active))
            cache, cur, retired = self._decode_and_retire(run, cache, cur)
            for slot in retired:
                free.append(slot)
                backend.retire(cache, slot)
        self.serve_stats = backend.stats
        return run.outs

    def _serve_loop_packed(self, run: "_ServeRun", prefill_chunk: int
                           ) -> List[List[int]]:
        """Padding-free continuous batching. Differences from `_serve_loop`:

        * Admission splits into slot assignment (reserve cache space, no
          compute) and prefill. Assigned requests wait in ``pending``; the
          decode batch never reads a half-prefilled row.
        * All first chunks pack into ONE call per scheduler iteration (no
          pad row inside a request; the bucket's tail is dropped by the
          K/V scatter) and rows install with ``start = 0``.
        * With ``prefill_chunk > 0`` at most that many prompt tokens
          prefill between consecutive decode chunks (continuations first,
          FIFO, one chunk per row per iteration).

        Free and half-prefilled rows still decode-step (the chunk runs the
        whole batch); their K/V writes land where no live row reads:
        contiguous rows park their write cursor at ``smax`` (the clamped
        write hits slot smax-1 — a speculative verify's slab smax-k-1 ..
        smax-1 — which a live row overwrites before it attends it, and
        which lies past every prompt thanks to the budget and speculative
        margin), paged rows write through a table row that points at the
        dummy page."""
        t0 = time.perf_counter()
        dev = self.device
        backend, prompts, budgets = run.backend, run.prompts, run.budgets
        cache = backend.init_cache()
        paged = "k_pages" in cache
        if not paged:
            cache["length"].fill_(backend.smax)
        cur = torch.zeros((self.max_batch,), dtype=torch.int32, device=dev)
        queue = deque(range(len(prompts)))
        free = list(range(self.max_batch))
        # slot -> [ridx, prefilled offset, grant] (insertion order = FIFO)
        pending: Dict[int, list] = {}
        stats = backend.stats
        stats.update(prefill_calls=0, packed_prefill_tokens=0,
                     prompt_tokens=0, max_prefill_call_tokens=0,
                     prefill_iters=0)
        ttft: Dict[int, float] = {}

        def bump(tokens_padded: int, tokens_real: int):
            stats["prefill_calls"] += 1
            stats["packed_prefill_tokens"] += tokens_padded
            stats["prompt_tokens"] += tokens_real
            stats["max_prefill_call_tokens"] = max(
                stats["max_prefill_call_tokens"], tokens_padded)

        def complete(slot: int, st: list, tok: int):
            ridx, grant = st[0], st[2]
            run.outs[ridx].append(tok)
            ttft[ridx] = time.perf_counter() - t0
            del pending[slot]
            if tok == self.eos_id or budgets[ridx] <= 1:
                backend.release(grant)
                free.append(slot)
                return
            backend.install(cache, slot, len(prompts[ridx]), grant)
            cur[slot] = tok
            if run.sampled:
                self._sstate_admit(run.sstate, slot, *run.knobs(ridx), tok)
            run.active[slot] = ridx
            run.left[ridx] = budgets[ridx] - 1

        def to_dev(a: np.ndarray) -> torch.Tensor:
            return torch.as_tensor(a, device=dev)

        def run_continue(slot: int, st: list) -> int:
            nonlocal cache
            ridx, off = st[0], st[1]
            p = prompts[ridx]
            c = (min(len(p) - off, prefill_chunk) if prefill_chunk > 0
                 else len(p) - off)
            cp = _bucket_len(c, 8)
            toks = np.zeros((1, cp), np.int32)
            toks[0, :c] = p[off:off + c]
            pos = off + np.arange(cp, dtype=np.int32)
            rows = np.full((cp,), backend.pad_row(), np.int32)
            cols = np.zeros((cp,), np.int32)
            rows[:c], cols[:c] = backend.token_addr(
                slot, st[2], np.arange(off, off + c, dtype=np.int64))
            args = (self.params, self.head, cache, to_dev(toks),
                    to_dev(pos)[None], torch.from_numpy(rows),
                    torch.from_numpy(cols), backend.kv_sel(slot, st[2]),
                    c - 1, *run.knob_rows([ridx]))
            nxt, cache = run.prefill("chunk")(*args)
            st[1] = off + c
            bump(cp, c)
            if st[1] == len(p):
                complete(slot, st, int(nxt[0]))
            return c

        while queue or pending or run.active:
            # 1) slot assignment: reservation only, arrival order; a
            # deferred reservation (paged pool exhausted) is skipped, not
            # head-of-line blocking
            skipped: List[int] = []
            while queue and free:
                ridx = queue.popleft()
                if budgets[ridx] <= 0:
                    continue
                grant = backend.reserve(ridx, len(prompts[ridx]),
                                        budgets[ridx] + run.dmargin)
                if grant is None:
                    skipped.append(ridx)
                    stats["deferred_admissions"] += 1
                    continue
                pending[free.pop()] = [ridx, 0, grant]
            queue.extendleft(reversed(skipped))
            if not pending and not run.active:
                if queue:        # deferred with nothing left to retire
                    backend.starved(queue[0], run.blens, budgets)
                continue

            # 2) prefill: ≤ prefill_chunk prompt tokens this iteration
            # (always ≥ one chunk of progress when anything is pending) —
            # continuations first, then the packed first-chunk call
            budget = prefill_chunk if prefill_chunk > 0 else float("inf")
            spent = 0
            if pending:
                stats["prefill_iters"] += 1
            for slot, st in list(pending.items()):
                if st[1] == 0:
                    continue
                if spent >= budget:
                    break
                spent += run_continue(slot, st)
            items = []
            for slot, st in list(pending.items()):
                if st[1] != 0:
                    continue
                length = len(prompts[st[0]])
                c = (min(length, prefill_chunk) if prefill_chunk > 0
                     else length)
                if (spent > 0 or items) and spent + c > budget:
                    break
                items.append((slot, st, c))
                spent += c
            if items:
                total = sum(c for _, _, c in items)
                tp = _bucket_len(total, 8)
                toks = np.zeros((tp,), np.int32)
                # pad positions carry segment id n_items: larger than every
                # real id (ids stay non-decreasing), matched by no request
                seg = np.full((tp,), len(items), np.int32)
                pos = np.zeros((tp,), np.int32)
                rows = np.full((tp,), backend.pad_row(), np.int32)
                cols = np.zeros((tp,), np.int32)
                gidx = np.zeros((_bucket_len(len(items), 1),), np.int64)
                off = 0
                for i, (slot, st, c) in enumerate(items):
                    toks[off:off + c] = prompts[st[0]][:c]
                    seg[off:off + c] = i
                    pos[off:off + c] = np.arange(c)
                    rows[off:off + c], cols[off:off + c] = \
                        backend.token_addr(slot, st[2],
                                           np.arange(c, dtype=np.int64))
                    gidx[i] = off + c - 1
                    off += c
                args = (self.params, self.head, cache, to_dev(toks)[None],
                        to_dev(seg), to_dev(pos)[None],
                        torch.from_numpy(rows), torch.from_numpy(cols),
                        to_dev(gidx), *run.knob_rows(
                            [st[0] for _, st, _ in items], gidx.shape[0]))
                nxt, cache = run.prefill("packed")(*args)
                bump(tp, total)
                host_tok = None
                for i, (slot, st, c) in enumerate(items):
                    st[1] = c
                    if c == len(prompts[st[0]]):
                        if host_tok is None:     # one sync per packed call
                            host_tok = nxt.cpu().numpy()
                        complete(slot, st, int(host_tok[i]))

            # 3) decode chunk + retirement (as in _serve_loop)
            if not run.active:
                continue
            stats["peak_active"] = max(stats["peak_active"],
                                       len(run.active))
            cache, cur, retired = self._decode_and_retire(run, cache, cur)
            for slot in retired:
                free.append(slot)
                backend.retire(cache, slot)
                if not paged:
                    # park the freed stripe's write cursor back at smax
                    cache["length"][slot] = backend.smax
        stats["ttft_s"] = [ttft.get(i, float("nan"))
                           for i in range(len(prompts))]
        self.serve_stats = stats
        return run.outs


class _ServeRun:
    """What one serve() call carries through its scheduler loop: requests,
    budgets, outputs, the live slots and, on sampled calls, the sampling
    state and prefill steps."""

    def __init__(self, eng: ServeEngine, prompts, budgets, blens, chunk,
                 backend, sampling, mode, dmargin):
        self.prompts, self.budgets, self.blens = prompts, budgets, blens
        self.chunk, self.backend = chunk, backend
        self.sampling, self.mode, self.dmargin = sampling, mode, dmargin
        self.sampled = sampling is not None
        self.outs: List[List[int]] = [[] for _ in prompts]
        self.active: Dict[int, int] = {}             # slot -> request idx
        self.left: Dict[int, int] = {}               # request idx -> budget
        self.sstate = (smp.sampling_state(eng.max_batch, eng.vocab,
                                          eng.device)
                       if self.sampled else None)
        self._eng = eng
        self._prefills: Dict[str, Any] = {}

    def knobs(self, ridx: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """`pack_params` of request ``ridx`` on the device."""
        return smp.pack_params(self.sampling[ridx], self._eng.device)

    def knob_rows(self, ridxs: Sequence[int], rows: int = 1) -> tuple:
        """The prefill head's extra arguments for requests ``ridxs`` in
        ``rows`` rows: none when greedy, else (fvals, ivals)."""
        if not self.sampled:
            return ()
        return self._eng._knob_rows([self.sampling[i] for i in ridxs], rows)

    def prefill(self, kind: str):
        """The prefill step of ``kind`` (padded / packed / chunk): the
        engine's greedy steps, or the same steps with the first-token
        sampling head."""
        eng = self._eng
        if not self.sampled:
            return {"padded": eng._prefill, "packed": eng._packed_prefill,
                    "chunk": eng._prefill_continue}[kind]
        if kind not in self._prefills:
            maker = {"padded": make_prefill_step,
                     "packed": make_packed_prefill_step,
                     "chunk": make_chunk_prefill_step}[kind]
            use_tt = self.mode[0]
            self._prefills[kind] = eng._tp_step(
                maker, lambda c: first_sample_head(c, use_tt))
        return self._prefills[kind]


# ---------------------------------------------------------------------------
# serve() KV backends: how cache space is reserved and admissions scatter
# ---------------------------------------------------------------------------

def _paged_unsupported_reason(cfg: ModelConfig) -> str:
    """Why the paged scheduler cannot serve ``cfg`` (empty = it can). Its
    decode always runs the paged kernel, so it is offered only where the
    contiguous cache would decode through that kernel too — otherwise the
    two layouts would not give the same tokens. The answer is the same
    inside a TP shard (the reference's ``tp`` argument re-activates its
    kernels there; here a mesh never turns them off, and the GQA group is
    the same at local heads)."""
    if not dispatch.flash_backend_active(cfg):
        return (f"flash attention backend inactive (attn_impl="
                f"{cfg.attn_impl!r}, gemm_impl={cfg.gemm_impl!r}; needs "
                "attn_impl='flash', or 'auto' with gemm_impl='pallas')")
    g = cfg.num_heads // max(1, cfg.num_kv_heads)
    if not skinny_ok(g):
        return (f"GQA group size {g} exceeds the decode kernel's "
                f"resident-query limit (SKINNY_M_MAX={SKINNY_M_MAX})")
    return ""


class _ContiguousKvBackend:
    """Every slot owns an ``smax`` stripe of the shared cache; a
    reservation always succeeds (a free slot is the only resource)."""

    def __init__(self, eng: ServeEngine, smax: int):
        self.eng = eng
        self.smax = smax
        self.stats: Dict[str, Any] = {"peak_active": 0,
                                      "deferred_admissions": 0}

    def init_cache(self) -> Dict:
        eng = self.eng
        cache = registry.init_cache(eng._lcfg, eng.max_batch, self.smax,
                                    device=eng.device)
        cache["start"] = torch.zeros((eng.max_batch,), dtype=torch.int32,
                                     device=eng.device)
        return cache

    def reserve(self, ridx: int, blen: int, budget: int):
        return ()                                    # always grants

    def release(self, grant) -> None:
        pass

    def admit(self, cache: Dict, c1: Dict, slot: int, grant) -> None:
        """Copy a finished one-row prefill into ``slot``'s stripe."""
        for key in ("k", "v"):
            cache[key][:, slot] = c1[key][:, 0]
        cache["length"][slot] = c1["length"][0]
        cache["start"][slot] = c1["start"][0]

    def retire(self, cache: Dict, slot: int) -> None:
        pass                                         # the stripe just idles

    def starved(self, ridx: int, blens, budgets) -> None:
        raise AssertionError("contiguous reservations cannot defer")

    # -- packed-prefill addressing ----------------------------------------

    def pad_row(self) -> int:
        """Out-of-range scatter row of packed padding tokens (dropped)."""
        return self.eng.max_batch

    def token_addr(self, slot: int, grant, pos: np.ndarray):
        """(rows, cols) of the K/V scatter at absolute positions ``pos``:
        the slot's stripe, slot index = position."""
        return np.full(pos.shape, slot, np.int32), pos.astype(np.int32)

    def kv_sel(self, slot: int, grant):
        return slot

    def install(self, cache: Dict, slot: int, length: int, grant) -> None:
        """Activate a slot whose packed prefill finished: its K/V already
        sit in the stripe; install length and a zero start."""
        cache["length"][slot] = length
        cache["start"][slot] = 0


class _PagedKvBackend:
    """Requests reserve ``ceil((prompt + budget) / page)`` pages of a
    shared pool instead of an ``smax`` stripe. A reservation that does not
    fit is deferred until retirements free pages; retirement points the
    slot's table row at the dummy page, so the retired-but-still-stepping
    row's overshoot writes never touch recycled pages."""

    def __init__(self, eng: ServeEngine, smax: int):
        cfg = eng.cfg
        self.eng = eng
        self.smax = smax
        self.page = cfg.kv_page_size
        if self.page < PAGE_MIN:
            raise ValueError(f"kv_page_size={self.page} below the decode "
                             f"kernel's minimum page of {PAGE_MIN} slots")
        g = cfg.num_heads // max(1, cfg.num_kv_heads)
        if not paged_decode_ok(g, self.page, cfg.resolved_head_dim):
            raise ValueError(f"kv_page_size={self.page}: the decode block's "
                             "shared memory exceeds 227 KB — lower it")
        self.n_log = smax // self.page
        self.pool_pages = (eng.kv_pool_pages
                           or (eng.max_batch * self.n_log + 1))
        self.alloc = PageAllocator(self.pool_pages)
        self.slot_pages: Dict[int, List[int]] = {}   # slot -> phys pages
        self.stats: Dict[str, Any] = {
            "peak_active": 0, "deferred_admissions": 0,
            "pool_pages": self.pool_pages, "page": self.page,
            "n_log": self.n_log}

    def init_cache(self) -> Dict:
        eng = self.eng
        return init_paged_cache(eng._lcfg, eng.max_batch, self.pool_pages,
                                self.page, self.n_log, device=eng.device)

    def reserve(self, ridx: int, blen: int, budget: int):
        need = pages_needed(blen, budget, self.page)
        if need > self.pool_pages - 1:
            raise RuntimeError(
                f"request {ridx} needs {need} pages; the pool has "
                f"{self.pool_pages - 1} usable — raise kv_pool_pages")
        return self.alloc.alloc(need)                # None = defer

    def release(self, grant: List[int]) -> None:
        self.alloc.free(grant)

    def _table_row(self, grant: List[int]) -> torch.Tensor:
        row = np.full((self.n_log,), DUMMY_PAGE, np.int32)
        row[:len(grant)] = grant                     # tail -> dummy page
        return torch.as_tensor(row, device=self.eng.device)

    def admit(self, cache: Dict, c1: Dict, slot: int,
              grant: List[int]) -> None:
        """Scatter a finished one-row prefill into the granted pages (the
        row's tail pages land on the dummy) and install the table row."""
        row = self._table_row(grant)
        for key in ("k", "v"):
            one = c1[key][:, 0]                      # [L, smax, H, D]
            pool = cache[f"{key}_pages"]
            pool[:, row.long()] = one.reshape(
                one.shape[0], self.n_log, self.page, *one.shape[2:])
        cache["block_table"][slot] = row
        cache["length"][slot] = c1["length"][0]
        cache["start"][slot] = c1["start"][0]
        self.slot_pages[slot] = grant

    def retire(self, cache: Dict, slot: int) -> None:
        self.alloc.free(self.slot_pages.pop(slot))
        cache["block_table"][slot] = DUMMY_PAGE

    def starved(self, ridx: int, blens, budgets) -> None:
        raise RuntimeError(
            f"request {ridx} cannot be admitted: needs "
            f"{pages_needed(blens[ridx], budgets[ridx], self.page)} "
            f"pages, the pool has {self.alloc.free_pages} free")

    # -- packed-prefill addressing ----------------------------------------

    def pad_row(self) -> int:
        """Out-of-range scatter row of packed padding tokens: one past the
        pool (the dummy page 0 is a real page)."""
        return self.pool_pages

    def token_addr(self, slot: int, grant, pos: np.ndarray):
        """Physical (page, offset) of each absolute position through the
        granted pages: packed prefill writes the pool directly; the table
        learns of these pages only at install."""
        g = np.asarray(grant, np.int64)
        return (g[pos // self.page].astype(np.int32),
                (pos % self.page).astype(np.int32))

    def kv_sel(self, slot: int, grant):
        return self._table_row(grant)

    def install(self, cache: Dict, slot: int, length: int,
                grant: List[int]) -> None:
        """Activate a slot: until now its table row pointed at the dummy
        page, so decode never saw the half-prefilled pages."""
        cache["block_table"][slot] = self._table_row(grant)
        cache["length"][slot] = length
        cache["start"][slot] = 0
        self.slot_pages[slot] = grant
