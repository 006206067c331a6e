"""The vlm_lm and audio_lm families (paligemma-3b and musicgen-medium) in
the port against the JAX package, at smoke width in f32, on the weights of
tests/test_torch_fixtures.py (`dense_params` / `packed_params`: the
reference's init with seeded norms, the layers x 3, the embedding x 0.1),
with ``gemm_impl="pallas"`` (the reference's Pallas kernels in interpret
mode against the port's wrappers' plain versions) and "xla".

Both families are the dense block with another input: paligemma's 16
(smoke) image-patch ``prefix_embeds`` in front of its scaled token
embeddings (MQA: 4 query heads on one KV head), musicgen's frame
``embeds`` in place of its (unscaled) token embeddings.

* `forward` with ``prefix_embeds`` (vlm) or ``embeds`` (audio), on dense
  and packed trees, both routes; `prefill` from them and then
  `decode_step` from tokens and from ``embeds=`` (every cache leaf held);
* `ServeEngine.generate` greedy and sampled, `serve` packed into the
  contiguous cache, into the paged pool and in chunks, and ``draft_k=2``
  on musicgen: streams equal to the JAX engine's (no near-tie exclusion
  was needed at these seeds: the streams are compared whole);
* one training step each: the loss and every leaf's gradient against
  ``jax.grad`` of the reference's loss (paligemma's loss masked over its
  prefix; musicgen's embedding table, which its frame batches never read,
  a zero gradient in both);
* the serve CLI's refusal of both, in the reference's words;
* `param_count`: the reference's 15% check against the real tree for
  musicgen, and equal to the reference's on both configs.

Tolerance: hidden states and cache leaves within 1e-4 of max |value|;
losses rtol 1e-6, gradients within 1e-5 of each leaf's max |grad|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fixtures import configs, dense_params, packed_params
from test_torch_fixtures import prompts
from test_torch_zamba2 import _close
from repro.configs import get_config as jget
from repro.core.sparsity import apply_dbb_to_tree as japply
from repro.launch import serve as jserve
from repro.models import registry as jreg
from repro.serve import sampling as jsampling
from repro.serve.engine import ServeEngine as JEngine
from repro.train.loop import make_loss_fn as j_loss_fn
from repro_torch.config import ShapeSpec
from repro_torch.configs import get_config as tget
from repro_torch.data.pipeline import make_pipeline
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import registry as treg
from repro_torch.serve import sampling as tsampling
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.loop import loss_and_grads, make_loss_fn
from repro_torch.train.tree import tree_leaves

torch.set_num_threads(1)
VLM, AUDIO = "paligemma-3b", "musicgen-medium"
MODEL_TOL = 1e-4
SP_KW = [dict(temperature=0.8, seed=11),
         dict(temperature=1.2, seed=-5, repetition_penalty=1.3),
         dict(),
         dict(temperature=0.5, seed=7, presence_penalty=0.4,
              frequency_penalty=0.2)]
# musicgen's smoke vocabulary is 256
SERVE_PROMPTS = prompts([6, 11, 4, 9, 7, 13], seed=5, vocab=256)
SERVE_BUDGETS = [4, 8, 2, 6, 3, 5]
_TREES = {}


def _trees(arch, weights="packed"):
    key = (arch, weights)
    if key not in _TREES:
        if weights == "packed":
            _TREES[key] = packed_params(seed=2, arch=arch)
        else:
            _TREES[key] = dense_params(seed=2, arch=arch)
    return _TREES[key]


def _inputs(cfg, b, s, seed):
    """{tokens | embeds, prefix_embeds}: numpy, the batch a forward takes."""
    rng = np.random.default_rng(seed)
    if cfg.embeds_input:
        out = {"embeds": rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)}
    else:
        out = {"tokens": rng.integers(2, cfg.vocab_size, (b, s)).astype(
            np.int32)}
    if cfg.prefix_embed_len:
        out["prefix_embeds"] = rng.standard_normal(
            (b, cfg.prefix_embed_len, cfg.d_model)).astype(np.float32)
    return out


@pytest.mark.parametrize("weights,gemm_impl", [
    ("dense", "xla"), ("packed", "xla"), ("packed", "pallas")])
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_forward_matches_reference(arch, weights, gemm_impl):
    jcfg, tcfg = configs(gemm_impl, arch=arch)
    jp, tp = _trees(arch, weights)
    batch = _inputs(tcfg, 2, 9, 5)
    want, _ = jreg.forward(jp, jcfg, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    got, aux = treg.forward(tp, tcfg, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    assert float(aux) == 0.0
    assert got.shape == (2, 9 + tcfg.prefix_embed_len, tcfg.d_model)
    _close(got.numpy(), want, MODEL_TOL)


def _cache_close(tc, jc):
    assert set(tc) == set(jc)
    for k in jc:
        if k == "length":
            assert np.array_equal(tc[k].numpy(), np.asarray(jc[k]))
        else:
            _close(tc[k].numpy(), jc[k], MODEL_TOL)


@pytest.mark.parametrize("gemm_impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_prefill_and_decode_match_reference(arch, gemm_impl):
    """Prefill B2 from the family's inputs (12 tokens after paligemma's 16
    patches; 12 frames), a token decode step, then (musicgen) a step from
    ``embeds=``; hidden states and every cache leaf after each call."""
    jcfg, tcfg = configs(gemm_impl, arch=arch)
    jp, tp = _trees(arch)
    batch = _inputs(tcfg, 2, 12, 6)
    total = 12 + tcfg.prefix_embed_len
    kw = {k: v for k, v in batch.items() if k != "tokens"}
    jc = jreg.init_cache(jcfg, 2, total + 4)
    tc = treg.init_cache(tcfg, 2, total + 4, device="cpu")
    jh, jc = jreg.prefill(jp, jcfg, tokens=(
        jnp.asarray(batch["tokens"]) if "tokens" in batch else None),
        cache=jc, **{k: jnp.asarray(v) for k, v in kw.items()})
    th, tc = treg.prefill(tp, tcfg, (torch.from_numpy(batch["tokens"])
                                     if "tokens" in batch else None), tc,
                          **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert th.shape[1] == total
    _close(th.numpy(), jh, MODEL_TOL)
    _cache_close(tc, jc)
    nxt = np.array([7, 300 % tcfg.vocab_size], np.int32)
    jh, jc = jreg.decode_step(jp, jcfg, jnp.asarray(nxt), jc)
    th, tc = treg.decode_step(tp, tcfg, torch.from_numpy(nxt), tc)
    _close(th.numpy(), jh, MODEL_TOL)
    _cache_close(tc, jc)
    if tcfg.embeds_input:
        e = np.random.default_rng(9).standard_normal(
            (2, 1, tcfg.d_model)).astype(np.float32)
        jh, jc = jreg.decode_step(jp, jcfg, None, jc, embeds=jnp.asarray(e))
        th, tc = treg.decode_step(tp, tcfg, None, tc,
                                  embeds=torch.from_numpy(e))
        _close(th.numpy(), jh, MODEL_TOL)
        _cache_close(tc, jc)


def test_embeds_are_unscaled_and_tokens_scaled_for_vlm_only():
    """`_embed_inputs`: token embeddings times sqrt(d) for vlm_lm, not for
    audio_lm; frame and prefix embeddings as given."""
    from repro_torch.models.transformer import _embed_inputs
    for arch, scaled in ((VLM, True), (AUDIO, False)):
        _, tcfg = configs(arch=arch)
        _, tp = _trees(arch, "dense")
        toks = torch.tensor([[3, 4]])
        table = tp["embed"]["table"][toks]
        x = _embed_inputs(tp, tcfg, toks)
        factor = tcfg.d_model ** 0.5 if scaled else 1.0
        torch.testing.assert_close(x, table * factor)
        e = torch.randn(1, 2, tcfg.d_model)
        x = _embed_inputs(tp, tcfg, embeds=e, prefix_embeds=e)
        assert torch.equal(x, torch.cat([e, e], 1))


def _engines(arch, max_batch, **kw):
    jcfg, tcfg = configs(arch=arch)
    jp, tp = _trees(arch)
    return (JEngine(jcfg, jp, max_batch=max_batch, **kw),
            ServeEngine(tcfg, tp, max_batch=max_batch, device="cpu", **kw))


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_generate_equals_reference(arch, sampled):
    """Four ragged prompts (left-padded), 8 new tokens, greedy or sampled
    with per-request temperatures, seeds and penalties."""
    jeng, teng = _engines(arch, 4)
    ps = prompts([5, 12, 3, 9], seed=len(arch), vocab=256)
    jkw = dict(sampling=[jsampling.SamplingParams(**k) for k in SP_KW]) \
        if sampled else {}
    tkw = dict(sampling=[tsampling.SamplingParams(**k) for k in SP_KW]) \
        if sampled else {}
    want = jeng.generate(ps, max_new_tokens=8, **jkw)
    got = teng.generate(ps, max_new_tokens=8, **tkw)
    assert got == want
    assert len(set(map(tuple, got))) == len(got)


@pytest.mark.parametrize("arch,mode", [
    (arch, mode) for arch in (VLM, AUDIO)
    for mode in ("packed", "paged", "chunked")] + [(AUDIO, "draft_k")])
def test_serve_equals_reference(arch, mode):
    """Six requests through 3 slots: packed prefill into the contiguous
    cache, into the paged pool (8-slot pages), in 4-token chunks, and
    (musicgen) sampled with ``draft_k=2``; the streams and the serve
    counters (but the wall-clock ttft) equal the JAX engine's."""
    kw = dict(kv_page_size=8) if mode == "paged" else {}
    jcfg, tcfg = configs(arch=arch, **kw)
    jp, tp = _trees(arch)
    ekw = dict(prefill_chunk=4) if mode == "chunked" else {}
    jeng = JEngine(jcfg, jp, max_batch=3, **ekw)
    teng = ServeEngine(tcfg, tp, max_batch=3, device="cpu", **ekw)
    jkw = tkw = {}
    if mode == "draft_k":
        jkw = dict(sampling=[jsampling.SamplingParams(**k)
                             for k in (SP_KW * 2)[:6]], draft_k=2)
        tkw = dict(sampling=[tsampling.SamplingParams(**k)
                             for k in (SP_KW * 2)[:6]], draft_k=2)
    want = jeng.serve(SERVE_PROMPTS, max_new_tokens=SERVE_BUDGETS, **jkw)
    got = teng.serve(SERVE_PROMPTS, max_new_tokens=SERVE_BUDGETS, **tkw)
    assert got == want
    js, ts = dict(jeng.serve_stats), dict(teng.serve_stats)
    js.pop("ttft_s", None)
    ts.pop("ttft_s", None)
    assert ts == js


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_loss_and_gradients_match_jax_grad(arch):
    """S 16 tokens (paligemma: after its 16 masked prefix positions), B2,
    remat "none"."""
    jcfg, tcfg = configs("xla", arch=arch)
    jp, _ = dense_params(seed=2, arch=arch)
    p = jax.tree_util.tree_map(np.asarray, japply(
        jp, jcfg.dbb, nnz=4, straight_through=False))
    b = make_pipeline(tcfg, ShapeSpec("t", 16, 2, "train"),
                      seed=1).batch_at(0)
    if tcfg.prefix_embed_len:
        assert not b["loss_mask"][:, :tcfg.prefix_embed_len].any()
    (_, jm), jg = jax.value_and_grad(
        j_loss_fn(jcfg, project_dbb=False), has_aux=True)(
        p, {k: jnp.asarray(v) for k, v in b.items()})
    tg, tm = loss_and_grads(make_loss_fn(tcfg, project_dbb=False),
                            params_from_numpy(p),
                            {k: torch.from_numpy(v) for k, v in b.items()})
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-6)
    jleaves = jax.tree_util.tree_leaves(jg)
    tleaves = tree_leaves(tg)
    assert len(tleaves) == len(jleaves)
    for g, w in zip(tleaves, jleaves):
        if not np.abs(np.asarray(w)).max():   # musicgen's unread table
            assert arch == AUDIO and not g.any()
            continue
        _close(np.asarray(g), w, 1e-5)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_serve_cli_refuses_in_the_reference_words(arch):
    with pytest.raises(SystemExit) as want:
        jserve.main(["--arch", arch])
    with pytest.raises(SystemExit) as got:
        tserve.main(["--arch", arch], device="cpu")
    assert str(got.value) == str(want.value) == (
        f"{arch}: token-decoder serving only (modality frontends are "
        "stubs)")


def test_param_count_matches_analytic():
    """The reference's 15% check (tests/test_models.py) on musicgen's
    smoke tree in the port, and both configs' counts equal the
    reference's, full and smoke."""
    cfg = tget(AUDIO, smoke=True)
    real = sum(a.numel() for a in tree_leaves(
        treg.init_params(cfg, seed=0, device="cpu")))
    assert abs(real - cfg.param_count()) / real < 0.15
    for arch in (VLM, AUDIO):
        for smoke in (False, True):
            assert tget(arch, smoke).param_count() == \
                jget(arch, smoke).param_count()
