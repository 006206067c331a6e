"""Serving driver: ``python -m repro_torch.launch.serve --arch <id> [...]``.

The port's counterpart of ``repro.launch.serve``, with its flags, names
and defaults. It builds seeded random weights one layer at a time
(`registry.init_params_by_layer`), optionally DBB-packed (``--packed``:
f32 values, or nibble-packed INT4 with ``--weight-bits 4``), prints the
route tables of the run's hot shapes (`dispatch.explain` on the H100's
roofline), and runs batched generation over synthetic prompts drawn as the
reference draws them. ``--requests N`` (N > batch) drives the
continuous-batching scheduler instead of one static batch;
``--attn-backend`` picks the attention implementation and
``--kv-page-size`` / ``--kv-pool-pages`` serve through the paged KV cache.

One flag is the port's own: ``--gemm-impl {xla,pallas}`` sets the config's
``gemm_impl`` (default: the config's own, ``"xla"`` for every full
config). It adds no behaviour — `ServeEngine` takes the field in both
packages — but without it the CLI could reach the hand-written kernels
only through a config that sets ``"pallas"``. ``--gemm-impl pallas``
runs them.

The prefill-attention table names the prefill the run dispatches: packed
at the first wave's token count when the run serves (``--requests`` >
``--batch``) with packed admission, else padded. (The reference logs the
packed table for ``generate`` runs too, whose prefill is padded.)

Runs on the card; ``main(argv, device="cpu")`` runs the plain PyTorch
versions, as the tests do. With no card and no ``device``, it fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.dbb import DbbWeight
from repro_torch.core.dbb_linear import iter_leaves, tree_footprint_bytes
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.serve.engine import ServeEngine

__all__ = ["main", "build_parser"]


def _log_routes(cfg, batch: int, smax: int, packed: bool,
                total_tokens: int = 0, sampling_on: bool = False,
                use_tt: bool = False) -> Dict[str, str]:
    """Print the ranked route tables for this run's hot shapes — the
    decode-batch layer GEMM, prefill attention (packed at
    ``total_tokens`` > 0, else padded at [batch, smax]), the sampled head
    when sampling is on — and the decode-attention route at cache length
    ``smax`` with the page `decode_attention_apply` derives. Returns the
    chosen route of each, by domain."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attn.ops import DEFAULT_PAGE
    from repro_torch.roofline.analysis import HW_H100

    d, ff = cfg.d_model, cfg.d_ff
    hd = cfg.resolved_head_dim
    hw = HW_H100
    chosen: Dict[str, str] = {}

    def table(domain, **kw):
        rows = dispatch.explain(domain, dtype=cfg.dtype, cfg=cfg, hw=hw, **kw)
        chosen[domain] = rows[0].name
        print(dispatch.format_table(rows))

    print(f"\nkernel routes (gemm_impl={cfg.gemm_impl!r}, "
          f"attn_impl={cfg.attn_impl!r}, overrides="
          f"{dict(cfg.kernel_routes) or 'none'}; costed on {hw.name}: "
          f"{hw.peak_flops / 1e12:g} TFLOP/s, {hw.hbm_bw / 1e12:g} TB/s):")
    w4 = packed and cfg.dbb.weight_bits == 4
    w4_kw = dict(bits=4, group=cfg.dbb.quant_group) if w4 else {}
    print(f"- decode layer GEMM [M={batch}, K={d}, N={ff}]"
          f"{' packed w4' if w4 else ' packed' if packed else ''}:")
    # the MLP GEMMs fuse one act / scale
    table("matmul", m=batch, k=d, n=ff, packed=packed, epilogue_ops=1,
          **w4_kw)
    if total_tokens > 0:
        print(f"- prefill attention [total_tokens={total_tokens}, "
              f"packed cu_seqlens]:")
        table("attention", m=total_tokens, k=hd, n=total_tokens,
              packed_seq=True)
    else:
        print(f"- prefill attention [B={batch}, T_max={smax}, padded]:")
        table("attention", m=smax, k=hd, n=smax, batch=batch)
    if sampling_on:
        print(f"- head sample [M={batch}, K={d}, N={cfg.vocab_size}]"
              f"{' (top-k/top-p active)' if use_tt else ''}:")
        table("head_sample", m=batch, k=d, n=cfg.vocab_size, sample_tt=use_tt)
    g = cfg.num_heads // max(1, cfg.num_kv_heads)
    page = cfg.kv_page_size or math.gcd(smax, DEFAULT_PAGE)
    route = dispatch.decode_attention_route(
        cfg, group=g, head_dim=hd, page=page, smax=smax,
        itemsize=getattr(torch, cfg.dtype).itemsize)
    chosen["attn_decode"] = route
    print(f"- decode attention (G={g}, smax={smax}, page={page}): "
          f"{route}\n")
    return chosen


def _dense_bytes(params, itemsize: int) -> int:
    """The tree's bytes with every packed leaf counted dense."""
    total = 0
    for leaf in iter_leaves(params):
        if isinstance(leaf, DbbWeight):
            lead = math.prod(leaf.values.shape[:-2])
            total += lead * leaf.k_dim * leaf.n_dim * itemsize
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--packed", action="store_true",
                    help="serve DBB-packed weights")
    ap.add_argument("--weight-bits", type=int, default=0,
                    choices=[0, 4, 8],
                    help="packed value-plane width (with --packed): 4 = "
                         "nibble-packed INT4 + groupwise scales; 8 = the "
                         "float plane; 0 = the arch config's "
                         "dbb.weight_bits")
    ap.add_argument("--quant-group", type=int, default=0,
                    help="w4 scale-group length G along K (0 = the arch "
                         "config's dbb.quant_group, default 128)")
    ap.add_argument("--gemm-impl", default=None, choices=["xla", "pallas"],
                    help="kernel route family: 'pallas' runs the "
                         "hand-written kernels, 'xla' plain torch (default: "
                         "the arch config's gemm_impl)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=0,
                    help="total request count; > batch engages the "
                         "continuous-batching scheduler (default: one "
                         "static batch)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attn-backend", default=None,
                    choices=["auto", "flash", "chunked", "naive"],
                    help="attention backend override; default: the arch "
                         "config's attn_impl")
    ap.add_argument("--kv-page-size", type=int, default=0,
                    help="KV page size in cache slots; > 0 serves through "
                         "the paged KV cache (block-table flash decode, "
                         "admission by pages used)")
    ap.add_argument("--kv-pool-pages", type=int, default=0,
                    help="physical page pool size (with --kv-page-size); "
                         "0 = contiguous-cache parity")
    ap.add_argument("--prefill-mode", default="packed",
                    choices=["packed", "padded"],
                    help="prompt admission: 'packed' concatenates the "
                         "ragged batch into one cu_seqlens prefill call; "
                         "'padded' prefills each row's rectangle")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: split prompts into chunks of "
                         "this many tokens so long prompts interleave "
                         "with decode steps; 0 = whole-prompt prefill "
                         "(packed mode only)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature for every request "
                         "(0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k truncation (0 = off; any truncation "
                         "sends the head to the plain sampler)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus truncation (1.0 = off)")
    ap.add_argument("--draft-k", type=int, default=0,
                    help="self-speculative decode: draft this many "
                         "tokens per step with the truncated-layer "
                         "model, verify in one batched step (0 = off; "
                         "incompatible with top-k/top-p)")
    return ap


def main(argv=None, *, device=None, report: Optional[dict] = None) -> int:
    """Run the CLI on ``argv``, on ``device`` (default ``"cuda"``).
    ``report``, when given, receives the run's config, tree, engine,
    prompts, streams, chosen routes and its build / footprint / wall
    figures."""
    args = build_parser().parse_args(argv)
    dev = resolve_device("cuda" if device is None else device)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.weight_bits or args.quant_group:
        dbb = cfg.dbb
        dbb = dataclasses.replace(
            dbb, weight_bits=args.weight_bits or dbb.weight_bits,
            quant_group=args.quant_group or dbb.quant_group)
        cfg = cfg.replace(dbb=dbb)
    if args.gemm_impl:
        cfg = cfg.replace(gemm_impl=args.gemm_impl)
    if args.attn_backend:
        cfg = cfg.replace(attn_impl=args.attn_backend)
    if args.kv_page_size:
        cfg = cfg.replace(kv_page_size=args.kv_page_size)
    elif args.kv_pool_pages and cfg.kv_page_size <= 0:
        raise SystemExit("--kv-pool-pages only takes effect with paged "
                         "serving (--kv-page-size, or a config that sets "
                         "kv_page_size); without it the contiguous cache "
                         "ignores the pool budget")
    if cfg.family != "dense_lm":
        raise SystemExit(f"{args.arch}: token-decoder serving only "
                         "(modality frontends are stubs)")
    packed = bool(args.packed and cfg.dbb.enabled)
    t0 = time.perf_counter()
    params = registry.init_params_by_layer(cfg, seed=args.seed, device=dev,
                                           pack=packed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    tree_bytes = tree_footprint_bytes(params)
    print(f"weights: {cfg.name}, {cfg.num_layers} layers, built layer by "
          f"layer in {build_s:.1f} s on {dev}")
    if packed:
        dense_bytes = _dense_bytes(
            params, getattr(torch, cfg.param_dtype).itemsize)
        print(f"weight footprint: dense {dense_bytes/1e6:.1f} MB -> packed "
              f"{tree_bytes/1e6:.1f} MB "
              f"({100*tree_bytes/dense_bytes:.1f}%)")

    rng = np.random.default_rng(args.seed)
    n_req = args.requests or args.batch
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size,
                                             size=args.prompt_len)]
               for _ in range(n_req)]
    sampled = (args.temperature > 0.0 or args.top_k > 0
               or args.top_p < 1.0 or args.draft_k > 0)
    sampling = None
    if sampled:
        from repro_torch.serve.sampling import SamplingParams
        sampling = [SamplingParams(temperature=args.temperature,
                                   top_k=args.top_k, top_p=args.top_p,
                                   seed=args.seed + i)
                    for i in range(n_req)]
    use_tt = args.top_k > 0 or args.top_p < 1.0
    serving = n_req > args.batch
    wave = sum(len(p) for p in prompts[:args.batch])
    routes = _log_routes(
        cfg, args.batch, args.prompt_len + args.max_new, packed=packed,
        total_tokens=wave if serving and args.prefill_mode == "packed"
        else 0, sampling_on=sampled, use_tt=use_tt)
    if sampled:
        print(f"sampling: temperature={args.temperature} "
              f"top_k={args.top_k} top_p={args.top_p} "
              f"seeds={args.seed}..{args.seed + n_req - 1} (per request); "
              f"speculative draft_k={args.draft_k}"
              + (" (draft = first num_layers//2 layers, rejection-"
                 "sampling verify)" if args.draft_k else " (off)"))
    eng = ServeEngine(cfg, params, max_batch=args.batch,
                      kv_pool_pages=args.kv_pool_pages,
                      prefill_mode=args.prefill_mode,
                      prefill_chunk=args.prefill_chunk,
                      draft_k=args.draft_k, device=dev)
    t0 = time.perf_counter()
    if serving:
        outs = eng.serve(prompts, max_new_tokens=args.max_new,
                         sampling=sampling)
    else:
        outs = eng.generate(prompts, max_new_tokens=args.max_new,
                            sampling=sampling)
    wall_s = time.perf_counter() - t0
    for i, o in enumerate(outs):
        print(f"req{i}: {o}")
    print(f"{'serve' if serving else 'generate'}: {n_req} requests, "
          f"{sum(len(o) for o in outs)} tokens in {wall_s:.2f} s on {dev}")
    if report is not None:
        report.update(cfg=cfg, params=params, engine=eng, prompts=prompts,
                      outs=outs, routes=routes, build_s=build_s,
                      tree_bytes=tree_bytes, wall_s=wall_s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
