#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--out DIR]

Phases (any failure ends the run with a non-zero exit and no result line):

1. device   require CUDA; print the card's name and power limit.
2. build    compile every kernel of the serving path from ``src/repro_torch/csrc``
            (one nvcc per source, in parallel) and print the build seconds.
3. kernels  each kernel against its plain PyTorch version on the card at the
            serving path's shapes (the DBB kernels on each values plane: f32,
            INT8, w4), with the tolerance stated; kernel, plain and
            library times (medians of CUDA-event timings of single calls, L2
            flushed and the host's enqueue hidden before each) beside the least
            time the card could take (``bound_ms``). The six int8 branches
            (``*_s8``: INT8 x INT8 -> INT32) at olmo-1b's layer GEMMs (M8,
            M24, M512) and convnet's convs (B256), each with three epilogues
            (int32; f32 x_s·w_s + bias + act; int8 requantized): bit-equal
            after act none / relu, f32 within rtol 1e-6 and int8 off by at
            most 1 on at most 0.1% after silu (the count printed); the
            library time is torch._int_mm where its shape rules admit the
            operands, else "—" with the reason. The M512 calls of
            sta_gemm_s8 and dbb_gemm_s8 run on the int8 tensor-core body
            (csrc/tc_gemm_s8.cuh): each line also prints bf16
            torch.matmul at the same shape, the int32 output's time and
            the IMAD body's earlier time in brackets, and must count a
            ``_s8_tc`` launch per call. The M8 and M24 calls of
            sta_gemm_skinny_s8 and dbb_gemm_skinny_s8 run on the int8
            split-K body (csrc/split_k_s8.cuh): each line also prints
            bf16 torch.matmul at the shape, the int32 output's time and
            the row-chunk body's earlier time in brackets. The bf16
            branches of
            sta_gemm and dbb_gemm (all three planes) run on the tensor-core
            body: each of their M512 lines also prints the time of the
            plain-FMA body it replaced (PERF.md's kernel table before the
            redesign) and must count a ``_tc`` launch. So do the bf16 D 128
            calls of flash_prefill (generate's B8 T=S=64, a B1 T=S=512
            admission, a B1 T256 S1024 chunk) and flash_prefill_packed (T
            2048 over 8 segments) on their tensor-core body
            (csrc/flash_tc.cuh): each line prints the FMA body's earlier
            time in brackets and must count a ``flash_prefill_tc`` /
            ``flash_prefill_packed_tc`` launch. The float branches of
            dbb_gemm_skinny (M8 and M24, all three planes) run on the
            split-K body (csrc/split_k.cuh): each line prints the
            row-chunk body's earlier time in brackets and must count a
            ``dbb_gemm_skinny_split`` launch. The f32-x branches of
            dbb_gemm and
            dbb_gemm_skinny are also timed at convnet's classifier (fc
            4096 -> 10, DBB k2, bias: B256 on dbb_gemm's narrow split-K
            body, counting a ``dbb_gemm_narrow`` launch, and B1) beside
            their bound, ``torch.matmul`` on the decompressed weight (TF32
            off) and the earlier body's time, and checked (rtol 1e-4).
            sta_gemm_skinny's float body (all M <= 32 rows in one block)
            is timed at the f32 head (M8, M24; the row-chunk body's earlier
            time in brackets) and at a dense decode layer (M8 K8192 N2048
            bf16), beside ``torch.matmul``; paged_decode (a row's pages
            split across blocks) at S128 through the contiguous cache's
            identity table (the earlier body's time in brackets) and at
            serve's contexts (S640, lengths 256-639) through a shuffled
            pool, beside ``scaled_dot_product_attention``.
            conv_gemm_dbb's f32 and int8 calls at convnet's conv1 and conv2
            run its tensor-core body (csrc/conv_tc.cuh: TMA im2col boxes,
            the DBB planes decompressed in shared memory, 3xTF32 / s8
            wgmma): each line prints cuDNN's F.conv2d on the decompressed
            weight (f32, TF32 off; for the int8 lines bf16) and the FMA /
            IMAD body's earlier time in brackets, and must count a
            ``conv_gemm_dbb_tc`` / ``conv_gemm_dbb_s8_tc`` launch per call.
            conv_gemm's f32 and int8 calls at convnet's conv0 and lenet's
            conv1 (B256) run its small-C body (the filter and a tile's
            zero-halo window in shared memory, all N channels a block,
            TMA bulk stores) and at convnet's dense conv1 and conv2
            (matmul="sta", B256) the tensor-core body of conv_tc.cuh on the
            dense weight (3xTF32 / s8 wgmma; the f32 bound is three tf32
            products an f32 one at 495 TFLOP/s): each line prints cuDNN's
            F.conv2d (f32, TF32 off; bf16 for int8) and the body before it
            where it was timed, and must count a ``conv_gemm_small`` /
            ``conv_gemm_tc`` (``_s8_small`` / ``_s8_tc``) launch per call.
            head_sample_fused runs sta_gemm_skinny's float body
            (skinny_float.cuh) with a sampling epilogue: at M 1, 8, 24 and
            32 its line prints the greedy head's time and the row-chunk
            body's earlier time in brackets, and temperature 0 must equal
            the greedy head bit for bit.
4. slice    full-width olmo-1b from seeded random weights, DBB-projected and
            packed, served by ``ServeEngine.generate`` on 8 ragged prompts with
            the launch counts reset just before and read just after; every
            kernel of generate's path (the flash prefill among them) must
            have launched. The prefill's last-position logits are held
            against the plain-torch route on the same weights, and so are the
            greedy tokens (a split is excused only where the plain route's
            logits of the two tokens lie within twice the logit tolerance).
5. serve    the same weights through ``ServeEngine.serve``: 24 requests
            (prompts of 16-512 tokens, budgets 8-64) through 8 slots, three
            times on the kernel route — (a) packed prefill into the
            contiguous cache, (b) into the paged pool, (c) packed with
            256-token chunks — with the counts reset before and read after
            each; every kernel of each path must have launched, (a) and (b)
            must give equal streams, and (a) and (c) must each agree with
            the plain route's ``serve`` in the same mode under the same
            near-tie excuse.
6. sample   the serve phase's 24 requests sampled (``sampling=``) on olmo-1b
            weights whose embedding is scaled by SAMPLE_EMBED_SCALE and
            layers by SAMPLE_LAYER_GAIN (at the init scales the logits reach
            ~2000 and every depth ranks them alike, so a half-depth draft
            would always agree), against a greedy serve on the same weights:
            each request at a temperature set from the measured spread of
            this model's logits (so the noise decides tokens; two stay at
            temperature 0), penalties on some. The kernel route's prefill
            logits and the speculative verify head's logits (against the
            decode head's on the same context) must lie within
            SAMPLE_LOGIT_TOL of max |logit|, printed beside bf16's own
            effect. (a) packed, contiguous and (b) paged must give equal
            streams, and (a) must agree with the plain route's sampled serve
            (a split is excused only where the plain route's sampling scores
            of the two tokens, recomputed on the shared context, lie within
            twice that tolerance over the temperature); (c) ``draft_k=2`` on
            both caches must give equal streams, with an acceptance rate
            strictly between 0 and 1; (d) ``draft_k=2`` at temperature 0
            must agree with the greedy stream under the same near-tie
            excuse. ``head_sample_fused`` must launch exactly once per
            sampled decode step and per prefill call ((c) and (d): per
            prefill call only); the share of sampled tokens that differ from
            the greedy stream must be above zero.
7. cnn      the paper's CNN at full published width from seeded random
            weights and standard-normal NHWC images: convnet-dbb under
            matmul="dbb" (packed) at batch 256 and at batch 1, under
            matmul="sta" (dense) at batch 256, and lenet5-dbb under "dbb" at
            batch 256. Each run's launch counts must equal what the route
            table implies (convnet's conv1 and conv2 on conv_gemm_dbb's
            tensor-core body: ``conv_gemm_dbb_tc`` 2, or under "sta" on
            conv_gemm's: ``conv_gemm_tc`` 2; convnet's conv0 and lenet's
            conv1 on conv_gemm's small-C body: ``conv_gemm_small`` 1), and
            its logits must
            agree with the plain route
            (explicit im2col, plain matmul) within 1e-4 of max |logit| with
            equal classes (a row whose top-2 margin is under that tolerance
            is excused).
8. dense    full-width olmo-1b with unpacked weights under gemm_impl="pallas":
            ``generate`` on the slice's 8 prompts must launch sta_gemm (the
            prefill MLP), sta_gemm_skinny, flash_prefill and paged_decode and
            no DBB kernel, and its greedy tokens must agree with the plain
            route's under the slice's near-tie excuse.
9. quant    the slice's olmo-1b weights (seed 0, DBB-projected) packed as w4
            (``weight_bits=4``, G 128) and with INT8 values
            (``pack_tree(quantize=True)``): pack time and footprint beside
            ``weight_footprint_ratio``; w4 ``generate`` (the slice's 8
            prompts) and serve (a) (the serve phase's 24 requests), INT8
            ``generate``. Each run's layer GEMMs must all take the format's
            kernels (``dbb_gemm_w4`` / ``dbb_gemm_skinny_w4``, or the ``_i8``
            pair: 7 per layer per forward) and no other DBB kernel; prefill
            logits within the slice's tolerance of the plain route (the
            INT8 run also prints the plain route at f32 activations as a
            control) and greedy tokens under the same near-tie excuse.
10. tokens  smoke-width f32 engine: kernel route and plain route must produce
            equal greedy tokens, and equal sampled tokens.
11. int8    the paper's INT8 x INT8 -> INT32 datapath at full width: (a)
            int8 activations (per-tensor act_scale) through
            ``dispatch.matmul`` on all 112 layer GEMMs of olmo-1b (seed-0
            projected weights) at M8 and M512, on the dense INT8 weights
            (quantize_weight) and the INT8-valued packed tree
            (pack_tree(quantize=True)), three epilogues each (raw int32;
            f32 with x_s·w_s and a bias, silu on N 8192; int8 requantized
            with relu), each held against the plain route as in phase 3;
            (b) convnet-dbb's INT8 chain (quantize, conv with x_s·w_s fused,
            bias and relu to f32, max-pool, requantize, ..., classifier) at
            batch 256 and 1: logits and classes bit-equal to the plain
            route's (conv1 and conv2 on the conv's int8 tensor-core body,
            ``conv_gemm_dbb_s8_tc`` 2; conv0 on conv_gemm's small-C body,
            ``conv_gemm_s8_small`` 1); (c) all-127 operands through every
            int8 branch at K 1152-1224 equal the exact integer; (d) every
            run's launch counts exactly those the route table implies (one
            ``_s8`` counter per run, no float branch moving; the conv's
            ``_s8_tc`` beside it); every M512 sta_gemm_s8 /
            dbb_gemm_s8 launch ran the int8 tensor-core body:
            ``sta_gemm_s8_tc`` / ``dbb_gemm_s8_tc`` equal the branch's
            count (``s8 tc:`` lines; convnet's N 10 classifier stays on
            the IMAD body).
12. family  the rest of the dense_lm family at the published widths (runs
            after phase 10), each tree built one layer at a time
            (`registry.init_params_by_layer`: drawn from a seed per layer,
            DBB-projected, packed, copied into [L, ...] planes allocated
            once; its ``layer_hook`` here seeds norm scales, norm biases and
            QKV biases away from their init values) and served with
            ``gemm_impl="pallas"``: starcoder2-15b (20 of its 40 layers
            since the train phase joined: the cli phase runs all 40;
            LayerNorm, GQA G 12, QKV bias, GeLU MLP, 4096-token window):
            generate of 8 left-padded prompts of 64-15 tokens (32 new),
            generate of one 5120-token prompt (16 new; the window bites),
            serve of 8 requests including that one (packed prefill) on the
            contiguous cache and on the paged pool; qwen2.5-14b (24 of
            48 layers, as starcoder2's cut; RMSNorm, G 5, QKV bias, vocab
            152064): generate as
            above, a sampled generate (head_sample_fused at N 152064;
            temperatures from this model's logit spread, one row at 0) and
            a generate on 8 unpacked layers (sta_gemm); yi-34b (8 of its 60
            layers: depth is the only cut, the 60-layer f32 planes with the
            embedding and head leave no room for caches, and 8 keep the
            phase's time; G 7, K 7168): generate as above. Every generate is held against the plain route on the
            same tree as the slice's is (LOGIT_TOL and the split rule; the
            sampled one by the sample phase's score-gap rule at LOGIT_TOL);
            the two caches' serve streams must be equal and the long
            request's serve stream must agree with the plain route's
            generate of it under the split rule; every kernel of each path
            must launch (the sampled run: head_sample_fused exactly once a
            prefill and a decode step, sta_gemm_skinny never; the unpacked
            run no DBB kernel). Per model it prints the build seconds, the
            packed bytes, the peak device memory of the build and of the
            runs, decode ms per step, generated tokens per second and the
            model's seconds.
13. cli     the serve CLI (``repro_torch.launch.serve.main``) in process at
            full width and full depth, the counts reset before each call
            and read after it, each tree freed before the next: olmo-1b
            ``--packed`` serve of 24 requests (prompts of 128, 32 new);
            starcoder2-15b (40 layers) ``--packed`` generate; qwen2.5-14b
            (48 layers) ``--packed`` paged (page 64) sampled serve (T 0.8)
            of 16 requests; yi-34b (all 60 layers) ``--packed
            --weight-bits 4`` generate (prompts of 64, 16 new), its prefill
            logits held against the plain route on the same tree within
            LOGIT_TOL. Every kernel route its printed tables choose must
            have launched its kernel, and each run's path kernels too (the
            w4 run no other DBB plane's). Per run it prints the build
            seconds, the tree's bytes, the peak device memory and the wall
            time beside the card.
14. train   the paper's pipeline (after phase 13): (a) Table I on the card:
            lenet5-dbb and convnet-dbb at their published sizes, dense and
            DBB k 2 / 3 / 4 (apply_to conv), TRAIN_CNN_STEPS steps of
            ``launch.train.train_loop`` at the reference's Table I ratios
            (lr 3e-3, prune start and ramp a third of the steps each,
            batch 64); no kernel launch while training, finite and falling
            losses; held-out accuracy through ``make_eval_step`` (the
            plain route); every DBB model packed (f32 and INT8 planes) and
            run at batch 256 through ``cnn_apply(matmul="dbb")`` (the cnn
            phase's exact B256 launch counts) and the INT8 planes through
            phase 11's INT8 chain, classes equal to the plain route's
            outside near ties (the excused rows counted); the Table I rows
            printed. (b) olmo-1b at full width through
            ``repro_torch.launch.train.main`` (TRAIN_LM_ARGV, AdamW, the
            bound ramped 8 -> 4, checkpoints under build/train_ckpt): every
            leaf's first-step gradient finite and nonzero, zero kernel
            launches in training, the loss falling, per-step ms and peak
            memory printed; the last checkpoint dropped and the run resumed
            from the one before it, its losses within TRAIN_RESUME_RTOL of
            the straight run's. (c) the trained masters projected at k 4
            and packed as f32, INT8 and w4 planes: held-out CE through
            ``registry.forward`` on the kernel route per plane (the f32
            planes within TRAIN_CE_RTOL of the plain route); greedy
            generate of 8 held-out prompts against the plain route
            (TRAIN_LOGIT_TOL and the split rule); ``draft_k=2`` at
            temperature 0 and 1 on both caches, equal streams, the
            acceptance rate printed, temperature 0 against greedy under
            the split rule. Then the area model's Table II and Fig. 5 rows
            (CPU arithmetic).
15. moe     the moe_lm family at the published widths (after phase 14), each
            tree built one layer at a time with the family phase's noise
            hook, on w4 planes (G 128; the router and the dense residual
            MLP stay f32, as the reference's packing leaves them), served
            with ``gemm_impl="pallas"``; the MoE layers are decompressed
            layer by layer (the reference streams packed weights for
            dense_lm only), so the experts run on the dense kernels and no
            DBB kernel launches. arctic-480b (16 of 128 experts: the
            reference's fused-expert ceiling; 8 of 35 layers; top-2,
            dense residual 4864, G 7): layer 0's ``moe_apply`` on one h
            [8, 64, d] on both routes (equal top-k, outputs within
            MOE_LAYER_TOL of max |y|, no host sync on the plain route,
            both times); generate of 8 prompts of
            32 tokens (16 new) on both routes, a row left out of the
            comparison where its recorded routing (top-k or the kept pairs
            under capacity) differs between the routes in some layer (a
            flip, or a pair displaced past capacity by another row's flip),
            every top-k difference of a row not yet left out at a router
            near-tie (k-th and (k+1)-th gates within MOE_TIE_RTOL on one
            route; the count of near-tie rows printed), prefill logits of the rows left within LOGIT_TOL and
            their streams equal outside the split rule; ms a decode step and
            time to first token on each route; serve of 10 requests of
            17-128 tokens (packed prefill) on the contiguous cache and the
            paged pool, equal streams; the per-layer expand timed (layer
            0's gate expert stack and its whole `_unpack_layer`) beside the
            decode step. kimi-k2-1t-a32b (32 of 384 experts:
            above 16, so the batched expert products run, top-8 of 32; 4 of
            61 layers; D 112, so flash_prefill runs its FMA body; vocab
            163840): generate on both routes as above, and a sampled serve
            on the paged pool whose streams differ from the greedy serve's.
            Each run's launches equal exactly those its config implies:
            per MoE call (recorded: one per layer and forward pass) 3 GEMMs
            per expert at M = capacity (arctic) and the dense MLP's 3 at M
            = the call's tokens, each on the kernel the route table picks,
            the attention per layer and call, one head a call; the
            attention projections' dense weights take the plain matmul, as
            in the reference. Then the serve CLI on arctic-480b smoke
            (``--packed --gemm-impl pallas``, f32), its table routes
            against its launches (the packed decode-GEMM table's route held
            as its dense counterpart: the layers run expanded), and the
            kernels at the phase's new shapes, each against its plain
            version, beside their bounds and the library calls
            (``moe_shapes`` in the kernels line): the expert GEMMs,
            flash_prefill, flash_prefill_packed (a packed call of the
            serve lengths) and paged_decode at arctic's G 7 D 128 and
            kimi's G 8 D 112, and head_sample_fused at kimi's sampled
            decode head (M8 K7168 N163840 f32) under the kernel phase's
            near-tie and temperature-0 rules.

Every bf16 launch of sta_gemm, dbb_gemm and the two flash prefills on the
main paths of phases 4-6, 8, 9 and 12-14 must have run the tensor-core body:
``sta_gemm_tc`` equals ``sta_gemm``, ``dbb_gemm_tc`` equals the f32,
``_i8`` and ``_w4`` branches' sum, ``flash_prefill_tc`` equals
``flash_prefill`` and ``flash_prefill_packed_tc`` equals
``flash_prefill_packed`` on each of those runs (their activations are bf16,
D 128), or the run fails. Likewise every float dbb_gemm_skinny launch of
phases 4-9 and 12-15 must have run the split-K body
(``dbb_gemm_skinny_split`` equals the f32, ``_i8`` and ``_w4`` branches'
sum) and every f32-x dbb_gemm launch (the CNN classifier, N 10) the narrow
body (``dbb_gemm_narrow`` equals ``dbb_gemm`` on the CNN runs, 0 on the
LM runs).

The line before the last is the per-kernel JSON record (``launches``: the
sum over the main-path runs of phases 4-9, 11 (a)-(b) and 12-15;
``launches_by_path`` per run);
the last line is ``{"ok": true, "device": {...}}``. ``--out DIR`` also
writes the nvcc logs (``-Xptxas -v``), the full report and torch.profiler
tables of the slice's generate, of serve (a), of the sampled serve (a), of
the w4 serve (a), of the batch-256 convnet forward and of starcoder2-15b's
serve on the contiguous cache (device time by kernel, device busy share)
there.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))
try:
    from repro_torch.roofline.analysis import HW_H100
except ImportError:              # no package beside the script: main fails
    HW_H100 = None
else:
    HBM_BYTES_PER_S = HW_H100.hbm_bw      # H100 SXM memory rate
    BF16_OPS_PER_S = HW_H100.peak_flops   # H100 SXM dense bf16 tensor cores
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
TF32_OPS_PER_S = 495e12          # H100 SXM dense TF32 tensor-core rate
INT8_OPS_PER_S = 1979e12         # H100 SXM dense INT8 tensor-core rate
REPS = 20
SPIN_CYCLES = 10_000_000         # ~5 ms at the H100's clock: covers the host
LOGIT_TOL = 1e-3                 # of max |logit|, kernel vs plain full width
# the kernels each main-path run must launch
GENERATE_KERNELS = ("dbb_gemm", "dbb_gemm_skinny", "sta_gemm_skinny",
                    "paged_decode", "flash_prefill")
SERVE_KERNELS = ("flash_prefill_packed", "dbb_gemm", "dbb_gemm_skinny",
                 "sta_gemm_skinny", "paged_decode")
# sampled serve: the fused head replaces sta_gemm_skinny's greedy head;
# speculative serve: the fused head samples the prefills only, the draft and
# verify heads take sta_gemm_skinny (M 8 and 24) and the plain sampler
SAMPLE_KERNELS = ("flash_prefill_packed", "dbb_gemm", "dbb_gemm_skinny",
                  "paged_decode", "head_sample_fused")
SPEC_KERNELS = SERVE_KERNELS + ("head_sample_fused",)
DENSE_KERNELS = ("sta_gemm", "sta_gemm_skinny", "flash_prefill",
                 "paged_decode")
CNN_LOGIT_TOL = 1e-4             # of max |logit|, f32 kernel vs plain route
# per-call ms of the bodies that the redesigns replaced: the plain-FMA
# bodies of the bf16 branches (the GEMMs at M512; the flash prefills' D 128
# calls, keyed by the kernel phase's case), dbb_gemm_skinny's row-chunk
# body (keyed by M, K, N) and both DBB kernels' earlier f32-x bodies at
# convnet's classifier, from PERF.md's kernel table before each redesign
# (H100 80GB HBM3, 700 W); printed beside this run's times, never in the
# record
PLAIN_FMA_MS = {("dbb_gemm", 2048, 2048): 0.3940,
                ("dbb_gemm", 2048, 8192): 0.5752,
                ("dbb_gemm", 8192, 2048): 1.5526,
                ("dbb_gemm_i8", 2048, 2048): 0.4328,
                ("dbb_gemm_i8", 2048, 8192): 0.5769,
                ("dbb_gemm_i8", 8192, 2048): 1.6998,
                ("dbb_gemm_w4", 2048, 2048): 0.4604,
                ("dbb_gemm_w4", 2048, 8192): 0.6168,
                ("dbb_gemm_w4", 8192, 2048): 1.8168,
                ("sta_gemm", 2048, 8192): 0.5487,
                ("sta_gemm", 8192, 2048): 1.7507,
                ("flash_prefill", "generate"): 0.0662,
                ("flash_prefill", "admission"): 0.2374,
                ("flash_prefill", "chunk"): 0.3374,
                ("flash_prefill_packed", "packed"): 0.4483,
                ("dbb_gemm_skinny", 8, 2048, 2048): 0.0366,
                ("dbb_gemm_skinny", 8, 2048, 8192): 0.0710,
                ("dbb_gemm_skinny", 8, 8192, 2048): 0.1276,
                ("dbb_gemm_skinny", 24, 2048, 2048): 0.0429,
                ("dbb_gemm_skinny", 24, 2048, 8192): 0.1421,
                ("dbb_gemm_skinny", 24, 8192, 2048): 0.1459,
                ("dbb_gemm_skinny_i8", 8, 2048, 2048): 0.0386,
                ("dbb_gemm_skinny_i8", 8, 2048, 8192): 0.0663,
                ("dbb_gemm_skinny_i8", 8, 8192, 2048): 0.1317,
                ("dbb_gemm_skinny_i8", 24, 2048, 2048): 0.0427,
                ("dbb_gemm_skinny_i8", 24, 2048, 8192): 0.1434,
                ("dbb_gemm_skinny_i8", 24, 8192, 2048): 0.1470,
                ("dbb_gemm_skinny_w4", 8, 2048, 2048): 0.0405,
                ("dbb_gemm_skinny_w4", 8, 2048, 8192): 0.0704,
                ("dbb_gemm_skinny_w4", 8, 8192, 2048): 0.1379,
                ("dbb_gemm_skinny_w4", 24, 2048, 2048): 0.0449,
                ("dbb_gemm_skinny_w4", 24, 2048, 8192): 0.1531,
                ("dbb_gemm_skinny_w4", 24, 8192, 2048): 0.1556,
                ("dbb_gemm", "classifier"): 0.6516,
                ("dbb_gemm_skinny", "classifier"): 0.0239}
# per-call ms of the bodies that this redesign of sta_gemm_skinny's float
# branch (the row-chunk body, keyed by M of the f32 head) and of
# paged_decode (one block a row, keyed by the kernel phase's case) replaced
# (PERF.md's kernel table before the redesign, H100 80GB HBM3, 700 W);
# printed beside this run's times, never in the record
ROW_CHUNK_MS = {8: 0.2245, 24: 0.5092, ("paged_decode", "S128"): 0.0420}
# per-call ms of head_sample_fused's row-chunk body (skinny_tile.cuh's 8-row
# chunks, 128-column blocks) that the float body replaced, keyed by M
# (PERF.md's kernel table before the redesign, H100 80GB HBM3, 700 W; M32
# was not timed there); printed beside this run's times, never in the
# record
ROW_CHUNK_SAMPLE_MS = {8: 0.2151, 1: 0.1600, 24: 0.4874}
# per-call ms of the IMAD body that the int8 tensor-core body replaced at
# the M512 layer GEMMs (f32 epilogue; PERF.md's kernel table before the
# redesign, H100 80GB HBM3, 700 W), keyed by (branch, K, N); printed beside
# this run's times, never in the record
IMAD_S8_MS = {("sta_gemm_s8", 2048, 2048): 0.4690,
              ("sta_gemm_s8", 2048, 8192): 0.7267,
              ("sta_gemm_s8", 8192, 2048): 1.8409,
              ("dbb_gemm_s8", 2048, 2048): 0.4439,
              ("dbb_gemm_s8", 2048, 8192): 0.7209,
              ("dbb_gemm_s8", 8192, 2048): 1.7399}
# per-call ms of the row-chunk bodies that the int8 split-K body
# (csrc/split_k_s8.cuh) replaced in the skinny kernels' int8 branches (f32
# epilogue; PERF.md's kernel table before the redesign, H100 80GB HBM3,
# 700 W), keyed by (branch, M, K, N); printed beside this run's times,
# never in the record
ROW_CHUNK_S8_MS = {("sta_gemm_skinny_s8", 8, 2048, 2048): 0.0697,
                   ("sta_gemm_skinny_s8", 8, 2048, 8192): 0.0739,
                   ("sta_gemm_skinny_s8", 8, 8192, 2048): 0.2734,
                   ("sta_gemm_skinny_s8", 24, 2048, 2048): 0.0681,
                   ("sta_gemm_skinny_s8", 24, 2048, 8192): 0.1166,
                   ("sta_gemm_skinny_s8", 24, 8192, 2048): 0.2660,
                   ("dbb_gemm_skinny_s8", 8, 2048, 2048): 0.0387,
                   ("dbb_gemm_skinny_s8", 8, 2048, 8192): 0.0672,
                   ("dbb_gemm_skinny_s8", 8, 8192, 2048): 0.1359,
                   ("dbb_gemm_skinny_s8", 24, 2048, 2048): 0.0447,
                   ("dbb_gemm_skinny_s8", 24, 2048, 8192): 0.1439,
                   ("dbb_gemm_skinny_s8", 24, 8192, 2048): 0.1518}
# per-call ms of the FMA (f32) and IMAD (int8) bodies that conv_gemm_dbb's
# tensor-core body (csrc/conv_tc.cuh) replaced at convnet's conv1 and conv2
# (B256; the int8 lines with the f32 epilogue; PERF.md's kernel table
# before the redesign, H100 80GB HBM3, 700 W), keyed by (branch, layer);
# printed beside this run's times, never in the record
# per-call ms of the FMA (f32) and IMAD (int8) bodies that conv_gemm's
# small-C body replaced at convnet's conv0 (B256; the int8 one with the f32
# epilogue; PERF.md's kernel table before the redesign, H100 80GB HBM3,
# 700 W); printed beside this run's times, never in the record
FMA_CONV0_MS, IMAD_CONV0_S8_MS = 0.0971, 0.1198
FMA_CONV_MS = {("conv_gemm_dbb", 1): 0.3475, ("conv_gemm_dbb", 2): 0.3460,
               ("conv_gemm_dbb_s8", 1): 0.4146,
               ("conv_gemm_dbb_s8", 2): 0.4328}
# the launch counter of the redesigned body each DBB kernel's float calls
# in the kernel phase must take, and its name beside the earlier body's
REDESIGN = {"dbb_gemm": ("dbb_gemm_tc", "tensor-core body, plain-FMA body"),
            "dbb_gemm_skinny": ("dbb_gemm_skinny_split",
                                "split-K body, row-chunk body")}
# the sample phase's weights: olmo-1b's init with the embedding scaled by
# SAMPLE_EMBED_SCALE and every layer weight by SAMPLE_LAYER_GAIN before
# packing, so that the logits are O(100), not O(2000), and the layers move
# them with depth (a half-depth draft then disagrees with the full model)
SAMPLE_EMBED_SCALE, SAMPLE_LAYER_GAIN = 0.1, 2.0
# per-request temperatures, in units of the spread (standard deviation over
# the vocabulary) of this model's logits at the prompts' last positions:
# the top token stands ~30 spreads above the rest on these weights, so
# below ~3 spreads the noise never moves it
SAMPLE_T_SPREAD = (3.0, 4.0, 6.0)
# of max |logit| on the sample phase's weights: kernel route vs plain route
# prefill logits, and the speculative verify head vs the decode head on the
# same context; each reading is printed beside bf16's own effect (the plain
# route at bf16 vs f32 activations)
SAMPLE_LOGIT_TOL = 5e-3


def _ptxas_report(build) -> None:
    """Registers, shared memory and spills of every kernel entry, from
    the ``-Xptxas -v`` logs the build leaves beside each library."""
    import re
    demangle = shutil.which("c++filt")
    for log in sorted(build.BUILD_DIR.glob("*.log")):
        entry, spill = None, ""
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
                if demangle:
                    entry = subprocess.run(
                        [demangle, entry], capture_output=True,
                        text=True).stdout.strip()
                    entry = entry.replace("(anonymous namespace)::", "")
                    entry = entry.removeprefix("void ").split("(")[0]
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spill = f"spill {m.group(1)}/{m.group(2)} B"
            # static shared memory only: a body on dynamic shared memory
            # (tc_gemm.cuh) reports none
            m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?",
                          line)
            if m and entry:
                print(f"ptxas {log.name.split('-')[0][3:]}: {entry}: "
                      f"{m.group(1)} registers, {m.group(2) or 0} B static "
                      f"smem, {spill}")
                entry = None


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def _bound_ms(nbytes: float, ops: float, ops_rate: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="also write logs and the "
                    "report into this directory")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is False")
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        return _fail(f"the port's package is missing ({e})")
    if HW_H100 is None:
        return _fail("the port's package is missing (repro_torch.roofline)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(card)                           # name, power limit as nvidia-smi
    print(f"device: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    secs = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})")
    _ptxas_report(build)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        for f in build.BUILD_DIR.glob("*.log"):
            shutil.copy(f, os.path.join(args.out, f.name))

    report = {"card": card, "phase_s": {}}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(torch, dev, report, *a)
        report["phase_s"][name] = time.perf_counter() - t
        print(f"phase {name}: {report['phase_s'][name]:.1f} s")
        return out

    kernels = timed("kernels", _kernel_phase)
    counts, packed, ok = timed("slice", _slice_phase, args.out)
    if not ok:
        return _fail("the slice phase failed (see above)")
    by_path = {"generate": counts}
    serve_counts, ok = timed("serve", _serve_phase, packed, args.out)
    if not ok:
        return _fail("the serve phase failed (see above)")
    by_path.update(serve_counts)
    del packed
    sample_counts, ok = timed("sample", _sample_phase, args.out)
    if not ok:
        return _fail("the sample phase failed (see above)")
    by_path.update(sample_counts)
    cnn_counts, ok = timed("cnn", _cnn_phase, args.out)
    if not ok:
        return _fail("the cnn phase failed (see above)")
    by_path.update(cnn_counts)
    dense_counts, ok = timed("dense", _dense_phase)
    if not ok:
        return _fail("the dense-weights phase failed (see above)")
    by_path["dense_generate"] = dense_counts
    quant_counts, ok = timed("quant", _quant_phase, args.out)
    if not ok:
        return _fail("the w4 / INT8 weights phase failed (see above)")
    by_path.update(quant_counts)
    if not timed("tokens", _token_phase):
        return _fail("smoke-width token equality failed")
    family_counts, ok = timed("family", _family_phase, args.out)
    if not ok:
        return _fail("the dense_lm family phase failed (see above)")
    by_path.update(family_counts)
    cli_counts, ok = timed("cli", _cli_phase)
    if not ok:
        return _fail("the serve CLI phase failed (see above)")
    by_path.update(cli_counts)
    train_counts, train_cnn, ok = timed("train", _train_phase)
    if not ok:
        return _fail("the training phase failed (see above)")
    by_path.update(train_counts)
    moe_counts, ok = timed("moe", _moe_phase, args.out)
    if not ok:
        return _fail("the moe_lm family phase failed (see above)")
    by_path.update(moe_counts)
    cnn_paths = list(cnn_counts) + train_cnn
    # the moe paths check their tensor-core counts themselves (kimi's D 112
    # prefill runs the FMA body; the CLI run's smoke config is f32)
    lm = [p for p in by_path
          if p not in cnn_paths and not p.startswith("moe_")]
    if not _tc_check(by_path, lm):
        return _fail("a bf16 sta_gemm / dbb_gemm / flash prefill launch on "
                     "a main path missed the tensor-core body (see above)")
    if not _split_check(by_path, cnn_paths):
        return _fail("a float dbb_gemm_skinny or f32-x dbb_gemm launch on a "
                     "main path missed its split-K body (see above)")
    int8_counts, ok = timed("int8", _int8_phase)
    if not ok:
        return _fail("the INT8 datapath phase failed (see above)")
    by_path.update(int8_counts)
    for entry in kernels:
        name = entry["name"]
        moe = {k: v for k, v in report["moe"]["kernels"].items()
               if k.startswith(name + " ")}
        if moe:
            entry["moe_shapes"] = moe
        entry["launches"] = sum(c[name] for c in by_path.values())
        entry["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
    if args.out:
        with open(os.path.join(args.out, "chip_smoke_report.json"), "w") as f:
            json.dump(dict(report, kernels=kernels), f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _tc_check(by_path, paths) -> bool:
    """Every bf16 launch of sta_gemm, dbb_gemm and the two flash prefills on
    these runs went through the tensor-core bodies: the ``_tc`` counts
    equal the branches' counts."""
    ok = True
    for path in paths:
        c = by_path[path]
        dbb = c["dbb_gemm"] + c["dbb_gemm_i8"] + c["dbb_gemm_w4"]
        good = (c["sta_gemm_tc"] == c["sta_gemm"]
                and c["dbb_gemm_tc"] == dbb
                and c["flash_prefill_tc"] == c["flash_prefill"]
                and c["flash_prefill_packed_tc"] == c["flash_prefill_packed"])
        ok = ok and good
        print(f"tc: {path}: sta_gemm_tc {c['sta_gemm_tc']} of sta_gemm "
              f"{c['sta_gemm']}, dbb_gemm_tc {c['dbb_gemm_tc']} of dbb_gemm "
              f"(f32 + _i8 + _w4) {dbb}, flash_prefill_tc "
              f"{c['flash_prefill_tc']} of {c['flash_prefill']}, "
              f"flash_prefill_packed_tc {c['flash_prefill_packed_tc']} of "
              f"{c['flash_prefill_packed']} {'ok' if good else 'FAIL'}")
    return ok


def _split_check(by_path, cnn_paths) -> bool:
    """Every float dbb_gemm_skinny launch on these runs went through the
    split-K body, and every f32-x dbb_gemm launch (the CNN runs' N 10
    classifier; the LM runs' dbb_gemm launches are bf16) through the
    narrow body: the new counts equal the branches' counts."""
    ok = True
    for path, c in by_path.items():
        skinny = (c["dbb_gemm_skinny"] + c["dbb_gemm_skinny_i8"]
                  + c["dbb_gemm_skinny_w4"])
        narrow = c["dbb_gemm"] if path in cnn_paths else 0
        good = (c["dbb_gemm_skinny_split"] == skinny
                and c["dbb_gemm_narrow"] == narrow)
        ok = ok and good
        print(f"split: {path}: dbb_gemm_skinny_split "
              f"{c['dbb_gemm_skinny_split']} of dbb_gemm_skinny (f32 + _i8 "
              f"+ _w4) {skinny}, dbb_gemm_narrow {c['dbb_gemm_narrow']} of "
              f"f32-x dbb_gemm {narrow} {'ok' if good else 'FAIL'}")
    return ok


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------

def _time_ms(torch, fn, flush) -> float:
    """Median over REPS of one call between CUDA events. Before each call
    the L2 is flushed and the stream is held in a spin kernel long enough
    for the host to enqueue the events and the call, so the interval is
    device time only, not the host's launch cost."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _close(torch, got, want, rtol: float, atol: float = 0.0):
    """(max abs error, passes): |got - want| <= rtol*|want| + a*max|want|
    elementwise, in f32, with a = atol or else rtol / 10."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = want.abs().max().item()
    a = atol or rtol * 0.1
    ok = bool((err <= rtol * want.abs() + a * scale).all())
    return err.max().item(), ok


def _kernel_phase(torch, dev, report):
    import torch.nn.functional as F

    from repro_torch.kernels.attn.ops import paged_decode_attention
    from repro_torch.kernels.attn.ref import gather_pages, paged_decode_ref
    from repro_torch.kernels.dbb_gemm.ops import dbb_gemm
    from repro_torch.kernels.skinny.ops import dbb_gemm_skinny, sta_gemm_skinny
    from repro_torch.kernels.skinny.ref import sta_gemm_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    bf16 = torch.bfloat16
    failures = []
    kernels = []

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # one layer of the main path: (K, N, calls per layer); the skinny
    # kernels also at M24, the speculative verify pass (8 slots x 3). Each
    # values plane of the two DBB kernels is its own entry: f32 (the
    # bits=8 float format), int8 (pack_tree(quantize=True)) and w4 (G 128)
    for name, src, replaces, ms_, fn in (
            ("dbb_gemm", "src/repro_torch/csrc/dbb_gemm.cu",
             "src/repro/kernels/dbb_gemm/kernel.py:114", (512,), dbb_gemm),
            ("dbb_gemm_skinny", "src/repro_torch/csrc/dbb_gemm_skinny.cu",
             "src/repro/kernels/skinny/kernel.py:167", (8, 24),
             dbb_gemm_skinny)):
        for plane in ("", "_i8", "_w4"):
            kernels.append(_dbb_entry(torch, randn, flush, failures,
                                      name + plane, src, replaces, ms_, fn,
                                      plane))
    for entry in kernels:
        if entry["name"] in CLASSIFIER_M:
            row = _classifier_row(torch, randn, flush, failures,
                                  entry["name"])
            entry["classifier"] = row
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       row["max_abs_err"])

    # head GEMV: x [M, 2048] f32 . w [2048, 50304] f32 at M8 (decode, the
    # entry) and M24 (the speculative verify head); and one dense decode
    # layer GEMM (the down projection, K8192 N2048) at M8 in bf16, the
    # dense phase's activations
    w = randn(2048, 50304) * 0.02
    heads = {}
    for m, k, n, dt in ((8, 2048, 50304, torch.float32),
                        (24, 2048, 50304, torch.float32),
                        ("dense", 8192, 2048, bf16)):
        rows = 8 if m == "dense" else m
        wk = w if n == 50304 else randn(k, n, dtype=dt) * 0.02
        x = randn(rows, k, dtype=dt)
        got, want = sta_gemm_skinny(x, wk), sta_gemm_ref(x, wk)
        tol = 1e-4 if dt == torch.float32 else 2e-2
        err, ok = _close(torch, got, want, tol)
        label = f"M{rows} K{k} N{n} {str(dt)[6:]}"
        if not ok:
            failures.append(f"sta_gemm_skinny {label}: max err {err}")
        ms = _time_ms(torch, lambda: sta_gemm_skinny(x, wk), flush)
        pms = _time_ms(torch, lambda: sta_gemm_ref(x, wk), flush)
        lms = _time_ms(torch, lambda: torch.matmul(x, wk), flush)
        esz = x.element_size()
        bms, by = _bound_ms((x.numel() + wk.numel() + rows * n) * esz,
                            2.0 * rows * k * n,
                            F32_OPS_PER_S if esz == 4 else BF16_OPS_PER_S)
        before = ROW_CHUNK_MS.get(m)
        print(f"kernel sta_gemm_skinny {label}: max abs err {err:.3e} (tol "
              f"{tol:g} rel) {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms"
              + (f" [row-chunk body {before:.4f}]" if before else "")
              + f", plain {pms:.4f} ms, torch.matmul {lms:.4f} ms, bound "
              f"{bms:.4f} ms ({by})")
        heads[m] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                        bound_by=by, library_ms=lms)
    del w
    kernels.append(dict(
        name="sta_gemm_skinny", route="cuda",
        source="src/repro_torch/csrc/sta_gemm_skinny.cu",
        replaces="src/repro/kernels/skinny/kernel.py:77", launches=0,
        shapes="M8 K2048 N50304 f32 (the head)", **dict(
            heads[8], max_abs_err=max(h["max_abs_err"]
                                      for h in heads.values())),
        m24=dict(heads[24], shapes="M24 K2048 N50304 f32 (the speculative "
                 "verify head)"),
        dense=dict(heads["dense"], shapes="M8 K8192 N2048 bf16 (a dense "
                   "decode layer's down projection)")))

    # paged decode: B 8, Hkv 16, G 1, D 128, page 64, bf16; S128 through the
    # contiguous cache's identity table (generate's shape), and serve's
    # contexts (lengths 256-639, S 640) through a shuffled pool
    b, hkv, g, d, page = 8, 16, 1, 128, 64
    scale = 1.0 / d ** 0.5
    cases = {}
    for case, s in (("S128", 128), ("S640", 640)):
        n_log = s // page
        q = randn(b, hkv, g, d, dtype=bf16)
        kc = randn(b, s, hkv, d, dtype=bf16)
        vc = randn(b, s, hkv, d, dtype=bf16)
        if case == "S128":
            kp = kc.view(b * n_log, page, hkv, d)
            vp = vc.view(b * n_log, page, hkv, d)
            table = (torch.arange(b, dtype=torch.int32, device=dev)[:, None]
                     * n_log + torch.arange(n_log, dtype=torch.int32,
                                            device=dev)[None, :])
            start = torch.tensor([0, 7, 14, 21, 28, 35, 42, 49],
                                 dtype=torch.int32, device=dev)
            lengths = torch.full((b,), 100, dtype=torch.int32, device=dev)
            label = "S128 identity table, ragged start"
        else:
            perm = torch.randperm(b * n_log, generator=gen, device=dev)
            kp = torch.empty_like(kc).view(b * n_log, page, hkv, d)
            vp = torch.empty_like(kp)
            kp[perm] = kc.view(b * n_log, page, hkv, d)
            vp[perm] = vc.view(b * n_log, page, hkv, d)
            table = perm.view(b, n_log).int().contiguous()
            lengths = torch.randint(256, s, (b,), generator=gen, device=dev,
                                    dtype=torch.int32)
            start = torch.randint(0, 64, (b,), generator=gen, device=dev,
                                  dtype=torch.int32)
            label = "S640 shuffled pool, lengths 256-639, ragged start"

        def run_kernel():
            return paged_decode_attention(q, kp, vp, table, lengths, start)

        def run_plain():
            return paged_decode_ref(q, kp, vp, table, lengths, start,
                                    sm_scale=scale)
        got, want = run_kernel(), run_plain()
        err, ok = _close(torch, got, want, 2e-2)
        if not ok:
            failures.append(f"paged_decode {case}: max err {err}")
        kk = torch.arange(s, device=dev)
        mask = ((kk[None, :] <= lengths[:, None])
                & (kk[None, :] >= start[:, None]))
        kg = gather_pages(kp, table).transpose(1, 2)
        vg = gather_pages(vp, table).transpose(1, 2)
        qs = q.reshape(b, hkv * g, 1, d)
        am = mask[:, None, None, :]
        ms = _time_ms(torch, run_kernel, flush)
        pms = _time_ms(torch, run_plain, flush)
        lms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=am), flush)
        valid = int(mask.sum().item())
        bms, by = _bound_ms(q.numel() * 2 * 2 + valid * hkv * d * 2 * 2,
                            4.0 * valid * hkv * g * d, BF16_OPS_PER_S)
        before = ROW_CHUNK_MS.get(("paged_decode", case))
        print(f"kernel paged_decode B{b} Hkv{hkv} G{g} D{d} page{page} "
              f"{label}: max abs err {err:.3e} (tol 2e-2 rel, bf16) "
              f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms"
              + (f" [one block a row {before:.4f}]" if before else "")
              + f", plain {pms:.4f} ms, scaled_dot_product_attention "
              f"{lms:.4f} ms, bound {bms:.4f} ms ({by})")
        cases[case] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                           bound_ms=bms, bound_by=by, library_ms=lms)
    kernels.append(dict(
        name="paged_decode", route="cuda",
        source="src/repro_torch/csrc/paged_decode.cu",
        replaces="src/repro/kernels/attn/kernel.py:372", launches=0,
        shapes="B8 Hkv16 G1 D128 S128 page64 bf16", **dict(
            cases["S128"], max_abs_err=max(c["max_abs_err"]
                                           for c in cases.values())),
        long=dict(cases["S640"], shapes="B8 Hkv16 G1 D128 page64 bf16, "
                  "lengths 256-639 through a shuffled pool")))
    kernels += _prefill_attention_kernels(torch, dev, randn, flush,
                                          failures)
    kernels += _gemm_conv_kernels(torch, dev, randn, flush, failures)
    kernels.append(_head_sample_kernel(torch, dev, flush, failures))
    kernels += _s8_kernels(torch, dev, flush, failures)
    report["kernel_failures"] = failures
    if failures:
        raise SystemExit(_fail("kernel disagrees with its plain version: "
                               + "; ".join(failures)))
    return kernels


# one layer of the serving path's packed GEMMs: (K, N, calls per layer)
LAYER_SHAPES = ((2048, 2048, 4), (2048, 8192, 2), (8192, 2048, 1))
W4_GROUP = 128


def _dbb_planes(torch, w, plane):
    """The DBB planes of ``w [K, N]`` in one values format, as the serving
    path stores them: (positional operands after x, keyword operands, the
    dequantized bf16 weight for the library yardstick, stored bytes)."""
    from repro_torch.core.dbb import decompress_bitmask, pack_dbb
    from repro_torch.core.quant import quantize_weight
    from repro_torch.kernels.dbb_gemm.ref import decompress_w4_ref
    bf16 = torch.bfloat16
    if plane == "_w4":
        p = pack_dbb(w, 8, 4, bits=4, group=W4_GROUP)
        kw = dict(bits=4, group=W4_GROUP, gscale=p.scale)
        dense = decompress_w4_ref(p.values, p.bitmask, p.scale,
                                  group=W4_GROUP)
        return ((p.values, p.bitmask), kw, dense.to(bf16),
                p.values.numel() + p.bitmask.numel() * 4
                + p.scale.numel() * 4)
    if plane == "_i8":
        qw = quantize_weight(w)
        p = pack_dbb(qw.q, 8, 4)
        dense = decompress_bitmask(p.values, p.bitmask, block=8) * qw.scale
        return ((p.values, p.bitmask, None, qw.scale), {}, dense.to(bf16),
                p.values.numel() + p.bitmask.numel() * 4
                + qw.scale.numel() * 4)
    p = pack_dbb(w, 8, 4)
    dense = decompress_bitmask(p.values, p.bitmask, block=8)
    return ((p.values, p.bitmask), {}, dense.to(bf16),
            p.values.numel() * 4 + p.bitmask.numel() * 4)


def _dbb_entry(torch, randn, flush, failures, name, src, replaces, ms_, fn,
               plane):
    """One DBB kernel branch over one layer's GEMMs (LAYER_SHAPES) at each
    M of ``ms_``, bf16 activations: checked against its plain version
    (rtol 2e-2, one bf16 rounding step: the weights are the same bits on
    both), timed beside the plain version and ``torch.matmul`` on the
    dequantized weight; the bound counts the stored planes and the live
    weights' operations."""
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.dbb_gemm.ref import dbb_gemm_ref
    bf16 = torch.bfloat16
    per_m = {}
    for m in ms_:
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
        worst, t_bytes, t_ops = 0.0, 0.0, 0.0
        for k_dim, n, calls in LAYER_SHAPES:
            x = randn(m, k_dim, dtype=bf16)
            args, kw, w_dense, stored = _dbb_planes(torch, randn(k_dim, n),
                                                    plane)
            act = "silu" if n == 8192 else "none"
            counter, body = REDESIGN[name.removesuffix(plane)]
            body_before = LAUNCHES[counter]
            got = fn(x, *args, act=act, **kw)
            want = dbb_gemm_ref(x, *args, act=act, **kw)
            err, ok = _close(torch, got, want, 2e-2)
            if not ok:
                failures.append(f"{name} M{m} K{k_dim} N{n}: max err {err}")
            earlier = (PLAIN_FMA_MS.get((name, k_dim, n))
                       or PLAIN_FMA_MS.get((name, m, k_dim, n)))
            if LAUNCHES[counter] != body_before + 1:
                failures.append(f"{name} M{m} K{k_dim} N{n}: no {counter} "
                                "launch")
            ms = _time_ms(torch, lambda: fn(x, *args, act=act, **kw), flush)
            pms = _time_ms(torch, lambda: dbb_gemm_ref(x, *args, act=act,
                                                       **kw), flush)
            lms = _time_ms(torch, lambda: torch.matmul(x, w_dense), flush)
            live = int((w_dense != 0).sum().item())    # kept weights
            nbytes = x.numel() * 2 + stored + m * n * 2
            ops = 2.0 * m * live
            bms, by = _bound_ms(nbytes, ops, BF16_OPS_PER_S)
            print(f"kernel {name} M{m} K{k_dim} N{n} act={act}: max abs "
                  f"err {err:.3e} (tol 2e-2 rel, bf16) "
                  f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
                  f"{pms:.4f} ms, torch.matmul on the dequantized weight "
                  f"{lms:.4f} ms, bound {bms:.4f} ms ({by}; {stored} stored "
                  f"plane bytes)"
                  + (f"; {body} before it [{earlier:.4f} ms] "
                     f"({earlier / ms:.1f}x)" if earlier else ""))
            worst = max(worst, err)
            for key, v in (("ms", ms), ("plain_ms", pms), ("bound_ms", bms),
                           ("library_ms", lms)):
                tot[key] += calls * v
            t_bytes += calls * nbytes
            t_ops += calls * ops
        _, by = _bound_ms(t_bytes, t_ops, BF16_OPS_PER_S)
        per_m[m] = dict(max_abs_err=worst, bound_by=by, **tot)
    entry = dict(
        name=name, route="cuda", source=src, replaces=replaces, launches=0,
        shapes=f"one layer: M{ms_[0]} x (K,N) 4x(2048,2048) 2x(2048,8192) "
               "1x(8192,2048)" + (f", w4 G{W4_GROUP}" if plane == "_w4"
                                  else ", int8 values" if plane == "_i8"
                                  else ", f32 values"),
        **per_m[ms_[0]])
    if 24 in per_m:
        entry["m24"] = dict(per_m[24], shapes="the same layer at M24 (the "
                            "speculative verify pass)")
        entry["max_abs_err"] = max(v["max_abs_err"] for v in per_m.values())
    return entry


# convnet-dbb's classifier (fc 4096 -> 10, f32, DBB B=8 k=2, bias): the
# f32-x branch of each DBB kernel at the batch that takes it
CLASSIFIER_M = {"dbb_gemm": 256, "dbb_gemm_skinny": 1}


def _classifier_row(torch, randn, flush, failures, name):
    """The f32-x branch of ``name`` at convnet's classifier: checked against
    its plain version (rtol 1e-4: f32 sums over K 4096 in another order),
    timed beside it and ``torch.matmul`` on the decompressed weight (TF32
    off); the bound counts x, the stored planes, bias and the output once
    and the live weights' operations at the f32 rate."""
    from repro_torch.core.dbb import decompress_bitmask, pack_dbb
    from repro_torch.kernels.dbb_gemm.ops import dbb_gemm
    from repro_torch.kernels.dbb_gemm.ref import dbb_gemm_ref
    from repro_torch.kernels.skinny.ops import dbb_gemm_skinny
    from repro_torch.kernels.common import LAUNCHES
    fn = dbb_gemm if name == "dbb_gemm" else dbb_gemm_skinny
    counter = ("dbb_gemm_narrow" if name == "dbb_gemm"
               else "dbb_gemm_skinny_split")
    m, k_dim, n, nnz = CLASSIFIER_M[name], 4096, 10, 2
    p = pack_dbb(randn(k_dim, n) * 0.02, 8, nnz)
    dense = decompress_bitmask(p.values, p.bitmask, block=8)
    x, bias = randn(m, k_dim), randn(n)
    body_before = LAUNCHES[counter]
    got = fn(x, p.values, p.bitmask, bias, nnz=nnz)
    want = dbb_gemm_ref(x, p.values, p.bitmask, bias)
    err, ok = _close(torch, got, want, 1e-4)
    if not ok:
        failures.append(f"{name} classifier M{m}: max err {err}")
    if LAUNCHES[counter] != body_before + 1:
        failures.append(f"{name} classifier M{m}: no {counter} launch")
    ms = _time_ms(torch, lambda: fn(x, p.values, p.bitmask, bias, nnz=nnz),
                  flush)
    pms = _time_ms(torch, lambda: dbb_gemm_ref(x, p.values, p.bitmask, bias),
                   flush)
    lms = _time_ms(torch, lambda: torch.matmul(x, dense), flush)
    stored = p.values.numel() * 4 + p.bitmask.numel() * 4
    live = int((dense != 0).sum().item())
    bms, by = _bound_ms(x.numel() * 4 + stored + n * 4 + m * n * 4,
                        2.0 * m * live, F32_OPS_PER_S)
    earlier = PLAIN_FMA_MS[(name, "classifier")]
    print(f"kernel {name} M{m} K{k_dim} N{n} f32 x, DBB k{nnz} + bias "
          f"(convnet's classifier): max abs err {err:.3e} (tol 1e-4 rel) "
          f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain {pms:.4f} "
          f"ms, torch.matmul on the decompressed weight {lms:.4f} ms "
          f"({ms / lms:.1f}x), bound {bms:.4f} ms ({by}); split-K body "
          f"({counter}), earlier body [{earlier:.4f} ms] "
          f"({earlier / ms:.1f}x)")
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=lms,
                shapes=f"M{m} K{k_dim} N{n} f32 x, DBB k{nnz}, bias "
                       "(convnet's classifier)", body=counter)


# bf16 attention tolerance: the kernels round each tile's unnormalised
# probabilities to bf16 (as the Pallas kernels do), the plain versions the
# normalised ones — up to 2^-9 relative per term over up to 2048 keys
ATTN_RTOL, ATTN_ATOL = 2e-2, 1e-2


def _prefill_attention_kernels(torch, dev, randn, flush, failures):
    """flash_prefill at the three shapes the path gives it (generate's
    prefill, a padded admission, a chunk continuation) and
    flash_prefill_packed at one packed call; bf16, D 128, Hq = Hkv = 16:
    the tensor-core body, each call counting one ``_tc`` launch, printed
    beside the FMA body's earlier time. Each entry sums one call of each of
    its shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels.attn.ops import (flash_attention,
                                              packed_flash_attention)
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.attn.ref import (flash_prefill_ref,
                                              packed_prefill_ref)
    bf16, h, d = torch.bfloat16, 16, 128
    scale = d ** -0.5
    i32 = dict(dtype=torch.int32, device=dev)

    def measure(name, label, case, run_kernel, run_plain, run_lib, real,
                mask):
        tc_before = LAUNCHES[name + "_tc"]
        got, want = run_kernel(), run_plain()
        torch.cuda.synchronize()
        err, ok = _close(torch, got[real], want[real], ATTN_RTOL, ATTN_ATOL)
        if not ok:
            failures.append(f"{name} {label}: max err {err}")
        if LAUNCHES[name + "_tc"] != tc_before + 1:
            failures.append(f"{name} {label}: no tensor-core launch")
        ms = _time_ms(torch, run_kernel, flush)
        pms = _time_ms(torch, run_plain, flush)
        lms = _time_ms(torch, run_lib, flush)
        # the work this call's data needs: q and o rows that see a key,
        # k and v slots that some row sees (left pad and the slots past
        # the last query are skipped), and the visible query-key pairs
        rows = int(mask.any(-1).sum().item())
        slots = int(mask.any(-2).sum().item())
        pairs = int(mask.sum().item())
        nbytes = 2 * 2 * (rows + slots) * h * d       # q, o; k, v (bf16)
        ops = 4.0 * d * pairs * h
        bms, by = _bound_ms(nbytes, ops, BF16_OPS_PER_S)
        earlier = PLAIN_FMA_MS[(name, case)]
        print(f"kernel {name} {label}: max abs err {err:.3e} (tol "
              f"{ATTN_RTOL:g} rel + {ATTN_ATOL:g} of max, bf16) "
              f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms [FMA body before "
              f"it {earlier:.4f} ms, {earlier / ms:.1f}x], plain {pms:.4f} "
              f"ms, scaled_dot_product_attention {lms:.4f} ms ({ms / lms:.2f}"
              f"x), bound {bms:.4f} ms ({by}; {rows} query rows, {slots} key "
              f"slots, {pairs} visible pairs)")
        return dict(err=err, ms=ms, plain_ms=pms, library_ms=lms,
                    bound_ms=bms, nbytes=nbytes, ops=ops)

    def flash_case(label, case, b, t, s, start, q_offset):
        q = randn(b, t, h, d, dtype=bf16)
        k, v = randn(b, s, h, d, dtype=bf16), randn(b, s, h, d, dtype=bf16)
        st = torch.tensor(start, **i32)
        qo = torch.tensor(q_offset, **i32)
        qi = torch.arange(t, device=dev)[None, :] + qo[:, None]     # [B, T]
        kj = torch.arange(s, device=dev)[None, None, :]
        mask = (kj <= qi[:, :, None]) & (kj >= st[:, None, None])   # [B,T,S]
        qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        uniform = not any(start) and not any(q_offset) and t == s
        am = None if uniform else mask[:, None]
        return measure(
            "flash_prefill", label, case,
            lambda: flash_attention(q, k, v, st, q_offset=qo),
            lambda: flash_prefill_ref(qh, kh, vh, st, qo,
                                      sm_scale=scale).transpose(1, 2),
            lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=am, is_causal=uniform),
            qi >= st[:, None], mask)

    cases = [
        flash_case("generate prefill B8 T=S=64, start 0..49", "generate", 8,
                   64, 64, [0, 7, 14, 21, 28, 35, 42, 49], [0] * 8),
        flash_case("padded admission B1 T=S=512", "admission", 1, 512, 512,
                   [0], [0]),
        flash_case("chunk continuation B1 T256 S1024 q_offset 512", "chunk",
                   1, 256, 1024, [0], [512])]
    entries = [_attention_entry(
        "flash_prefill", "src/repro_torch/csrc/flash_prefill.cu",
        "src/repro/kernels/attn/kernel.py:128", cases,
        "one call each: B8 T=S=64 ragged start; B1 T=S=512; B1 T256 S1024 "
        "q_offset 512 (bf16, Hq=Hkv=16, D128)")]

    lens = [412, 96, 301, 187, 355, 64, 270, 363]      # 8 segments, 2048
    t = sum(lens)
    q, k, v = (randn(t, h, d, dtype=bf16) for _ in range(3))
    seg = torch.repeat_interleave(torch.arange(len(lens), **i32),
                                  torch.tensor(lens, device=dev))
    ii = torch.arange(t, device=dev)
    mask = (ii[None, :] <= ii[:, None]) & (seg[None, :] == seg[:, None])
    qh, kh, vh = (a.transpose(0, 1).contiguous() for a in (q, k, v))
    packed = measure(
        "flash_prefill_packed", f"T{t} over {len(lens)} segments {lens}",
        "packed", lambda: packed_flash_attention(q, k, v, seg),
        lambda: packed_prefill_ref(qh, kh, vh, seg,
                                   sm_scale=scale).transpose(0, 1),
        lambda: F.scaled_dot_product_attention(
            qh[None], kh[None], vh[None], attn_mask=mask),
        torch.ones(t, dtype=torch.bool, device=dev), mask)
    entries.append(_attention_entry(
        "flash_prefill_packed", "src/repro_torch/csrc/flash_prefill_packed.cu",
        "src/repro/kernels/attn/kernel.py:270", [packed],
        f"T{t} over 8 segments (bf16, Hq=Hkv=16, D128)"))
    return entries


def _attention_entry(name, src, replaces, cases, shapes):
    tot = {key: sum(c[key] for c in cases)
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    _, by = _bound_ms(sum(c["nbytes"] for c in cases),
                      sum(c["ops"] for c in cases), BF16_OPS_PER_S)
    return dict(name=name, route="cuda", source=src, replaces=replaces,
                launches=0, max_abs_err=max(c["err"] for c in cases),
                bound_by=by, shapes=shapes, **tot)


def _nchw_conv(torch, x, w, bias, k, stride, padding):
    """F.conv2d (cuDNN, TF32 off) on the NHWC image and the [kh·kw·C, N]
    weight, both viewed channels-last: the library yardstick."""
    import torch.nn.functional as F
    c, n = x.shape[-1], w.shape[1]
    wt = w.reshape(k, k, c, n).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    return F.conv2d(x.permute(0, 3, 1, 2), wt, bias, stride=stride,
                    padding=padding)


def _gemm_conv_kernels(torch, dev, randn, flush, failures):
    """sta_gemm at the dense-weights prefill MLP's shapes (M512 bf16: 2x
    K2048 N8192 with SiLU on one, 1x K8192 N2048 per layer) plus a ragged
    f32 check; conv_gemm at convnet's conv0 (B256) plus a stride-2 check;
    conv_gemm_dbb at convnet's conv1 and conv2 (B256, 25% live weights).
    Each entry sums its path's shapes."""
    from repro_torch.core.dbb import decompress_bitmask, pack_dbb
    from repro_torch.kernels.conv_gemm import (conv_gemm, conv_gemm_dbb,
                                               conv_gemm_dbb_ref,
                                               conv_gemm_ref)
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.sta_gemm import sta_gemm, sta_gemm_ref
    bf16, f32 = torch.bfloat16, torch.float32
    entries = []

    def measure(name, label, run_kernel, run_plain, run_lib, rtol, nbytes,
                ops, rate, earlier=None, body=None):
        """``earlier``: the replaced body's ms at this shape (a tensor-core
        body's, counted as ``name_tc``); ``body``: (its launch counter, "new
        body, old body", the old body's ms or None) for the other
        redesigned bodies. The call must count one launch of the body."""
        if earlier is not None and body is None:
            body = (name + "_tc", "tensor-core body, " + (
                "FMA body" if name.startswith("conv") else "plain-FMA body"),
                earlier)
        before = LAUNCHES[body[0]] if body else 0
        got, want = run_kernel(), run_plain()
        torch.cuda.synchronize()
        err, ok = _close(torch, got, want, rtol)
        if not ok:
            failures.append(f"{name} {label}: max err {err}")
        if body and LAUNCHES[body[0]] != before + 1:
            failures.append(f"{name} {label}: no {body[0]} launch")
        ms = _time_ms(torch, run_kernel, flush)
        pms = _time_ms(torch, run_plain, flush)
        lms = _time_ms(torch, run_lib, flush) if run_lib else None
        bms, by = _bound_ms(nbytes, ops, rate)
        print(f"kernel {name} {label}: max abs err {err:.3e} (tol {rtol:g} "
              f"rel) {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms, library "
              + (f"{lms:.4f} ms" if lms is not None else "not timed")
              + f", bound {bms:.4f} ms ({by})"
              + (f"; {body[1]} before it "
                 + (f"{body[2]:.4f} ms ({body[2] / ms:.1f}x)"
                    if body[2] is not None else "not timed") if body
                 else ""))
        return dict(err=err, ms=ms, plain_ms=pms, library_ms=lms,
                    bound_ms=bms, nbytes=nbytes, ops=ops, rate=rate)

    def entry(name, replaces, cases, shapes, source=None):
        tot = {key: sum(c["calls"] * c[key] for c in cases)
               for key in ("ms", "plain_ms", "bound_ms")}
        tot["library_ms"] = (None if any(c["library_ms"] is None
                                         for c in cases)
                             else sum(c["calls"] * c["library_ms"]
                                      for c in cases))
        t_bytes = sum(c["calls"] * c["nbytes"] for c in cases)
        t_ops = sum(c["calls"] * c["ops"] / c["rate"] for c in cases)
        by = "bytes" if t_bytes / HBM_BYTES_PER_S >= t_ops else "operations"
        return dict(name=name, route="cuda",
                    source=source or f"src/repro_torch/csrc/{name}.cu",
                    replaces=replaces, launches=0,
                    max_abs_err=max(c["err"] for c in cases), bound_by=by,
                    shapes=shapes, **tot)

    # -- sta_gemm ---------------------------------------------------------
    cases = []
    m = 512
    for k_dim, n, calls in ((2048, 8192, 2), (8192, 2048, 1)):
        x, w = randn(m, k_dim, dtype=bf16), randn(k_dim, n, dtype=bf16)
        act = "silu" if n == 8192 else "none"
        c = measure("sta_gemm", f"M{m} K{k_dim} N{n} act={act} bf16",
                    lambda: sta_gemm(x, w, act=act),
                    lambda: sta_gemm_ref(x, w, act=act),
                    lambda: torch.matmul(x, w), 2e-2,
                    2 * (m * k_dim + k_dim * n + m * n),
                    2.0 * m * k_dim * n, BF16_OPS_PER_S,
                    earlier=PLAIN_FMA_MS[("sta_gemm", k_dim, n)])
        cases.append(dict(c, calls=calls))
    x, w = randn(333, 1000), randn(1000, 777)
    b = randn(777)
    measure("sta_gemm", "ragged M333 K1000 N777 f32 (check)",
            lambda: sta_gemm(x, w, b, act="gelu"),
            lambda: sta_gemm_ref(x, w, b, act="gelu"), None, 1e-4,
            4 * (333 * 1000 + 1000 * 777 + 333 * 777), 2.0 * 333 * 1000 * 777,
            F32_OPS_PER_S)
    entries.append(entry(
        "sta_gemm", "src/repro/kernels/sta_gemm/kernel.py:64", cases,
        "one layer's MLP: M512 bf16, 2x (K2048,N8192) + 1x (K8192,N2048)"))

    # -- conv_gemm --------------------------------------------------------
    def conv_case(name, label, bsz, hw, c_in, n, k, stride, packed, calls,
                  earlier=None, body=None):
        x = randn(bsz, hw, hw, c_in)
        w = randn(k * k * c_in, n) / (k * k * c_in) ** 0.5
        bias = randn(n)
        kw = dict(kh=k, kw=k, stride=stride, act="relu")
        m_rows = bsz * (-(-hw // stride)) ** 2
        pad = (k - 1) // 2 if stride == 1 else None
        lib = (None if pad is None else
               lambda: _nchw_conv(torch, x, wd, bias, k, stride, pad))
        if packed:
            p = pack_dbb(w, 8, 2)
            wd = decompress_bitmask(p.values, p.bitmask, block=8)
            live = int((p.values != 0).sum().item())
            nbytes = 4 * (x.numel() + p.values.numel() + p.bitmask.numel()
                          + n + m_rows * n)
            return dict(measure(
                name, label,
                lambda: conv_gemm_dbb(x, p.values, p.bitmask, bias, nnz=2,
                                      **kw),
                lambda: conv_gemm_dbb_ref(x, p.values, p.bitmask, bias, **kw),
                lib, 1e-4, nbytes, 2.0 * m_rows * live, F32_OPS_PER_S,
                earlier=earlier), calls=calls)
        wd = w
        nbytes = 4 * (x.numel() + w.numel() + n + m_rows * n)
        ops, rate = 2.0 * m_rows * k * k * c_in * n, F32_OPS_PER_S
        if body and body[0] == "conv_gemm_tc":
            # 3xTF32: three tf32 products for each f32 one
            ops, rate = 3 * ops, TF32_OPS_PER_S
        return dict(measure(
            name, label, lambda: conv_gemm(x, w, bias, **kw),
            lambda: conv_gemm_ref(x, w, bias, **kw), lib, 1e-4, nbytes, ops,
            rate, body=body), calls=calls)

    small = ("conv_gemm_small", "small-C body, FMA body")
    dense = ("conv_gemm_tc", "tensor-core body (dense, 3xTF32), FMA body")
    conv0 = conv_case("conv_gemm", "convnet conv0 B256 32x32x3 -> 64 3x3 "
                      "SAME relu f32", 256, 32, 3, 64, 3, 1, False, 1,
                      body=small + (FMA_CONV0_MS,))
    lenet = conv_case("conv_gemm", "lenet conv1 B256 14x14x6 -> 16 5x5 SAME "
                      "relu f32", 256, 14, 6, 16, 5, 1, False, 1,
                      body=small + (None,))
    stacked = [conv_case("conv_gemm", f"convnet conv{i} (sta) B256 {hw}x{hw}"
                         f"x{c_in} -> {n} 3x3 SAME relu f32", 256, hw, c_in,
                         n, 3, 1, False, 1, body=dense + (None,))
               for i, (hw, c_in, n) in ((1, (16, 64, 128)),
                                        (2, (8, 128, 256)))]
    conv_case("conv_gemm", "stride 2 B4 32x32x32 -> 64 3x3 SAME relu f32 "
              "(check)", 4, 32, 32, 64, 3, 2, False, 0)
    entries.append(entry(
        "conv_gemm", "src/repro/kernels/conv_gemm/kernel.py:160", [conv0],
        "convnet conv0: B256 32x32x3 -> 64, 3x3 SAME, bias+relu, f32"))
    replaces = "src/repro/kernels/conv_gemm/kernel.py:160"
    entries.append(dict(entry(
        "conv_gemm_small", replaces, [conv0, lenet],
        "convnet conv0 (B256 32x32x3 -> 64, 3x3) + lenet conv1 (B256 "
        "14x14x6 -> 16, 5x5), SAME, bias+relu, f32",
        source="src/repro_torch/csrc/conv_gemm.cu"), body_of="conv_gemm"))
    entries.append(dict(entry(
        "conv_gemm_tc", replaces, stacked,
        "convnet conv1 + conv2 under matmul='sta' (dense weights): B256 "
        "16x16x64 -> 128 and 8x8x128 -> 256, 3x3 SAME, bias+relu, f32",
        source="src/repro_torch/csrc/conv_tc.cuh"), body_of="conv_gemm"))
    cases = [conv_case("conv_gemm_dbb", f"convnet conv{i} B256 {hw}x{hw}x"
                       f"{c_in} -> {n} 3x3 SAME relu f32, DBB k=2", 256, hw,
                       c_in, n, 3, 1, True, 1,
                       earlier=FMA_CONV_MS[("conv_gemm_dbb", i)])
             for i, (hw, c_in, n) in ((1, (16, 64, 128)), (2, (8, 128, 256)))]
    entries.append(entry(
        "conv_gemm_dbb", "src/repro/kernels/conv_gemm/kernel.py:215", cases,
        "convnet conv1 + conv2: B256 16x16x64 -> 128 and 8x8x128 -> 256, 3x3 "
        "SAME, bias+relu, f32, DBB B8 k2"))
    return entries


# ---------------------------------------------------------------------------
# phase 3, the int8 branches (INT8 x INT8 -> INT32)
# ---------------------------------------------------------------------------

def _s8_check(torch, got, want, act):
    """(max abs error, elements off by one, passes) of an int8 branch
    against its plain version: bit-equal after act none or relu (int32,
    int8 and f32 outputs alike); after gelu or silu an f32 output within
    rtol 1e-6 (atol 1e-7·max|want|: libm tanh / exp may differ by an ulp),
    an int8 or int32 one off by at most 1 on at most 0.1% of the elements
    (at least one)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return float("inf"), 0, False
    diff = (got.double() - want.double()).abs()
    err = diff.max().item() if diff.numel() else 0.0
    if act in ("none", "relu"):
        return err, 0, bool(torch.equal(got, want))
    if got.dtype == torch.float32:
        tol = 1e-6 * want.double().abs() + 1e-7 * want.abs().max().item()
        return err, 0, bool((diff <= tol).all())
    off = int((diff > 0).sum())
    return err, off, err <= 1 and off <= max(1, want.numel() // 1000)


def _quantized(torch, gen, shape, dev):
    """int8 activations as the INT8 chain makes them: a standard-normal
    tensor quantized by its per-tensor ``act_scale``; returns (q, x_s)."""
    from repro_torch.core.quant import act_scale
    x = torch.randn(shape, generator=gen, device=dev)
    xs = act_scale(x)
    return torch.clamp(torch.round(x / xs), -127, 127).to(torch.int8), xs


def _s8_epilogues(torch, xs, wscale, bias, act, ys):
    """The three epilogues of an int8 GEMM or conv: (label, keyword
    operands, act): the raw int32 sum; f32 dequantized by x_s·w_s with a
    bias and ``act``; int8 requantized by 1/y_s with ``act`` (y_s the f32
    output's act_scale, so the int8 range is used)."""
    s = xs * wscale
    return (("int32", {}, "none"),
            ("f32", dict(bias=bias, scale=s), act),
            ("int8", dict(bias=bias / ys, scale=s / ys,
                          out_dtype=torch.int8), act))


def _int_mm_ms(torch, x, w, flush):
    """torch._int_mm on the same int8 operands (int32 out), or None and the
    reason where its shape rules refuse the call."""
    try:
        torch._int_mm(x, w)
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, "torch._int_mm refuses: " + str(e).splitlines()[0][:80]
    return _time_ms(torch, lambda: torch._int_mm(x, w), flush), ""


def _s8_kernels(torch, dev, flush, failures):
    """The int8 branch of each of the six kernels at the paths' shapes:
    olmo-1b's layer GEMMs (LAYER_SHAPES: dense INT8 weights from
    quantize_weight; the DBB kernels on the INT8 values plane, k = 4) at
    M8 and M24 (skinny) and M512 (M-tiled); convnet's conv0 (dense) and
    conv1, conv2 (DBB k = 2) at batch 256. Each shape runs three
    epilogues (_s8_epilogues: silu on N 8192 and relu on the convs, else
    none) against the plain version (_s8_check); the f32 one is timed
    beside the plain version, torch._int_mm where it takes the operands,
    and the bound: max(bytes ÷ 3.35 TB/s, operations ÷ 1979 TOP/s)."""
    from repro_torch.core.dbb import decompress_bitmask, pack_dbb
    from repro_torch.core.quant import act_scale, quantize_weight
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.conv_gemm import (conv_gemm, conv_gemm_dbb,
                                               conv_gemm_dbb_ref,
                                               conv_gemm_ref)
    from repro_torch.kernels.conv_gemm.ops import small_body
    from repro_torch.kernels.dbb_gemm import dbb_gemm
    from repro_torch.kernels.dbb_gemm.ref import dbb_gemm_ref
    from repro_torch.kernels.skinny import dbb_gemm_skinny, sta_gemm_skinny
    from repro_torch.kernels.sta_gemm import sta_gemm, sta_gemm_ref
    gen = torch.Generator(device=dev).manual_seed(16)
    entries = []

    def case(name, label, run, plain, epis, lib, nbytes, ops, tc=None):
        """Check every epilogue, time the f32 one; returns the timings.
        ``tc``: (the body's own launch counter or None, the replaced body's
        earlier ms, a bf16 yardstick at the shape, "new body, old body" and
        optionally the yardstick's name, bf16 torch.matmul by default) for
        the redesigned bodies: the int8 tensor-core body at M512, the int8
        split-K body of the skinny kernels, the conv's tensor-core body
        (beside cuDNN's bf16 F.conv2d)."""
        worst, offs, good = 0.0, [], True
        before = LAUNCHES[tc[0]] if tc and tc[0] else 0
        for tag, kw, act in epis:
            got, want = run(act, **kw), plain(act, **kw)
            err, off, ok = _s8_check(torch, got, want, act)
            worst, good = max(worst, err), good and ok
            offs.append(f"{tag} {act}: err {err:.3e}"
                        + (f", {off} off by one" if act not in
                           ("none", "relu") and tag != "f32" else ""))
            if not ok:
                failures.append(f"{name} {label} {tag} {act}: max err {err}")
        if tc and tc[0] and LAUNCHES[tc[0]] != before + len(epis):
            failures.append(f"{name} {label}: {LAUNCHES[tc[0]] - before} "
                            f"{tc[0]} launches of {len(epis)}")
        _, kw, act = epis[1]
        ms = _time_ms(torch, lambda: run(act, **kw), flush)
        pms = _time_ms(torch, lambda: plain(act, **kw), flush)
        lms, why = lib() if lib else (None, "F.conv2d has no int8 path on "
                                      "CUDA")
        bms, by = _bound_ms(nbytes, ops, INT8_OPS_PER_S)
        extra = ""
        if tc:
            tag, kw0, act0 = epis[0]
            raw = _time_ms(torch, lambda: run(act0, **kw0), flush)
            mm = _time_ms(torch, tc[2], flush)
            body, old = tc[3].split(", ")
            yard = tc[4] if len(tc) > 4 else "bf16 torch.matmul"
            extra = (f", {yard} {mm:.4f} ms; {tag} output "
                     f"{raw:.4f} ms; {body}, {old} before it "
                     + (f"[{tc[1]:.4f} ms] ({tc[1] / ms:.1f}x)"
                        if tc[1] is not None else "[not timed]"))
        print(f"kernel {name} {label}: {'; '.join(offs)} "
              f"{'ok' if good else 'FAIL'}"
              f"; kernel {ms:.4f} ms, plain {pms:.4f} ms, library "
              + (f"(torch._int_mm) {lms:.4f} ms" if lms is not None
                 else f"— ({why})")
              + f", bound {bms:.4f} ms ({by})" + extra)
        return dict(err=worst, ms=ms, plain_ms=pms, library_ms=lms,
                    bound_ms=bms, nbytes=nbytes, ops=ops)

    def entry(name, src, replaces, per_m, shapes):
        out = {}
        for m, cases in per_m.items():
            tot = {k: sum(c["calls"] * c[k] for c in cases)
                   for k in ("ms", "plain_ms", "bound_ms")}
            tot["library_ms"] = (None if any(c["library_ms"] is None
                                             for c in cases) else
                                 sum(c["calls"] * c["library_ms"]
                                     for c in cases))
            _, by = _bound_ms(sum(c["calls"] * c["nbytes"] for c in cases),
                              sum(c["calls"] * c["ops"] for c in cases),
                              INT8_OPS_PER_S)
            out[m] = dict(max_abs_err=max(c["err"] for c in cases),
                          bound_by=by, **tot)
        first, *rest = per_m
        e = dict(name=name, route="cuda", source=src, replaces=replaces,
                 launches=0, shapes=shapes, **out[first])
        for m in rest:
            e[f"m{m}"] = dict(out[m], shapes=f"the same at M{m}")
        e["max_abs_err"] = max(v["max_abs_err"] for v in out.values())
        return e

    # -- the GEMMs: one olmo-1b layer ----------------------------------------
    for name, src, replaces, ms_, fn, dbb in (
            ("sta_gemm_s8", "src/repro_torch/csrc/sta_gemm.cu",
             "src/repro/kernels/sta_gemm/kernel.py:64", (512,), sta_gemm,
             False),
            ("sta_gemm_skinny_s8", "src/repro_torch/csrc/sta_gemm_skinny.cu",
             "src/repro/kernels/skinny/kernel.py:77", (8, 24),
             sta_gemm_skinny, False),
            ("dbb_gemm_s8", "src/repro_torch/csrc/dbb_gemm.cu",
             "src/repro/kernels/dbb_gemm/kernel.py:114", (512,), dbb_gemm,
             True),
            ("dbb_gemm_skinny_s8", "src/repro_torch/csrc/dbb_gemm_skinny.cu",
             "src/repro/kernels/skinny/kernel.py:167", (8, 24),
             dbb_gemm_skinny, True)):
        per_m = {}
        for m in ms_:
            cases = []
            for k_dim, n, calls in LAYER_SHAPES:
                x, xs = _quantized(torch, gen, (m, k_dim), dev)
                qw = quantize_weight(torch.randn(k_dim, n, generator=gen,
                                                 device=dev))
                bias = torch.randn(n, generator=gen, device=dev)
                if dbb:
                    p = pack_dbb(qw.q, 8, 4)
                    wd = decompress_bitmask(p.values, p.bitmask, block=8)
                    stored = p.values.numel() + p.bitmask.numel() * 4

                    def run(act, _p=p, _x=x, **kw):
                        return fn(_x, _p.values, _p.bitmask, act=act, **kw)

                    def plain(act, _p=p, _x=x, **kw):
                        return dbb_gemm_ref(_x, _p.values, _p.bitmask,
                                            act=act, **kw)
                    ops = 2.0 * m * int((wd != 0).sum().item())
                else:
                    wd = qw.q
                    stored = wd.numel()

                    def run(act, _w=wd, _x=x, **kw):
                        return fn(_x, _w, act=act, **kw)

                    def plain(act, _w=wd, _x=x, **kw):
                        return sta_gemm_ref(_x, _w, act=act, **kw)
                    ops = 2.0 * m * k_dim * n
                act = "silu" if n == 8192 else "none"
                ys = act_scale(plain(act, bias=bias, scale=xs * qw.scale))
                epis = _s8_epilogues(torch, xs, qw.scale, bias, act, ys)
                nbytes = x.numel() + stored + 8 * n + 4 * m * n
                tc = None
                xb, wb = x.bfloat16(), wd.bfloat16()
                if (name, k_dim, n) in IMAD_S8_MS:
                    tc = (name + "_tc", IMAD_S8_MS[name, k_dim, n],
                          lambda _x=xb, _w=wb: torch.matmul(_x, _w),
                          "int8 tensor-core body, IMAD body")
                elif (name, m, k_dim, n) in ROW_CHUNK_S8_MS:
                    tc = (None, ROW_CHUNK_S8_MS[name, m, k_dim, n],
                          lambda _x=xb, _w=wb: torch.matmul(_x, _w),
                          "int8 split-K body, row-chunk body")
                c = case(name, f"M{m} K{k_dim} N{n}", run, plain, epis,
                         lambda _x=x, _w=wd: _int_mm_ms(torch, _x, _w, flush),
                         nbytes, ops, tc)
                cases.append(dict(c, calls=calls))
            per_m[m] = cases
        entries.append(entry(
            name, src, replaces, per_m,
            f"one olmo-1b layer: M{ms_[0]} x (K,N) 4x(2048,2048) "
            "2x(2048,8192) 1x(8192,2048), int8 x"
            + (", INT8 DBB values k4" if dbb else ", int8 w")
            + "; the f32 epilogue (x_s·w_s, bias, silu on N8192) timed"))

    # -- the convs at batch 256: convnet's conv0 on conv_gemm's small-C
    # body (the path's); lenet's conv1 (small-C) and convnet's dense conv1,
    # conv2 (tensor-core body) as checks; convnet's conv1, conv2 on
    # conv_gemm_dbb (the path's)
    for name, src, replaces, layers in (
            ("conv_gemm_s8", "src/repro_torch/csrc/conv_gemm.cu",
             "src/repro/kernels/conv_gemm/kernel.py:160",
             (("convnet conv0", 0, 32, 3, 64, 3, 1),
              ("lenet conv1", None, 14, 6, 16, 5, 0),
              ("convnet conv1 (sta)", None, 16, 64, 128, 3, 0),
              ("convnet conv2 (sta)", None, 8, 128, 256, 3, 0))),
            ("conv_gemm_dbb_s8", "src/repro_torch/csrc/conv_gemm_dbb.cu",
             "src/repro/kernels/conv_gemm/kernel.py:215",
             (("convnet conv1", 1, 16, 64, 128, 3, 1),
              ("convnet conv2", 2, 8, 128, 256, 3, 1)))):
        cases = []
        for label, i, hw, c_in, n, k, calls in layers:
            x, xs = _quantized(torch, gen, (256, hw, hw, c_in), dev)
            qw = quantize_weight(torch.randn(k * k * c_in, n, generator=gen,
                                             device=dev))
            bias = torch.randn(n, generator=gen, device=dev)
            geo = dict(kh=k, kw=k)
            m_rows = 256 * hw * hw
            if name == "conv_gemm_dbb_s8":
                p = pack_dbb(qw.q, 8, 2)
                live = int((p.values != 0).sum().item())
                stored = p.values.numel() + p.bitmask.numel() * 4
                wd = decompress_bitmask(p.values, p.bitmask, block=8).float()

                def run(act, _p=p, _x=x, **kw):
                    return conv_gemm_dbb(_x, _p.values, _p.bitmask, act=act,
                                         nnz=2, **geo, **kw)

                def plain(act, _p=p, _x=x, **kw):
                    return conv_gemm_dbb_ref(_x, _p.values, _p.bitmask,
                                             act=act, **geo, **kw)
                tc = ("conv_gemm_dbb_s8_tc", FMA_CONV_MS[name, i],
                      "int8 tensor-core body, IMAD body")
            else:
                live, stored = qw.q.numel(), qw.q.numel()
                wd = qw.q.float()

                def run(act, _w=qw.q, _x=x, **kw):
                    return conv_gemm(_x, _w, act=act, **geo, **kw)

                def plain(act, _w=qw.q, _x=x, **kw):
                    return conv_gemm_ref(_x, _w, act=act, **geo, **kw)
                small = small_body(torch.int8, c_in, k, k, n)
                tc = (("conv_gemm_s8_small", IMAD_CONV0_S8_MS if i == 0
                       else None, "small-C body, IMAD body") if small else
                      ("conv_gemm_s8_tc", None,
                       "int8 tensor-core body (dense), IMAD body"))
            ys = act_scale(plain("relu", bias=bias, scale=xs * qw.scale))
            epis = _s8_epilogues(torch, xs, qw.scale, bias, "relu", ys)
            tc = (tc[0], tc[1],
                  lambda _x=x.float(), _w=wd, _b=bias, _k=k: _nchw_conv(
                      torch, _x.bfloat16(), _w.bfloat16(), _b.bfloat16(),
                      _k, 1, (_k - 1) // 2),
                  tc[2], "bf16 F.conv2d (cuDNN)")
            c = case(name, f"{label} B256 {hw}x{hw}x{c_in} -> {n} {k}x{k} "
                     "SAME" + ("" if calls else " (check)"), run, plain,
                     epis, None, x.numel() + stored + 8 * n + 4 * m_rows * n,
                     2.0 * m_rows * live, tc)
            cases.append(dict(c, calls=calls))
            if name == "conv_gemm_s8" and i == 0:
                small_cases = [dict(c, calls=1)]
        entries.append(entry(
            name, src, replaces, {256: cases},
            ("convnet conv0: B256 32x32x3 -> 64" if name == "conv_gemm_s8"
             else "convnet conv1 + conv2: B256 16x16x64 -> 128 and 8x8x128 "
             "-> 256, INT8 DBB values k2")
            + ", 3x3 SAME, int8 image; the f32 epilogue (x_s·w_s, bias, "
            "relu) timed"))
        if name == "conv_gemm_s8":
            entries.append(dict(entry(
                "conv_gemm_s8_small", src, replaces, {256: small_cases},
                "convnet conv0 (the INT8 chain's): B256 32x32x3 -> 64, 3x3 "
                "SAME, int8 image; the f32 epilogue (x_s·w_s, bias, relu) "
                "timed"), body_of="conv_gemm_s8"))
    return entries


# epilogue operations per logit of the sampling head (penalty selects, three
# murmur rounds of the hash, the uniform, two logs, scale and add)
SAMPLE_EPI_OPS = 24


def _head_sample_inputs(torch, dev, m, k, n, seed):
    """Hidden rows scaled so the logits are O(1) (the Gumbel noise decides
    tokens), a head of unit-variance weights, counts from a seeded generator
    with two of every three rows above zero, temperature-0 rows among the
    sampled ones, and non-default penalties."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(m, k, generator=g, device=dev) / k ** 0.5
    w = torch.randn(k, n, generator=g, device=dev)
    counts = torch.randint(0, 3, (m, n), generator=g, device=dev,
                           dtype=torch.int32)
    counts[::3] = 0
    r = torch.arange(m, device=dev)
    temp = torch.where(r % 4 == 0, 0.0, 0.5 + 0.1 * (r % 7)).float()
    rep = torch.where(r % 2 == 0, 1.0, 1.3).float()
    pres = torch.where(r % 3 == 1, 0.4, 0.0).float()
    freq = torch.where(r % 5 == 2, 0.2, 0.0).float()
    rows = (temp, rep, pres, freq, (r * 7919 - 3).to(torch.int32),
            (r * 3).to(torch.int32))
    return h, w, counts, rows


def _head_sample_case(torch, dev, flush, m, k, n, seed):
    """head_sample_fused at [M, K] x [K, N] f32 against its plain version
    by the near-tie rule: scores within 1e-5 of the largest (f32 sums in
    another order; logf may differ by an ulp), indices equal on every row
    whose top-2 score margin exceeds twice that; at temperature 0 with
    default penalties it must equal the greedy head (sta_gemm_skinny: one
    float body, skinny_float.cuh) bit for bit. Prints the case and returns
    (its numbers, a failure message or None). No single PyTorch call
    computes this function: the head's torch.matmul alone is printed as a
    partial yardstick, beside the greedy head's time (the float body with
    its store epilogue) and, at the kernel phase's shape, the row-chunk
    body's earlier time in brackets."""
    from repro_torch.kernels.sample import (apply_penalties,
                                            head_sample_fused,
                                            head_sample_fused_ref,
                                            sample_scores)
    from repro_torch.kernels.skinny import sta_gemm_skinny
    h, w, counts, rows = _head_sample_inputs(torch, dev, m, k, n, seed)
    got_s, got_i = head_sample_fused(h, w, counts, *rows)
    want_s, want_i = head_sample_fused_ref(h, w, counts, *rows)
    torch.cuda.synchronize()
    tol = 1e-5 * max(want_s.abs().max().item(), 1.0)
    err = (got_s - want_s).abs().max().item()
    col = torch.arange(n, device=dev)[None, :]
    scores = sample_scores(h @ w, counts, *(a[:, None] for a in rows), col)
    top2 = scores.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * tol
    same = bool((got_i == want_i)[decided].all())
    pen = apply_penalties(h @ w, counts, rows[1][:, None], rows[2][:, None],
                          rows[3][:, None])
    differs = int((got_i.long() != pen.argmax(-1)).sum())
    del scores, pen
    z = torch.zeros(m, device=dev)
    zi = torch.zeros(m, dtype=torch.int32, device=dev)
    t0_s, t0_i = head_sample_fused(h, w, torch.zeros_like(counts), z, z + 1,
                                   z, z, zi, zi)
    greedy = sta_gemm_skinny(h, w)
    t0_ok = (bool(torch.equal(t0_s, greedy.max(dim=-1).values))
             and bool(torch.equal(t0_i.long(), greedy.argmax(dim=-1))))
    ok = err <= tol and same and t0_ok
    fail = None if ok else (
        f"head_sample_fused M{m} K{k} N{n}: max score err {err}, indices "
        f"equal on decided rows: {same}, temperature 0 equal to the greedy "
        f"head: {t0_ok}")
    ms = _time_ms(torch, lambda: head_sample_fused(h, w, counts, *rows),
                  flush)
    pms = _time_ms(torch, lambda: head_sample_fused_ref(h, w, counts, *rows),
                   flush)
    mm_ms = _time_ms(torch, lambda: torch.matmul(h, w), flush)
    greedy_ms = _time_ms(torch, lambda: sta_gemm_skinny(h, w), flush)
    nbytes = 4 * (k * n + m * n + m * k + 6 * m + 2 * m)
    ops = 2.0 * m * k * n + SAMPLE_EPI_OPS * m * n
    bms, by = _bound_ms(nbytes, ops, F32_OPS_PER_S)
    earlier = ROW_CHUNK_SAMPLE_MS.get(m) if (k, n) == (2048, 50304) else None
    print(f"kernel head_sample_fused M{m} K{k} N{n} f32: max score err "
          f"{err:.3e} (tol {tol:.3e}); indices equal on "
          f"{int(decided.sum())}/{m} decided rows {'ok' if ok else 'FAIL'} "
          f"(Gumbel noise moved {differs} of {m} rows off the penalised "
          f"argmax), temperature 0 "
          f"{'equal to' if t0_ok else 'DIFFERS FROM'} the greedy head bit "
          f"for bit; kernel {ms:.4f} ms"
          + (f" [row-chunk body {earlier:.4f} ms]" if earlier else "")
          + f", greedy head (the same float body) {greedy_ms:.4f} ms, plain "
          f"{pms:.4f} ms, no library call computes it (the head's "
          f"torch.matmul alone, a partial yardstick: {mm_ms:.4f} ms), bound "
          f"{bms:.4f} ms ({by}: weight + counts + rows)")
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=None, head_matmul_ms=mm_ms,
                greedy_ms=greedy_ms), fail


def _head_sample_kernel(torch, dev, flush, failures):
    """head_sample_fused at the sampled decode head (M8 K2048 N50304 f32,
    the entry) and at M1 (a single-row prefill), M24 and M32 (checks),
    each by `_head_sample_case`'s rules."""
    entry = None
    for m in (8, 1, 24, 32):
        res, fail = _head_sample_case(torch, dev, flush, m, 2048, 50304, m)
        if fail:
            failures.append(fail)
        if entry is None:
            entry = dict(
                name="head_sample_fused", route="cuda",
                source="src/repro_torch/csrc/head_sample_fused.cu",
                replaces="src/repro/kernels/sample/kernel.py:83",
                launches=0, max_abs_err=res["max_abs_err"], ms=res["ms"],
                plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
                bound_by=res["bound_by"], library_ms=None,
                head_matmul_ms=res["head_matmul_ms"],
                shapes="M8 K2048 N50304 f32 (the sampled decode head)")
        entry["max_abs_err"] = max(entry["max_abs_err"], res["max_abs_err"])
    return entry


# ---------------------------------------------------------------------------
# phase 4: the full-width slice
# ---------------------------------------------------------------------------

def _split_rows(out, xout):
    """Per row, compare a kernel-route stream with the plain route's up to
    their first difference: (equal tokens, compared tokens, [(row, step)]
    of rows that split or stop at different lengths)."""
    same, total, split = 0, 0, []
    for i, (r, s) in enumerate(zip(out, xout)):
        j = next((j for j, (a, b) in enumerate(zip(r, s)) if a != b), None)
        if j is None:
            same += min(len(r), len(s))
            total += max(len(r), len(s))
            if len(r) != len(s):
                split.append((i, min(len(r), len(s))))
        else:
            same += j
            total += len(r)
            split.append((i, j))
    return same, total, split


def _split_gaps(torch, last_logits, xcfg, prompts, out, xout, split):
    """The plain route's logit gap between the two routes' tokens at each
    split, recomputed on the shared context (inf where one stopped)."""
    gaps = []
    if not split:
        return gaps
    ctx = [prompts[i] + out[i][:j] for i, j in split]
    lg = torch.cat([last_logits(xcfg, ctx[a:a + 8])
                    for a in range(0, len(ctx), 8)])
    for row, (i, j) in enumerate(split):
        if j >= min(len(out[i]), len(xout[i])):
            gaps.append(float("inf"))          # one route stopped early
            continue
        gap = lg[row, xout[i][j]] - lg[row, out[i][j]]
        gaps.append(abs(gap.item()))
    return gaps


def _logits_fn(torch, dev, engine):
    from repro_torch.kernels import dispatch
    from repro_torch.models import registry

    def last_logits(c, contexts):
        """f32 head logits at the last position of each left-padded
        context, through route config ``c`` (no ``start`` when no row is
        padded, so one long context takes the plain route's chunked
        attention, as generate's own prefill does)."""
        width = max(len(t) for t in contexts)
        toks = torch.zeros((len(contexts), width), dtype=torch.int32)
        for i, t in enumerate(contexts):
            toks[i, width - len(t):] = torch.tensor(t)
        pads = [width - len(t) for t in contexts]
        start = (torch.tensor(pads, dtype=torch.int32, device=dev)
                 if any(pads) else None)
        cache = registry.init_cache(c, len(contexts), width + 1, device=dev)
        h, _ = registry.prefill(engine.params, c, toks.to(dev), cache,
                                start=start)
        return dispatch.matmul(h[:, -1].float().contiguous(), engine.head,
                               cfg=c, gemv=True)
    return last_logits

def _slice_phase(torch, dev, report, out_dir):
    from repro_torch.configs import get_config
    from repro_torch.core.dbb_linear import pack_tree, tree_footprint_bytes
    from repro_torch.core.sparsity import apply_dbb_to_tree
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.models import registry
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("olmo-1b").replace(remat="none", gemm_impl="pallas")
    xcfg = cfg.replace(gemm_impl="xla")
    t0 = time.perf_counter()
    packed = pack_tree(apply_dbb_to_tree(
        registry.init_params(cfg, seed=0, device=dev), cfg.dbb,
        straight_through=False), cfg.dbb)
    torch.cuda.synchronize()
    footprint = tree_footprint_bytes(packed)
    print(f"slice: olmo-1b full width ({cfg.num_layers} layers, d "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}); init + project + pack "
          f"{time.perf_counter() - t0:.1f} s; packed tree "
          f"{footprint / 1e9:.3f} GB")
    engine = ServeEngine(cfg, packed, max_batch=8, device=dev)
    gen = torch.Generator().manual_seed(1)
    lens = [64, 57, 50, 43, 36, 29, 22, 15]
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in lens]
    new = 64
    engine.generate(prompts, max_new_tokens=8)          # warm-up
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    steps = engine.last_decode_steps

    t0 = time.perf_counter()
    engine.generate(prompts, max_new_tokens=1)          # prefill + head only
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    decode_ms = (t_total - t_prefill) / max(steps, 1) * 1e3
    n_tok = sum(len(o) for o in out)
    print(f"slice: generate 8 prompts (lengths {lens}), max_new_tokens "
          f"{new}: {t_total * 1e3:.1f} ms total; prefill "
          f"{t_prefill * 1e3:.1f} ms (a separate max_new_tokens=1 call); "
          f"decode estimate {decode_ms:.3f} ms/step (total minus that call, "
          f"over {steps} steps); {n_tok / t_total:.1f} generated tokens/s "
          f"({8 * steps / max(t_total - t_prefill, 1e-9):.1f} decode "
          f"row-steps/s)")
    print(f"slice: launches in the generate run: {counts}")
    report["slice"] = dict(total_ms=t_total * 1e3, footprint_bytes=footprint,
                           prefill_ms=t_prefill * 1e3,
                           decode_ms_per_step=decode_ms, steps=steps,
                           tokens=n_tok, launches=counts)
    ok = all(counts[k] > 0 for k in GENERATE_KERNELS)
    if not ok:
        print("slice: FAIL: a kernel of the path never launched")
    last_logits = _logits_fn(torch, dev, engine)

    # prefill last-position logits, kernel route vs plain route
    logits = {name: last_logits(c, prompts)
              for name, c in (("kernel", cfg), ("plain", xcfg))}
    diff = (logits["kernel"] - logits["plain"]).abs().max().item()
    scale = logits["plain"].abs().max().item()
    tol = LOGIT_TOL * scale
    lok = diff <= tol
    print(f"slice: prefill last-position logits, kernel route vs plain "
          f"route: max abs diff {diff:.4e} of max |logit| {scale:.4e} "
          f"(tol {LOGIT_TOL:g} of max = {tol:.4e}, bf16 activations over "
          f"{cfg.num_layers} layers) {'ok' if lok else 'FAIL'}")

    # greedy tokens, kernel route vs plain route. Logits within tol of each
    # other can pick different tokens only where the plain route's logits
    # of the two lie within 2 * tol; each row is compared up to its
    # first difference (the contexts differ after it), and that step is
    # excused only when the gap, recomputed on the shared context, is
    # within that bound.
    xout = ServeEngine(xcfg, packed, max_batch=8,
                       device=dev).generate(prompts, max_new_tokens=new)
    same, total, split = _split_rows(out, xout)
    gaps = _split_gaps(torch, last_logits, xcfg, prompts, out, xout, split)
    tok_ok = all(g <= 2 * tol for g in gaps)
    print(f"slice: greedy tokens, kernel vs plain route: {same}/{total} "
          f"equal; rows that split (row, step, plain-route gap): "
          f"{[(i, j, g) for (i, j), g in zip(split, gaps)]} (excused where "
          f"gap <= 2 x logit tol = {2 * tol:.4e}) "
          f"{'ok' if tok_ok else 'FAIL'}")
    report["slice"].update(logit_max_abs_diff=diff, logit_scale=scale,
                           logit_tol=tol, token_agreement=[same, total],
                           token_splits=[[i, j, g] for (i, j), g
                                         in zip(split, gaps)])
    if out_dir:
        _profile(torch, lambda: engine.generate(prompts, max_new_tokens=new),
                 f"generate(8 prompts, max_new_tokens={new})",
                 "profile_generate", out_dir, report)
    return counts, packed, ok and lok and tok_ok


def _profile(torch, run, label, key, out_dir, report):
    """torch.profiler over one call of ``run``: device time by kernel name
    and the device's busy share of the (profiled) wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue            # host-side ops; their kernels are listed
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    lines = [f"{label} under the profiler: wall {wall_ms:.2f} ms, device "
             f"kernels {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}% busy)"]
    lines += [f"{ms:10.3f} ms {n:6d} x  {name[:90]}" for ms, n, name in rows]
    with open(os.path.join(out_dir, f"{key}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("profile: " + lines[0])
    for line in lines[1:9]:
        print("profile: " + line)
    report[key] = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                       top=[list(r) for r in rows[:20]])


# ---------------------------------------------------------------------------
# phase 5: continuous batching at full width
# ---------------------------------------------------------------------------

def _serve_phase(torch, dev, report, packed, out_dir):
    from repro_torch.configs import get_config
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("olmo-1b").replace(remat="none", gemm_impl="pallas",
                                        kv_page_size=64)
    xcfg = cfg.replace(gemm_impl="xla")
    prompts, budgets = _serve_requests(torch, cfg)
    print(f"serve: 24 requests through 8 slots; prompt lengths "
          f"{[len(p) for p in prompts]}; budgets {budgets}")
    runs = {"serve_packed": (cfg, dict(paged=False), SERVE_KERNELS),
            "serve_paged": (cfg, dict(paged=True), SERVE_KERNELS),
            "serve_chunked": (cfg, dict(paged=False, prefill_chunk=256),
                              SERVE_KERNELS + ("flash_prefill",))}
    # warm-up: one short request per engine layout
    for _, (c, kw, _) in runs.items():
        ServeEngine(c, packed, max_batch=8, device=dev, **kw).serve(
            prompts[:2], max_new_tokens=4)
    torch.cuda.synchronize()
    outs, counts, ok = {}, {}, True
    report["serve"] = {}
    for name, (c, kw, need) in runs.items():
        eng = ServeEngine(c, packed, max_batch=8, device=dev, **kw)
        reset_launches()
        t0 = time.perf_counter()
        outs[name] = eng.serve(prompts, max_new_tokens=budgets)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = dict(LAUNCHES)
        n_tok = sum(len(o) for o in outs[name])
        ttft = sorted(eng.serve_stats["ttft_s"])
        med, p90 = ttft[len(ttft) // 2], ttft[int(0.9 * (len(ttft) - 1))]
        stats = {k: v for k, v in eng.serve_stats.items() if k != "ttft_s"}
        missing = [k for k in need if counts[name][k] == 0]
        ok = ok and not missing
        print(f"serve: {name} {kw}: {wall * 1e3:.1f} ms, {n_tok} tokens, "
              f"{n_tok / wall:.1f} generated tokens/s; ttft median "
              f"{med * 1e3:.1f} ms, p90 {p90 * 1e3:.1f} ms (one run each, "
              f"single-run figures); serve_stats {stats}; launches "
              f"{counts[name]}"
              + (f"; FAIL: never launched {missing}" if missing else ""))
        report["serve"][name] = dict(wall_ms=wall * 1e3, tokens=n_tok,
                                     ttft_median_ms=med * 1e3,
                                     ttft_p90_ms=p90 * 1e3, stats=stats,
                                     launches=counts[name])
        if name == "serve_packed" and out_dir:
            _profile(torch, lambda: eng.serve(prompts,
                                              max_new_tokens=budgets),
                     "serve(24 requests, packed, contiguous)",
                     "profile_serve", out_dir, report)
    paged_ok = outs["serve_packed"] == outs["serve_paged"]
    print(f"serve: paged vs contiguous token streams "
          f"{'equal' if paged_ok else 'DIFFERENT'}")

    # (a) and (c) against the plain route's serve in the same mode
    tol = LOGIT_TOL * report["slice"]["logit_scale"]
    tok_ok = True
    for name in ("serve_packed", "serve_chunked"):
        kw = runs[name][1]
        xeng = ServeEngine(xcfg, packed, max_batch=8, device=dev, **kw)
        t0 = time.perf_counter()
        xout = xeng.serve(prompts, max_new_tokens=budgets)
        torch.cuda.synchronize()
        print(f"serve: plain route (gemm_impl='xla') {kw}: "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        out = outs[name]
        same, total, split = _split_rows(out, xout)
        last_logits = _logits_fn(torch, dev, xeng)
        gaps = _split_gaps(torch, last_logits, xcfg, prompts, out, xout,
                           split)
        run_ok = all(g <= 2 * tol for g in gaps)
        tok_ok = tok_ok and run_ok
        splits = [[i, j, g] for (i, j), g in zip(split, gaps)]
        print(f"serve: greedy tokens of {name}, kernel vs plain route: "
              f"{same}/{total} equal; rows that split (row, step, "
              f"plain-route gap): {splits} (excused where gap <= 2 x logit "
              f"tol = {2 * tol:.4e}) {'ok' if run_ok else 'FAIL'}")
        report["serve"][name].update(token_agreement=[same, total],
                                     token_splits=splits)
    report["serve"]["paged_equal"] = paged_ok
    return counts, ok and paged_ok and tok_ok


def _serve_requests(torch, cfg):
    """The serve and sample phases' 24 requests: prompts of 16-512 tokens
    (one over 256) and budgets of 8-64 tokens, from seed 3."""
    rng = torch.Generator().manual_seed(3)
    lens = torch.randint(16, 513, (24,), generator=rng).tolist()
    lens[5] = max(lens[5], 300)            # at least one prompt over 256
    budgets = torch.randint(8, 65, (24,), generator=rng).tolist()
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in lens]
    return prompts, budgets


# ---------------------------------------------------------------------------
# phase 6: sampled and speculative serving at full width
# ---------------------------------------------------------------------------

def _sampling_params(torch, report, lg):
    """Per-request SamplingParams from the spread of this model's logits at
    the prompts' last positions (``lg``, plain route; the median over the
    prompts of the standard deviation over the vocabulary): temperatures
    of SAMPLE_T_SPREAD times it, so the Gumbel noise decides tokens
    (requests 0 and 12 stay at temperature 0); repetition, presence and
    frequency penalties on some requests."""
    from repro_torch.serve.sampling import SamplingParams
    spread = statistics.median(lg.std(dim=-1).tolist())
    top2 = lg.topk(2, dim=-1).values
    gap = statistics.median((top2[:, 0] - top2[:, 1]).tolist())
    n = len(SAMPLE_T_SPREAD)
    sp = [SamplingParams(
        temperature=0.0 if i % 12 == 0 else spread * SAMPLE_T_SPREAD[i % n],
        seed=i * 7919 + 1,
        repetition_penalty=1.1 if i % 3 == 1 else 1.0,
        presence_penalty=0.5 * spread if i % 5 == 2 else 0.0,
        frequency_penalty=0.25 * spread if i % 7 == 3 else 0.0)
        for i in range(lg.shape[0])]
    print(f"sample: logits at the prompts' last positions: spread (median "
          f"std over the vocabulary) {spread:.4e}, median top-2 gap "
          f"{gap:.4e}; temperatures "
          f"{[round(p.temperature, 3) for p in sp]}")
    report["sample"].update(logit_spread=spread, median_gap=gap,
                            temperatures=[p.temperature for p in sp])
    return sp


def _verify_vs_decode(torch, dev, engine, cfg, contexts, k=2):
    """Logits of the speculative verify head (``verify_step`` over k+1
    candidates, the head at M 8(k+1)) at its first candidate against the
    decode head's (``decode_step``, M 8) for the same token on the same
    prefilled contiguous cache, kernel route: [B, V] each."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import registry
    b = len(contexts)
    width = max(len(t) for t in contexts)
    toks = torch.zeros((b, width), dtype=torch.int32)
    for i, t in enumerate(contexts):
        toks[i, width - len(t):] = torch.tensor(t)
    start = torch.tensor([width - len(t) for t in contexts],
                         dtype=torch.int32, device=dev)
    page = max(cfg.kv_page_size, 1)
    smax = -(-(width + k + 1) // page) * page

    def head(h):
        return dispatch.matmul(h.float().contiguous(), engine.head, cfg=cfg,
                               gemv=True)
    out = []
    for verify in (False, True):
        cache = registry.init_cache(cfg, b, smax, device=dev)
        h, cache = registry.prefill(engine.params, cfg, toks.to(dev), cache,
                                    start=start)
        nxt = head(h[:, -1]).argmax(-1).to(torch.int32)
        if verify:
            vt = nxt[:, None].expand(b, k + 1).contiguous()
            hv, _ = registry.verify_step(engine.params, cfg, vt, cache)
            out.append(head(hv.reshape(b * (k + 1), -1)).reshape(
                b, k + 1, -1)[:, 0])
        else:
            hd, _ = registry.decode_step(engine.params, cfg, nxt, cache)
            out.append(head(hd[:, -1]))
    return out


def _sample_split_gaps(torch, dev, last_logits, xcfg, prompts, sp, out,
                       xout, split, tol):
    """For each split of a sampled stream: (the plain route's score gap
    between the two routes' tokens, recomputed on the shared context with
    the request's history, seed and ordinal; the excuse bound 2 x logit
    tol x max(rep, 1) / T). inf where one route stopped early."""
    from repro_torch.kernels.sample import sample_scores
    from repro_torch.serve.sampling import pack_params
    res = []
    if not split:
        return res
    ctx = [prompts[i] + out[i][:j] for i, j in split]
    lg = torch.cat([last_logits(xcfg, ctx[a:a + 8])
                    for a in range(0, len(ctx), 8)])
    v = lg.shape[-1]
    for row, (i, j) in enumerate(split):
        p = sp[i]
        t = p.temperature if p.temperature > 0 else 1.0
        bound = 2 * tol * max(p.repetition_penalty, 1.0) / t
        if j >= min(len(out[i]), len(xout[i])):
            res.append((float("inf"), bound))
            continue
        counts = torch.zeros((1, v), dtype=torch.int32, device=dev)
        for tok in out[i][:j]:
            counts[0, tok] += 1
        knob = torch.tensor([[p.temperature, p.repetition_penalty,
                              p.presence_penalty, p.frequency_penalty]],
                            device=dev)
        seed = pack_params(p, dev)[1][1].reshape(1, 1)
        sc = sample_scores(lg[row:row + 1], counts, knob[:, :1],
                           knob[:, 1:2], knob[:, 2:3], knob[:, 3:4], seed,
                           torch.tensor([[j]], device=dev),
                           torch.arange(v, device=dev)[None, :])
        res.append((abs((sc[0, xout[i][j]] - sc[0, out[i][j]]).item()),
                    bound))
    return res


def _sample_phase(torch, dev, report, out_dir):
    """Sampled and speculative serve at full width. At olmo-1b's init
    scales the tied head's logits reach ~2000 and every depth ranks them
    alike, so a half-depth draft always agrees with the full model; this
    phase's weights therefore scale the embedding by SAMPLE_EMBED_SCALE and
    the layers by SAMPLE_LAYER_GAIN before packing (as the CPU tests'
    fixture does, there x3), so that the layers move the logits with
    depth. The greedy token may still echo the prompt's last token (the
    phase prints on how many rows). The greedy baseline is served on the
    same weights."""
    from repro_torch.configs import get_config
    from repro_torch.core.dbb_linear import iter_leaves, pack_tree
    from repro_torch.core.sparsity import apply_dbb_to_tree
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.models import registry
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sampling import SamplingParams

    cfg = get_config("olmo-1b").replace(remat="none", gemm_impl="pallas",
                                        kv_page_size=64)
    xcfg = cfg.replace(gemm_impl="xla")
    prompts, budgets = _serve_requests(torch, cfg)
    params = registry.init_params(cfg, seed=0, device=dev)
    params["embed"]["table"] *= SAMPLE_EMBED_SCALE
    for leaf in iter_leaves(params["layers"]):
        leaf *= SAMPLE_LAYER_GAIN
    packed = pack_tree(apply_dbb_to_tree(params, cfg.dbb,
                                         straight_through=False), cfg.dbb)
    del params
    report["sample"] = {}
    engine = ServeEngine(cfg, packed, max_batch=8, paged=False, device=dev)
    engine.serve(prompts[:2], max_new_tokens=4)          # warm-up
    t0 = time.perf_counter()
    greedy = engine.serve(prompts, max_new_tokens=budgets)
    torch.cuda.synchronize()
    print(f"sample: weights with the embedding x {SAMPLE_EMBED_SCALE:g} and "
          f"the layers x {SAMPLE_LAYER_GAIN:g} (seed 0, packed); greedy "
          f"serve (the baseline, packed, contiguous) "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    last_logits = _logits_fn(torch, dev, engine)
    lg = {name: torch.cat([last_logits(c, prompts[a:a + 8])
                           for a in range(0, len(prompts), 8)])
          for name, c in (("kernel", cfg), ("plain", xcfg),
                          ("plain_f32", xcfg.replace(dtype="float32")))}
    vd = [torch.cat(x) for x in zip(*(
        _verify_vs_decode(torch, dev, engine, cfg, prompts[a:a + 8])
        for a in range(0, len(prompts), 8)))]
    scale = lg["plain"].abs().max().item()
    tol = SAMPLE_LOGIT_TOL * scale
    readings = {
        "kernel_vs_plain": (lg["kernel"] - lg["plain"]).abs().max().item(),
        "verify_vs_decode": (vd[1] - vd[0]).abs().max().item(),
        "bf16_vs_f32_control": (lg["plain"] - lg["plain_f32"]).abs().max()
        .item()}
    echo = sum(int(lg["plain"][i].argmax()) == p[-1]
               for i, p in enumerate(prompts))
    ok = max(readings["kernel_vs_plain"], readings["verify_vs_decode"]) <= tol
    print(f"sample: max |logit| {scale:.4e} (plain route, prefill last "
          f"positions of the 24 prompts); max abs diff of max, kernel vs "
          f"plain route {readings['kernel_vs_plain'] / scale:.3e}, verify "
          f"head (M24) vs decode head (M8) on the same context "
          f"{readings['verify_vs_decode'] / scale:.3e} (tol "
          f"{SAMPLE_LOGIT_TOL:g} of max) {'ok' if ok else 'FAIL'}; control: "
          f"the plain route at bf16 vs f32 activations "
          f"{readings['bf16_vs_f32_control'] / scale:.3e}; the greedy token "
          f"echoes the prompt's last token on {echo}/24 rows")
    report["sample"].update(logit_scale=scale, echo_rows=echo,
                            **{k: v / scale for k, v in readings.items()})
    sp = _sampling_params(torch, report, lg["plain"])
    t0_sp = [SamplingParams() for _ in prompts]
    runs = (("sample_packed", dict(paged=False), sp, 0),
            ("sample_paged", dict(paged=True), sp, 0),
            ("spec_packed", dict(paged=False), sp, 2),
            ("spec_paged", dict(paged=True), sp, 2),
            ("spec_t0", dict(paged=False), t0_sp, 2))
    for dk in (0, 2):                      # warm-up: two short requests
        ServeEngine(cfg, packed, max_batch=8, device=dev).serve(
            prompts[:2], max_new_tokens=4, sampling=sp[:2], draft_k=dk)
    torch.cuda.synchronize()
    outs, counts = {}, {}
    card = report["card"]
    for name, kw, sparams, dk in runs:
        eng = ServeEngine(cfg, packed, max_batch=8, device=dev, **kw)
        reset_launches()
        t0 = time.perf_counter()
        outs[name] = eng.serve(prompts, max_new_tokens=budgets,
                               sampling=sparams, draft_k=dk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = dict(LAUNCHES)
        stats = {k: v for k, v in eng.serve_stats.items() if k != "ttft_s"}
        # the route table: one fused head per prefill call and, without
        # speculation, per decode step (the draft and verify heads take
        # sta_gemm_skinny and the plain sampler)
        want = stats["prefill_calls"] + (0 if dk else eng.last_decode_steps)
        got = counts[name]["head_sample_fused"]
        missing = [k for k in (SPEC_KERNELS if dk else SAMPLE_KERNELS)
                   if counts[name][k] == 0]
        # without speculation no greedy head runs: sta_gemm_skinny idles
        stray = 0 if dk else counts[name]["sta_gemm_skinny"]
        run_ok = got == want and not missing and not stray
        n_tok = sum(len(o) for o in outs[name])
        line = (f"sample: {name} {kw} draft_k={dk}: {wall * 1e3:.1f} ms, "
                f"{n_tok} tokens, {n_tok / wall:.1f} generated tokens/s "
                f"({card}); head_sample_fused launches {got} (route table: "
                f"{stats['prefill_calls']} prefill calls + "
                f"{0 if dk else eng.last_decode_steps} sampled decode steps "
                f"= {want})")
        rec = dict(wall_ms=wall * 1e3, tokens=n_tok, stats=stats,
                   launches=counts[name], predicted_head_sample=want)
        if dk:
            rate = (stats["spec_emitted"] / stats["spec_steps"] - 1) / dk
            rec["acceptance_rate"] = rate
            line += (f"; {stats['spec_steps']} speculative row-steps emitted "
                     f"{stats['spec_emitted']} tokens: acceptance rate "
                     f"{rate:.4f}")
            if name != "spec_t0" and not 0 < rate < 1:
                run_ok = False
                line += " FAIL (not strictly between 0 and 1)"
        if missing:
            line += f"; FAIL: never launched {missing}"
        if stray:
            line += f"; FAIL: sta_gemm_skinny launched {stray} times"
        if got != want:
            line += "; FAIL: head_sample_fused launches off the route table"
        print(line + f"; launches {counts[name]}")
        ok = ok and run_ok
        report["sample"][name] = rec
        if name == "sample_packed" and out_dir:
            _profile(torch, lambda: eng.serve(prompts,
                                              max_new_tokens=budgets,
                                              sampling=sp),
                     "sampled serve(24 requests, packed, contiguous)",
                     "profile_sample", out_dir, report)
    for a, b in (("sample_packed", "sample_paged"),
                 ("spec_packed", "spec_paged")):
        same = outs[a] == outs[b]
        ok = ok and same
        print(f"sample: {b} vs {a} token streams "
              f"{'equal' if same else 'DIFFERENT'}")

    # the noise decides tokens: sampled streams against the greedy one
    hot = [i for i, p in enumerate(sp) if p.temperature > 0]
    for name in ("sample_packed", "spec_packed"):
        pairs = [(a, b) for i in hot
                 for a, b in zip(outs[name][i], greedy[i])]
        share = sum(a != b for a, b in pairs) / max(len(pairs), 1)
        rows = sum(outs[name][i] != greedy[i] for i in hot)
        print(f"sample: {name}: {100 * share:.2f}% of {len(pairs)} sampled "
              f"tokens (T > 0 requests, position by position) differ from "
              f"the greedy stream; {rows}/{len(hot)} streams differ"
              + ("" if share > 0 else " FAIL"))
        ok = ok and share > 0
        report["sample"][name]["differs_from_greedy"] = share

    # (a) against the plain route's sampled serve
    xeng = ServeEngine(xcfg, packed, max_batch=8, paged=False, device=dev)
    t0 = time.perf_counter()
    xout = xeng.serve(prompts, max_new_tokens=budgets, sampling=sp)
    torch.cuda.synchronize()
    out = outs["sample_packed"]
    same, total, split = _split_rows(out, xout)
    gaps = _sample_split_gaps(torch, dev, last_logits, xcfg, prompts, sp,
                              out, xout, split, tol)
    run_ok = all(g <= bound for g, bound in gaps)
    ok = ok and run_ok
    print(f"sample: plain route (gemm_impl='xla') sampled serve "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms; sample_packed vs the "
          f"plain route: {same}/{total} tokens equal; rows that split (row, "
          f"step, plain-route score gap, excuse bound): "
          f"{[(i, j, g, bd) for (i, j), (g, bd) in zip(split, gaps)]} "
          f"{'ok' if run_ok else 'FAIL'}")
    report["sample"]["plain_route_agreement"] = [same, total]

    # (d) speculative at temperature 0 against the greedy serve stream: the
    # verify head's drift from the decode head was held to tol above
    out = outs["spec_t0"]
    same, total, split = _split_rows(out, greedy)
    gaps = _split_gaps(torch, last_logits, xcfg, prompts, out, greedy, split)
    run_ok = all(g <= 2 * tol for g in gaps)
    ok = ok and run_ok
    print(f"sample: spec_t0 (draft_k=2, temperature 0) vs greedy serve: "
          f"{same}/{total} tokens equal; rows that split (row, step, "
          f"plain-route gap): {[(i, j, g) for (i, j), g in zip(split, gaps)]}"
          f" (excused where gap <= 2 x logit tol = {2 * tol:.4e}) "
          f"{'ok' if run_ok else 'FAIL'}")
    report["sample"]["spec_t0_vs_greedy"] = [same, total]
    return counts, ok


# ---------------------------------------------------------------------------
# phase 7: the paper's CNN at full width
# ---------------------------------------------------------------------------

# (label, arch, matmul, batch, the launches the route table implies; convnet's
# conv1 and conv2 (f32, C 64 / 128, N 128 / 256) on conv_gemm_dbb's
# tensor-core body, by conv_gemm.ops.tc_body, or, dense under "sta", on
# conv_gemm's (conv_gemm_tc); convnet's conv0 (C 3, 3x3, N 64) and lenet's
# conv1 (C 6, 5x5, N 16) on conv_gemm's small-C body, by
# conv_gemm.ops.small_body)
CNN_RUNS = (
    ("cnn_a_convnet_dbb_b256", "convnet-dbb", "dbb", 256,
     {"conv_gemm": 1, "conv_gemm_small": 1, "conv_gemm_dbb": 2,
      "conv_gemm_dbb_tc": 2, "dbb_gemm": 1, "dbb_gemm_narrow": 1}),
    ("cnn_b_convnet_sta_b256", "convnet-dbb", "sta", 256,
     {"conv_gemm": 3, "conv_gemm_small": 1, "conv_gemm_tc": 2}),
    ("cnn_c_convnet_dbb_b1", "convnet-dbb", "dbb", 1,
     {"conv_gemm": 1, "conv_gemm_small": 1, "conv_gemm_dbb": 2,
      "conv_gemm_dbb_tc": 2, "dbb_gemm_skinny": 1,
      "dbb_gemm_skinny_split": 1}),
    # lenet's conv0 (N = 6) and, at batch 256, its K = 784 classifier take
    # the plain routes, as in the reference's cost model
    ("cnn_d_lenet5_dbb_b256", "lenet5-dbb", "dbb", 256,
     {"conv_gemm": 1, "conv_gemm_small": 1}),
)


def _cnn_phase(torch, dev, report, out_dir):
    from repro_torch.configs import get_config
    from repro_torch.core.dbb_linear import pack_tree
    from repro_torch.core.sparsity import apply_dbb_to_tree
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.models import cnn, registry

    counts, ok = {}, True
    report["cnn"] = {}
    for label, arch, mode, batch, expect in CNN_RUNS:
        cfg = get_config(arch)
        params = registry.init_params(cfg, seed=0, device=dev)
        if mode == "dbb":
            params = pack_tree(apply_dbb_to_tree(
                params, cfg.dbb, straight_through=False), cfg.dbb)
        gen = torch.Generator(device=dev).manual_seed(batch)
        images = torch.randn(batch, cfg.cnn_img, cfg.cnn_img, cfg.cnn_in_ch,
                             generator=gen, device=dev)

        def run():
            return cnn.cnn_apply(params, cfg, images, matmul=mode)
        run()                                           # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        logits = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts[label] = dict(LAUNCHES)
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        want = {k: expect.get(k, 0) for k in LAUNCHES}
        launch_ok = counts[label] == want
        # the plain route: explicit im2col convs, plain classifier matmul
        plain_cfg = cfg.replace(kernel_routes=(("matmul", "xla"),))
        plain = cnn.cnn_apply(params, plain_cfg, images, matmul=mode,
                              use_kernel=False)
        scale = plain.abs().max().item()
        tol = CNN_LOGIT_TOL * scale
        diff = (logits - plain).abs().max().item()
        top2 = plain.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > tol
        same = bool((logits.argmax(-1) == plain.argmax(-1))[decided].all())
        finite = bool(torch.isfinite(logits).all())
        run_ok = (launch_ok and diff <= tol and same and finite
                  and tuple(logits.shape) == (batch, cfg.cnn_classes))
        ok = ok and run_ok
        print(f"cnn: {label} ({arch} full width, matmul={mode!r}, batch "
              f"{batch}): logits vs plain route max abs diff {diff:.3e} of "
              f"max |logit| {scale:.3e} (tol {CNN_LOGIT_TOL:g} of max), "
              f"classes equal on {int(decided.sum())}/{batch} decided rows: "
              f"{'ok' if run_ok else 'FAIL'}; launches "
              f"{ {k: v for k, v in counts[label].items() if v} } (want "
              f"{expect}{'' if launch_ok else ', FAIL'})")
        print(f"cnn: {label} wall time of one forward after a warm-up "
              f"{wall_ms:.3f} ms; median of 10 more "
              f"{statistics.median(walls):.3f} ms")
        report["cnn"][label] = dict(
            wall_ms=wall_ms, median_wall_ms=statistics.median(walls),
            logit_max_abs_diff=diff, logit_scale=scale,
            launches=counts[label], ok=run_ok)
        if out_dir and label.startswith("cnn_a"):
            _profile(torch, lambda: [run() for _ in range(20)],
                     f"{label}: 20 forwards", "profile_cnn", out_dir, report)
    return counts, ok


# ---------------------------------------------------------------------------
# phase 8: dense weights at full width
# ---------------------------------------------------------------------------

def _dense_phase(torch, dev, report):
    from repro_torch.configs import get_config
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.models import registry
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("olmo-1b").replace(remat="none", gemm_impl="pallas")
    xcfg = cfg.replace(gemm_impl="xla")
    params = registry.init_params(cfg, seed=0, device=dev)
    engine = ServeEngine(cfg, params, max_batch=8, device=dev)
    gen = torch.Generator().manual_seed(1)
    lens = [64, 57, 50, 43, 36, 29, 22, 15]
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in lens]
    new = 64
    engine.generate(prompts, max_new_tokens=8)          # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    missing = [k for k in DENSE_KERNELS if counts[k] == 0]
    dbb = {k: v for k, v in counts.items() if k.startswith("dbb") and v}
    n_tok = sum(len(o) for o in out)
    print(f"dense: olmo-1b full width, unpacked weights: generate 8 prompts "
          f"(lengths {lens}), max_new_tokens {new}: {t_total * 1e3:.1f} ms, "
          f"{n_tok / t_total:.1f} generated tokens/s; launches {counts}"
          + (f"; FAIL: never launched {missing}" if missing else "")
          + (f"; FAIL: DBB kernels launched {dbb}" if dbb else ""))
    last_logits = _logits_fn(torch, dev, engine)
    lk, lp = last_logits(cfg, prompts), last_logits(xcfg, prompts)
    scale = lp.abs().max().item()
    tol = LOGIT_TOL * scale
    diff = (lk - lp).abs().max().item()
    lok = diff <= tol
    print(f"dense: prefill last-position logits, kernel vs plain route: max "
          f"abs diff {diff:.4e} of max |logit| {scale:.4e} (tol "
          f"{LOGIT_TOL:g} of max) {'ok' if lok else 'FAIL'}")
    xout = ServeEngine(xcfg, params, max_batch=8,
                       device=dev).generate(prompts, max_new_tokens=new)
    same, total, split = _split_rows(out, xout)
    gaps = _split_gaps(torch, last_logits, xcfg, prompts, out, xout, split)
    tok_ok = all(g <= 2 * tol for g in gaps)
    print(f"dense: greedy tokens, kernel vs plain route: {same}/{total} "
          f"equal; rows that split (row, step, plain-route gap): "
          f"{[(i, j, g) for (i, j), g in zip(split, gaps)]} (excused where "
          f"gap <= 2 x logit tol = {2 * tol:.4e}) "
          f"{'ok' if tok_ok else 'FAIL'}")
    report["dense"] = dict(total_ms=t_total * 1e3, tokens=n_tok,
                           launches=counts, logit_max_abs_diff=diff,
                           logit_scale=scale, token_agreement=[same, total])
    return counts, not missing and not dbb and lok and tok_ok


# ---------------------------------------------------------------------------
# phase 9: w4 and INT8-valued weights at full width
# ---------------------------------------------------------------------------

def _quant_run(torch, cfg, label, run, plane):
    """One main-path run on a quantized tree: launch counts reset before
    and read after; every layer GEMM must take the format's kernels (7 per
    layer per forward: the M-tiled kernel in prefill, the skinny one in
    decode; a packed prefill of at most 32 tokens takes the skinny one
    too) and no other DBB kernel may launch."""
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    reset_launches()
    t0 = time.perf_counter()
    out, eng = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    steps = eng.last_decode_steps
    prefills = eng.serve_stats.get("prefill_calls", 1)
    per_pass = 7 * cfg.num_layers
    big, skinny = counts["dbb_gemm" + plane], counts["dbb_gemm_skinny" + plane]
    other = {k: v for k, v in counts.items()    # the bodies' counts: main()
             if k.startswith("dbb")
             and not k.endswith((plane, "_tc", "_split", "_narrow")) and v}
    need = ("sta_gemm_skinny", "paged_decode")
    missing = [k for k in need if counts[k] == 0]
    exact = (big + skinny == per_pass * (prefills + steps)
             and skinny >= per_pass * steps and big > 0)
    ok = exact and not other and not missing
    n_tok = sum(len(o) for o in out)
    print(f"{label}: {wall * 1e3:.1f} ms, {n_tok} tokens, "
          f"{n_tok / wall:.1f} generated tokens/s, {steps} decode steps, "
          f"{prefills} prefill calls; launches {counts}; dbb_gemm{plane} "
          f"{big} + dbb_gemm_skinny{plane} {skinny} == {per_pass} x "
          f"({prefills} + {steps}) {'ok' if exact else 'FAIL'}"
          + (f"; FAIL: other DBB kernels launched {other}" if other else "")
          + (f"; FAIL: never launched {missing}" if missing else ""))
    return out, counts, wall, steps, ok


def _quant_phase(torch, dev, report, out_dir):
    """olmo-1b at full width, DBB-projected from seed 0, packed as w4
    (G 128) — generate and serve (a) — and with INT8 values
    (``pack_tree(quantize=True)``) — generate — each held against the plain
    route: prefill logits within LOGIT_TOL of max |logit|, greedy tokens
    under the near-tie excuse. The w4 weights are the same bits on both
    routes; the INT8 plane's kernel takes q exactly and applies the
    per-channel scale in its epilogue while the plain route rounds q·s to
    bf16, one bf16 rounding of each weight, of the order of the bf16
    rounding of activations the tolerance covers — the plain route at f32
    activations (q·s unrounded) is printed as the control."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.dbb import DbbWeight
    from repro_torch.core.dbb_linear import (iter_leaves, pack_tree,
                                             tree_footprint_bytes)
    from repro_torch.core.sparsity import apply_dbb_to_tree
    from repro_torch.models import registry
    from repro_torch.serve.engine import ServeEngine

    base = get_config("olmo-1b").replace(remat="none", gemm_impl="pallas")
    w4cfg = base.replace(dbb=dataclasses.replace(
        base.dbb, weight_bits=4, quant_group=W4_GROUP))
    t0 = time.perf_counter()
    proj = apply_dbb_to_tree(registry.init_params(base, seed=0, device=dev),
                             base.dbb, straight_through=False)
    torch.cuda.synchronize()
    t_proj = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(1)
    lens = [64, 57, 50, 43, 36, 29, 22, 15]
    prompts = [torch.randint(2, base.vocab_size, (n,), generator=gen).tolist()
               for n in lens]
    new = 64
    counts, ok = {}, True
    report["quant"] = {}
    for fmt, cfg, quantize, plane in (("w4", w4cfg, False, "_w4"),
                                      ("int8", base, True, "_i8")):
        xcfg = cfg.replace(gemm_impl="xla")
        t0 = time.perf_counter()
        packed = pack_tree(proj, cfg.dbb, quantize=quantize)
        torch.cuda.synchronize()
        t_pack = time.perf_counter() - t0
        leaves = [x for x in iter_leaves(packed) if isinstance(x, DbbWeight)]
        packed_bytes = tree_footprint_bytes(dict(enumerate(leaves)))
        dense_elems = sum(x.bitmask.numel() * x.block for x in leaves)
        ratio = packed_bytes / dense_elems
        total = tree_footprint_bytes(packed)
        f32_plane = report["slice"]["footprint_bytes"]
        bits = {(x.bits, str(x.values.dtype)) for x in leaves}
        print(f"quant {fmt}: init + project {t_proj:.1f} s (shared), pack "
              f"{t_pack:.1f} s; {len(leaves)} packed leaves {sorted(bits)}; "
              f"tree {total / 1e9:.3f} GB (f32-plane tree "
              f"{f32_plane / 1e9:.3f} GB); packed layer weights "
              f"{packed_bytes / 1e9:.4f} GB = {ratio:.5f} of their dense "
              f"INT8 bytes, weight_footprint_ratio "
              f"{cfg.dbb.weight_footprint_ratio:.5f}")
        rep = report["quant"][fmt] = dict(
            pack_s=t_pack, tree_bytes=total, layer_bytes=packed_bytes,
            ratio=ratio, weight_footprint_ratio=cfg.dbb.weight_footprint_ratio)
        engine = ServeEngine(cfg, packed, max_batch=8, device=dev)
        engine.generate(prompts, max_new_tokens=8)           # warm-up
        torch.cuda.synchronize()
        out, c, wall, steps, run_ok = _quant_run(
            torch, cfg, f"quant {fmt}: generate 8 prompts, "
            f"max_new_tokens {new}",
            lambda: (engine.generate(prompts, max_new_tokens=new), engine),
            plane)
        counts[f"{fmt}_generate"] = c
        t0 = time.perf_counter()
        engine.generate(prompts, max_new_tokens=1)
        torch.cuda.synchronize()
        decode_ms = (wall - (time.perf_counter() - t0)) / max(steps, 1) * 1e3
        print(f"quant {fmt}: decode estimate {decode_ms:.3f} ms/step (the "
              f"generate wall minus a max_new_tokens=1 call, over {steps} "
              f"steps)")
        last_logits = _logits_fn(torch, dev, engine)
        lk, lp = last_logits(cfg, prompts), last_logits(xcfg, prompts)
        lf = last_logits(xcfg.replace(dtype="float32"), prompts)
        scale = lp.abs().max().item()
        tol = LOGIT_TOL * scale
        diff = (lk - lp).abs().max().item()
        lok = diff <= tol
        print(f"quant {fmt}: prefill last-position logits, kernel vs plain "
              f"route: max abs diff {diff:.4e} of max |logit| {scale:.4e} "
              f"(tol {LOGIT_TOL:g} of max) {'ok' if lok else 'FAIL'}; "
              f"control, against the plain route at f32 activations: kernel "
              f"{(lk - lf).abs().max().item():.4e}, plain "
              f"{(lp - lf).abs().max().item():.4e}")
        xout = ServeEngine(xcfg, packed, max_batch=8,
                           device=dev).generate(prompts, max_new_tokens=new)
        same, tot, split = _split_rows(out, xout)
        gaps = _split_gaps(torch, last_logits, xcfg, prompts, out, xout,
                           split)
        tok_ok = all(g <= 2 * tol for g in gaps)
        print(f"quant {fmt}: greedy tokens, kernel vs plain route: "
              f"{same}/{tot} equal; rows that split (row, step, plain-route "
              f"gap): {[(i, j, g) for (i, j), g in zip(split, gaps)]} "
              f"(excused where gap <= 2 x logit tol = {2 * tol:.4e}) "
              f"{'ok' if tok_ok else 'FAIL'}")
        rep.update(generate_ms=wall * 1e3, decode_ms_per_step=decode_ms,
                   tokens=sum(map(len, out)), launches=c,
                   logit_max_abs_diff=diff, logit_scale=scale,
                   token_agreement=[same, tot])
        ok = ok and run_ok and lok and tok_ok
        if fmt == "w4":
            ok = _quant_serve(torch, dev, report, cfg, packed, counts,
                              out_dir) and ok
        del engine, packed
    return counts, ok


def _quant_serve(torch, dev, report, cfg, packed, counts, out_dir):
    """serve (a) on the w4 tree: the serve phase's 24 requests, packed
    prefill into the contiguous cache, against the plain route's serve."""
    from repro_torch.serve.engine import ServeEngine
    cfg = cfg.replace(kv_page_size=64)
    xcfg = cfg.replace(gemm_impl="xla")
    prompts, budgets = _serve_requests(torch, cfg)
    eng = ServeEngine(cfg, packed, max_batch=8, device=dev, paged=False)
    eng.serve(prompts[:2], max_new_tokens=4)                 # warm-up
    torch.cuda.synchronize()
    out, c, wall, _, ok = _quant_run(
        torch, cfg, "quant w4: serve (a) 24 requests, packed, "
        "contiguous", lambda: (eng.serve(prompts, max_new_tokens=budgets),
                               eng), "_w4")
    counts["w4_serve_packed"] = c
    ttft = sorted(eng.serve_stats["ttft_s"])
    print(f"quant w4: serve (a) ttft median {ttft[len(ttft) // 2] * 1e3:.1f}"
          f" ms, p90 {ttft[int(0.9 * (len(ttft) - 1))] * 1e3:.1f} ms")
    if out_dir:
        _profile(torch, lambda: eng.serve(prompts, max_new_tokens=budgets),
                 "w4 serve(24 requests, packed, contiguous)",
                 "profile_serve_w4", out_dir, report)
    xeng = ServeEngine(xcfg, packed, max_batch=8, device=dev, paged=False)
    xout = xeng.serve(prompts, max_new_tokens=budgets)
    same, tot, split = _split_rows(out, xout)
    tol = LOGIT_TOL * report["quant"]["w4"]["logit_scale"]
    gaps = _split_gaps(torch, _logits_fn(torch, dev, xeng), xcfg, prompts,
                       out, xout, split)
    tok_ok = all(g <= 2 * tol for g in gaps)
    print(f"quant w4: serve (a) greedy tokens, kernel vs plain route: "
          f"{same}/{tot} equal; rows that split (row, step, plain-route "
          f"gap): {[(i, j, g) for (i, j), g in zip(split, gaps)]} (excused "
          f"where gap <= 2 x logit tol = {2 * tol:.4e}) "
          f"{'ok' if tok_ok else 'FAIL'}")
    report["quant"]["w4_serve_packed"] = dict(
        wall_ms=wall * 1e3, tokens=sum(map(len, out)), launches=c,
        token_agreement=[same, tot])
    return ok and tok_ok


# ---------------------------------------------------------------------------
# phase 10: smoke-width token equality
# ---------------------------------------------------------------------------

def _token_phase(torch, dev, report):
    from repro_torch.configs import get_config
    from repro_torch.core.dbb_linear import iter_leaves, pack_tree
    from repro_torch.core.sparsity import apply_dbb_to_tree
    from repro_torch.models import registry
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sampling import SamplingParams

    cfg = get_config("olmo-1b", smoke=True).replace(
        remat="none", gemm_impl="pallas")
    params = registry.init_params(cfg, seed=0, device=dev)
    # a weaker embedding and stronger layers make the greedy tokens depend
    # on the layers (random tied weights otherwise echo the last token)
    params["embed"]["table"] *= 0.1
    for leaf in iter_leaves(params["layers"]):
        leaf *= 3.0
    packed = pack_tree(apply_dbb_to_tree(params, cfg.dbb,
                                         straight_through=False), cfg.dbb)
    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (12, 7, 12, 3, 9, 12, 5, 1)]
    sp = [SamplingParams(temperature=1.0, seed=i,
                         repetition_penalty=1.2 if i % 2 else 1.0)
          for i in range(len(prompts))]
    outs = {}
    for name, c in (("kernel", cfg), ("plain", cfg.replace(gemm_impl="xla"))):
        eng = ServeEngine(c, packed, max_batch=8, device=dev)
        outs[name] = eng.generate(prompts, max_new_tokens=20)
        outs[name + "_sampled"] = eng.generate(prompts, max_new_tokens=20,
                                               sampling=sp)
    ok = outs["kernel"] == outs["plain"]
    sok = outs["kernel_sampled"] == outs["plain_sampled"]
    moved = sum(a != b for a, b in zip(outs["kernel"],
                                       outs["kernel_sampled"]))
    distinct = len({t for row in outs["plain"] for t in row})
    print(f"tokens: smoke width f32, kernel route vs plain route: greedy "
          f"{'equal' if ok else 'DIFFERENT'} ({distinct} distinct tokens); "
          f"sampled (T = 1) {'equal' if sok else 'DIFFERENT'} "
          f"({moved}/8 rows differ from greedy)")
    report["tokens_equal"] = ok and sok
    return ok and sok


# ---------------------------------------------------------------------------
# phase 12: the rest of the dense_lm family at full width
# ---------------------------------------------------------------------------

# (arch, layers run: None for all; why a depth is cut). Widths are never cut.
HALF_DEPTH = ("the cli phase runs every layer; half the depth here keeps "
              "the script near 12 minutes beside the train phase")
FAMILY_MODELS = (
    ("starcoder2-15b", 20, HALF_DEPTH),
    ("qwen2.5-14b", 24, HALF_DEPTH),
    ("yi-34b", 8, "the 60-layer f32 planes (~71 GB) with the embedding and "
     "head leave no room for caches on 80 GB; 8, not 16, to keep the "
     "phase's time"))
FAMILY_LENS = [64, 57, 50, 43, 36, 29, 22, 15]
FAMILY_NEW = 32
# one prompt past starcoder2's 4096-token window (5 x attn_chunk, so the
# plain route's prefill takes attn_chunked)
FAMILY_LONG, FAMILY_LONG_NEW = 5120, 16
FAMILY_SERVE_BUDGETS = [16, 24, 8, 32, 12, 20, 28, 16]
FAMILY_DENSE_LAYERS = 8
# the kernels each family path must launch
FAMILY_SAMPLE_KERNELS = ("flash_prefill", "dbb_gemm", "dbb_gemm_skinny",
                         "paged_decode", "head_sample_fused")


def _family_noise(tree, gen):
    """The family phase's ``layer_hook`` for
    `registry.init_params_by_layer`: norm scales 1 + 0.2 N(0, 1), norm and
    QKV biases 0.2 N(0, 1), drawn from the layer's own generator after its
    weights, so every parameter moves the result."""
    import torch
    from repro_torch.core.sparsity import map_with_path

    def visit(path, leaf):
        key = path.rsplit("/", 1)[-1]
        if key in ("scale", "bias", "b"):
            noise = 0.2 * torch.randn(leaf.shape, generator=gen,
                                      device=leaf.device)
            return noise + (1.0 if key == "scale" else 0.0)
        return leaf
    return map_with_path(visit, tree)


def _family_prompts(torch, cfg):
    """The generate prompts (8 of 64-15 tokens) and the long prompt."""
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in FAMILY_LENS]
    long = torch.randint(2, cfg.vocab_size, (FAMILY_LONG,),
                         generator=torch.Generator().manual_seed(2)).tolist()
    return prompts, long


def _family_generate(torch, dev, tag, cfg, tree, prompts, new, need, rec,
                     sampling=None):
    """One ``generate`` on the kernel route, the launch counts reset just
    before and read just after, and a ``max_new_tokens=1`` call for the
    decode estimate: (tokens, counts, engine, ok)."""
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.serve.engine import ServeEngine
    engine = ServeEngine(cfg, tree, max_batch=len(prompts), device=dev)
    kw = {} if sampling is None else dict(sampling=sampling)
    engine.generate(prompts, max_new_tokens=2, **kw)      # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=new, **kw)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    steps = engine.last_decode_steps
    t0 = time.perf_counter()
    engine.generate(prompts, max_new_tokens=1, **kw)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    decode_ms = (t_total - t_prefill) / max(steps, 1) * 1e3
    n_tok = sum(len(o) for o in out)
    missing = [k for k in need if counts[k] == 0]
    print(f"family: {tag}: generate {len(prompts)} prompts (lengths "
          f"{[len(p) for p in prompts]}), max_new_tokens {new}"
          f"{' sampled' if sampling else ''}: {t_total * 1e3:.1f} ms; prefill "
          f"{t_prefill * 1e3:.1f} ms (a max_new_tokens=1 call); decode "
          f"{decode_ms:.3f} ms/step over {steps} steps; "
          f"{n_tok / t_total:.1f} generated tokens/s; launches "
          f"{ {k: v for k, v in counts.items() if v} }"
          + (f"; FAIL: never launched {missing}" if missing else ""))
    rec.update(total_ms=t_total * 1e3, prefill_ms=t_prefill * 1e3,
               decode_ms_per_step=decode_ms, steps=steps, tokens=n_tok,
               tokens_per_s=n_tok / t_total, launches=counts)
    return out, counts, engine, not missing


def _family_vs_plain(torch, dev, tag, cfg, engine, prompts, out, new, rec,
                     sampling=None):
    """The kernel route's prefill last-position logits and tokens against
    the plain route's (gemm_impl="xla") on the same tree, under the slice
    phase's rules: logits within LOGIT_TOL of max |logit|, a split of the
    greedy (or sampled) streams excused only where the plain route's gap
    (score gap), recomputed on the shared context, is within twice that."""
    from repro_torch.serve.engine import ServeEngine
    xcfg = cfg.replace(gemm_impl="xla")
    last_logits = _logits_fn(torch, dev, engine)
    lk, lp = last_logits(cfg, prompts), last_logits(xcfg, prompts)
    scale = lp.abs().max().item()
    tol = LOGIT_TOL * scale
    diff = (lk - lp).abs().max().item()
    lok = diff <= tol
    kw = {} if sampling is None else dict(sampling=sampling)
    t0 = time.perf_counter()
    xout = ServeEngine(xcfg, engine.params, max_batch=len(prompts),
                       device=dev).generate(prompts, max_new_tokens=new,
                                            **kw)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    same, total, split = _split_rows(out, xout)
    if sampling is None:
        gaps = _split_gaps(torch, last_logits, xcfg, prompts, out, xout,
                           split)
        bounds = [2 * tol] * len(gaps)
    else:
        res = _sample_split_gaps(torch, dev, last_logits, xcfg, prompts,
                                 sampling, out, xout, split, tol)
        gaps, bounds = [g for g, _ in res], [b for _, b in res]
    tok_ok = all(g <= b for g, b in zip(gaps, bounds))
    print(f"family: {tag}: prefill last-position logits, kernel vs plain "
          f"route: max abs diff {diff:.4e} of max |logit| {scale:.4e} ("
          f"{diff / scale:.3e} of max; tol {LOGIT_TOL:g}) "
          f"{'ok' if lok else 'FAIL'}; tokens {same}/{total} equal; rows "
          f"that split (row, step, plain-route gap, bound): "
          f"{[(i, j, g, b) for (i, j), g, b in zip(split, gaps, bounds)]} "
          f"{'ok' if tok_ok else 'FAIL'}; plain-route generate "
          f"{t_plain * 1e3:.1f} ms")
    rec.update(logit_max_abs_diff=diff, logit_scale=scale,
               logit_diff_of_max=diff / scale, token_agreement=[same, total],
               token_splits=[[i, j, g] for (i, j), g in zip(split, gaps)])
    return lok and tok_ok, xout, last_logits


def _family_serve(torch, dev, tag, cfg, tree, prompts, long, xlong,
                  last_logits, rec, out_dir, report):
    """``serve`` of the generate prompts with the long one in place of the
    longest (packed prefill) on the contiguous cache and on the paged
    pool: every kernel of the path launched, equal streams on the two
    caches, and the long request's stream against the plain route's
    ``generate`` of it under the split rule."""
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.serve.engine import ServeEngine
    reqs = [long] + prompts[1:]
    scfg = cfg.replace(kv_page_size=64)
    outs, counts, ok = {}, {}, True
    for paged in (False, True):
        name = f"serve_{'paged' if paged else 'packed'}"
        eng = ServeEngine(scfg, tree, max_batch=8, paged=paged, device=dev)
        eng.serve(prompts[:2], max_new_tokens=2)            # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        outs[name] = eng.serve(reqs, max_new_tokens=FAMILY_SERVE_BUDGETS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = dict(LAUNCHES)
        ttft = sorted(eng.serve_stats["ttft_s"])
        n_tok = sum(len(o) for o in outs[name])
        missing = [k for k in SERVE_KERNELS if counts[name][k] == 0]
        ok = ok and not missing
        print(f"family: {tag}: {name}: 8 requests (one of {len(long)} "
              f"tokens), budgets {FAMILY_SERVE_BUDGETS}: {wall * 1e3:.1f} "
              f"ms, {n_tok / wall:.1f} generated tokens/s; ttft median "
              f"{ttft[len(ttft) // 2] * 1e3:.1f} ms, max "
              f"{ttft[-1] * 1e3:.1f} ms; launches "
              f"{ {k: v for k, v in counts[name].items() if v} }"
              + (f"; FAIL: never launched {missing}" if missing else ""))
        rec[name] = dict(wall_ms=wall * 1e3, tokens=n_tok,
                         ttft_median_ms=ttft[len(ttft) // 2] * 1e3,
                         launches=counts[name])
        if name == "serve_packed" and out_dir:
            _profile(torch, lambda: eng.serve(
                reqs, max_new_tokens=FAMILY_SERVE_BUDGETS),
                f"{tag} serve(8 requests, packed, contiguous)",
                f"profile_family_{tag.split('-')[0]}_serve", out_dir, report)
        del eng
    same = outs["serve_packed"] == outs["serve_paged"]
    xcfg = cfg.replace(gemm_impl="xla")
    got = [outs["serve_packed"][0]]
    want = [xlong[0][:len(got[0])]]
    s_same, s_total, split = _split_rows(got, want)
    gaps = _split_gaps(torch, last_logits, xcfg, [long], got, want, split)
    tol = LOGIT_TOL * rec["generate"]["logit_scale"]
    long_ok = all(g <= 2 * tol for g in gaps)
    print(f"family: {tag}: serve streams, paged vs contiguous "
          f"{'equal' if same else 'DIFFERENT'}; the long request's stream "
          f"vs the plain route's generate: {s_same}/{s_total} equal, "
          f"splits {[(j, g) for (_, j), g in zip(split, gaps)]} "
          f"{'ok' if long_ok else 'FAIL'}")
    rec["serve_paged_equal"] = same
    return counts, ok and same and long_ok


def _family_model(torch, dev, report, arch, layers, why, out_dir):
    """One model of the family phase (see the module doc, phase 12)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.core.dbb_linear import tree_footprint_bytes
    from repro_torch.models import registry
    from repro_torch.serve.sampling import SamplingParams
    t_model = time.perf_counter()
    full = get_config(arch)
    cfg = full.replace(remat="none", gemm_impl="pallas")
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    tag = arch
    qwen = arch.startswith("qwen")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree = registry.init_params_by_layer(cfg, seed=len(arch), device=dev,
                                         pack=True, layer_hook=_family_noise)
    outer = {k: v for k, v in tree.items() if k != "layers"}
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    packed_bytes = tree_footprint_bytes(tree["layers"])
    all_bytes = tree_footprint_bytes(tree)
    peak = torch.cuda.max_memory_allocated()
    cut = (f"{cfg.num_layers} of {full.num_layers} layers (cut: {why})"
           if layers is not None else f"all {cfg.num_layers} layers")
    print(f"family: {tag}: {cut}, d {cfg.d_model}, {cfg.num_heads} heads "
          f"over {cfg.num_kv_heads} KV heads of {cfg.resolved_head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.norm}, "
          f"{'gated ' if cfg.mlp_gated else ''}{cfg.act}, qkv_bias "
          f"{cfg.qkv_bias}, window {cfg.sliding_window}, {cfg.dtype} "
          f"activations, f32 DBB planes k {cfg.dbb.nnz} of "
          f"{cfg.dbb.block}; built layer by layer in {t_build:.1f} s; "
          f"packed layers "
          f"{packed_bytes / 1e9:.3f} GB, whole tree {all_bytes / 1e9:.3f} "
          f"GB; peak device memory of the build "
          f"{peak / 1e9:.3f} GB ({report['card']})")
    rec = {"layers": cfg.num_layers, "build_s": t_build,
           "packed_layer_bytes": packed_bytes, "tree_bytes": all_bytes,
           "build_peak_bytes": peak}
    report["family"][arch] = rec
    prompts, long = _family_prompts(torch, cfg)
    by_path, ok = {}, True
    short = arch.split("-")[0].split(".")[0]

    rec["generate"] = {}
    out, counts, engine, run_ok = _family_generate(
        torch, dev, tag, cfg, tree, prompts, FAMILY_NEW, GENERATE_KERNELS,
        rec["generate"])
    by_path[f"family_{short}_generate"] = counts
    cmp_ok, _, last_logits = _family_vs_plain(
        torch, dev, tag, cfg, engine, prompts, out, FAMILY_NEW,
        rec["generate"])
    ok = ok and run_ok and cmp_ok

    if arch.startswith("starcoder2"):
        rec["long"] = {}
        lout, counts, leng, run_ok = _family_generate(
            torch, dev, tag + " long", cfg, tree, [long], FAMILY_LONG_NEW,
            GENERATE_KERNELS, rec["long"])
        by_path[f"family_{short}_long"] = counts
        cmp_ok, xlong, llogits = _family_vs_plain(
            torch, dev, tag + " long", cfg, leng, [long], lout,
            FAMILY_LONG_NEW, rec["long"])
        ok = ok and run_ok and cmp_ok
        del leng
        counts, run_ok = _family_serve(torch, dev, tag, cfg, tree, prompts,
                                       long, xlong, llogits, rec, out_dir,
                                       report)
        by_path.update({f"family_{short}_{k}": v for k, v in counts.items()})
        ok = ok and run_ok

    if qwen:
        lg = last_logits(cfg.replace(gemm_impl="xla"), prompts)
        spread = statistics.median(lg.std(dim=-1).tolist())
        n = len(SAMPLE_T_SPREAD)
        sp = [SamplingParams(
            temperature=0.0 if i == 0 else spread * SAMPLE_T_SPREAD[i % n],
            seed=i * 7919 + 1,
            repetition_penalty=1.1 if i % 3 == 1 else 1.0)
            for i in range(len(prompts))]
        print(f"family: {tag}: sampled generate: logit spread {spread:.4e}; "
              f"temperatures {[round(p.temperature, 3) for p in sp]}")
        rec["sample"] = {}
        sout, counts, seng, run_ok = _family_generate(
            torch, dev, tag, cfg, tree, prompts, FAMILY_NEW,
            FAMILY_SAMPLE_KERNELS, rec["sample"], sampling=sp)
        by_path[f"family_{short}_sample"] = counts
        want = 1 + rec["sample"]["steps"]
        heads_ok = (counts["head_sample_fused"] == want
                    and counts["sta_gemm_skinny"] == 0)
        moved = sum(a != b for i in range(1, len(sp))
                    for a, b in zip(sout[i], out[i]))
        print(f"family: {tag}: head_sample_fused launches "
              f"{counts['head_sample_fused']} (route table: 1 prefill + "
              f"{want - 1} decode steps = {want}), "
              f"sta_gemm_skinny {counts['sta_gemm_skinny']} "
              f"{'ok' if heads_ok else 'FAIL'}; {moved} sampled tokens "
              f"differ from the greedy stream"
              + ("" if moved else " FAIL"))
        cmp_ok, _, _ = _family_vs_plain(
            torch, dev, tag + " sampled", cfg, seng, prompts, sout,
            FAMILY_NEW, rec["sample"], sampling=sp)
        ok = ok and run_ok and heads_ok and moved > 0 and cmp_ok
        del seng

        dcfg = cfg.replace(num_layers=FAMILY_DENSE_LAYERS)
        dtree = registry.init_params_by_layer(
            dcfg, seed=len(arch) + 1, device=dev, layer_hook=_family_noise,
            outer=outer)
        rec["dense"] = {}
        dout, counts, deng, run_ok = _family_generate(
            torch, dev, f"{tag} dense {FAMILY_DENSE_LAYERS} layers", dcfg,
            dtree, prompts, FAMILY_NEW, DENSE_KERNELS, rec["dense"])
        by_path[f"family_{short}_dense"] = counts
        dbb = {k: v for k, v in counts.items() if k.startswith("dbb") and v}
        if dbb:
            print(f"family: {tag} dense: FAIL: DBB kernels launched {dbb}")
        cmp_ok, _, _ = _family_vs_plain(
            torch, dev, f"{tag} dense", dcfg, deng, prompts, dout,
            FAMILY_NEW, rec["dense"])
        ok = ok and run_ok and not dbb and cmp_ok
        del deng, dtree

    del engine, tree, outer
    gc.collect()
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["phase_s"] = time.perf_counter() - t_model
    print(f"family: {tag}: peak device memory of the model's runs "
          f"{rec['peak_bytes'] / 1e9:.3f} GB; {rec['phase_s']:.1f} s")
    return by_path, ok


def _family_phase(torch, dev, report, out_dir):
    report["family"] = {}
    by_path, ok = {}, True
    for arch, layers, why in FAMILY_MODELS:
        counts, model_ok = _family_model(torch, dev, report, arch, layers,
                                         why, out_dir)
        by_path.update(counts)
        ok = ok and model_ok
    return by_path, ok


# ---------------------------------------------------------------------------
# phase 13: the serve CLI at full width and depth
# ---------------------------------------------------------------------------

# (path, CLI arguments, kernels the run must launch beyond its tables')
CLI_RUNS = (
    ("cli_olmo_serve",
     "--arch olmo-1b --full --packed --gemm-impl pallas --batch 8 "
     "--requests 24 --prompt-len 128 --max-new 32", SERVE_KERNELS),
    ("cli_starcoder2_generate",
     "--arch starcoder2-15b --full --packed --gemm-impl pallas --batch 8 "
     "--prompt-len 64 --max-new 16", GENERATE_KERNELS),
    ("cli_qwen_paged_sampled_serve",
     "--arch qwen2.5-14b --full --packed --gemm-impl pallas --batch 8 "
     "--requests 16 --kv-page-size 64 --temperature 0.8 --prompt-len 64 "
     "--max-new 16", SAMPLE_KERNELS),
    ("cli_yi_w4_generate",
     "--arch yi-34b --full --packed --weight-bits 4 --gemm-impl pallas "
     "--batch 8 --prompt-len 64 --max-new 16",
     ("dbb_gemm_w4", "dbb_gemm_skinny_w4", "sta_gemm_skinny",
      "paged_decode", "flash_prefill")),
)
# the kernels each table route launches (plain routes launch none)
ROUTE_KERNELS = {
    "skinny_dbb": ("dbb_gemm_skinny", "dbb_gemm_skinny_i8"),
    "skinny_dbb_w4": ("dbb_gemm_skinny_w4",),
    "dbb_packed": ("dbb_gemm", "dbb_gemm_i8"),
    "dbb_packed_w4": ("dbb_gemm_w4",),
    "skinny_sta": ("sta_gemm_skinny",), "sta": ("sta_gemm",),
    "attn_flash": ("flash_prefill",),
    "attn_packed_flash": ("flash_prefill_packed",),
    "attn_decode_flash": ("paged_decode",),
    "head_sample_fused": ("head_sample_fused",),
}


def _cli_phase(torch, dev, report):
    """``repro_torch.launch.serve.main`` in process on each of CLI_RUNS
    (see the module doc, phase 13)."""
    import gc

    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.launch import serve
    report["cli"] = {}
    by_path, ok = {}, True
    for path, argv, need in CLI_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rep = {}
        reset_launches()
        t0 = time.perf_counter()
        rc = serve.main(argv.split(), report=rep)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        by_path[path] = counts
        cfg = rep["cfg"]
        missing = [f"{dom} {r}" for dom, r in rep["routes"].items()
                   if r in ROUTE_KERNELS
                   and not sum(counts[k] for k in ROUTE_KERNELS[r])]
        missing += [k for k in need if counts[k] == 0]
        run_ok = rc == 0 and not missing
        if cfg.dbb.weight_bits == 4:
            stray = {k: v for k, v in counts.items() if v and k in (
                "dbb_gemm", "dbb_gemm_skinny", "dbb_gemm_i8",
                "dbb_gemm_skinny_i8")}
            if stray:
                print(f"cli: {path}: FAIL: non-w4 DBB kernels launched "
                      f"{stray}")
                run_ok = False
        n_tok = sum(len(o) for o in rep["outs"])
        rec = {"argv": argv, "layers": cfg.num_layers,
               "build_s": rep["build_s"], "tree_bytes": rep["tree_bytes"],
               "peak_bytes": peak, "wall_s": wall,
               "engine_wall_s": rep["wall_s"], "tokens": n_tok,
               "routes": rep["routes"],
               "launches": {k: v for k, v in counts.items() if v}}
        print(f"cli: {path}: {cfg.name} {cfg.num_layers} layers: tables "
              f"chose {rep['routes']}; launches {rec['launches']}; "
              f"{'ok' if run_ok else 'FAIL: no launch of ' + str(missing)}")
        print(f"cli: {path}: build {rep['build_s']:.1f} s, tree "
              f"{rep['tree_bytes'] / 1e9:.3f} GB, peak device memory "
              f"{peak / 1e9:.3f} GB, wall {wall:.1f} s ({n_tok} tokens in "
              f"{rep['wall_s']:.2f} s of engine time) ({report['card']})")
        if cfg.name == "yi-34b":
            last_logits = _logits_fn(torch, dev, rep["engine"])
            lk = last_logits(cfg, rep["prompts"])
            lp = last_logits(cfg.replace(gemm_impl="xla"), rep["prompts"])
            scale = lp.abs().max().item()
            diff = (lk - lp).abs().max().item()
            lok = diff <= LOGIT_TOL * scale
            print(f"cli: {path}: prefill last-position logits, kernel vs "
                  f"plain route on the w4 tree: max abs diff {diff:.4e} of "
                  f"max |logit| {scale:.4e} ({diff / scale:.3e} of max; tol "
                  f"{LOGIT_TOL:g}) {'ok' if lok else 'FAIL'}")
            rec.update(logit_max_abs_diff=diff, logit_scale=scale)
            run_ok = run_ok and lok
        report["cli"][path] = rec
        ok = ok and run_ok
        del rep
    gc.collect()
    torch.cuda.empty_cache()
    return by_path, ok


# ---------------------------------------------------------------------------
# phase 14: the paper's pipeline — DBB-annealed training, then the trained
# models through the kernels
# ---------------------------------------------------------------------------

TRAIN_CNN_STEPS = 60             # Table I runs: the reference's benchmark
                                 # default (at 200 every run reaches 1.0)
TRAIN_CNN_NNZ = (None, 2, 3, 4)  # dense, then DBB k = 2 / 3 / 4 of 8
# the run resumes from its --checkpoint-every checkpoint
TRAIN_LM_ARGV = ("--arch olmo-1b --full --steps 200 --seq-len 256 --batch 8 "
                 "--dbb-ramp 50 --checkpoint-every 150")
TRAIN_RESUME_RTOL = 1e-3         # resumed vs uninterrupted losses
TRAIN_CE_RTOL = 5e-3             # f32 planes' held-out CE vs the plain route
# kernel vs plain prefill logits of the trained olmo-1b, of max |logit|: its
# logits reach ~230 and differ by ~1.2e-3 of that, within what bf16
# activations alone move them (the plain route at f32 activations, printed)
TRAIN_LOGIT_TOL = 2e-3
TRAIN_HELD_OUT = 100_000         # stream steps no training run reads
TRAIN_NEW = 32                   # greedy / speculative tokens per prompt


def _train_phase(torch, dev, report):
    """The paper's pipeline (module doc, phase 14): Table I on the card,
    olmo-1b trained at full width through the training CLI, the trained
    models through the kernels, and the area model's tables."""
    report["train"] = {}
    counts = {}
    ok, cnn_paths = _train_table1(torch, dev, report, counts)
    ok = _train_olmo(torch, dev, report, counts) and ok
    _area_tables()
    return counts, cnn_paths, ok


def _int8_tree(torch, proj, cfg):
    """A trained CNN's INT8 planes for the INT8 chain: the packable leaves
    `pack_tree(quantize=True)`, every other conv / fc weight
    `quantize_weight` (dense INT8)."""
    from repro_torch.core.dbb_linear import pack_tree
    from repro_torch.core.quant import quantize_weight
    tree = pack_tree(proj, cfg.dbb, quantize=True)
    for name, p in tree.items():
        if name.startswith("conv") and isinstance(p["w"], torch.Tensor):
            tree[name] = dict(p, w=quantize_weight(p["w"]))
    return tree


def _argmax_agreement(torch, got, plain, tol_rel):
    """(rows whose class differs outside near-ties, excused rows): a row is
    a near tie where the plain logits' top-2 margin is within ``tol_rel``
    of max |logit|."""
    tol = tol_rel * plain.abs().max().item()
    top2 = plain.topk(2, dim=-1).values
    tie = (top2[:, 0] - top2[:, 1]) <= tol
    differ = got.argmax(-1) != plain.argmax(-1)
    return int((differ & ~tie).sum()), int(tie.sum())


def _train_table1(torch, dev, report, counts):
    """(a) lenet5-dbb and convnet-dbb at their published sizes: dense and
    DBB k 2 / 3 / 4 (apply_to conv), TRAIN_CNN_STEPS steps of
    `train_loop` at the reference's Table I ratios (lr 3e-3, prune start
    and ramp each a third of the steps, batch 64). Each run: no kernel
    launch while training, finite losses, the last logged loss below the
    first; held-out accuracy (4 batches of 64 at steps 100000+i) through
    `make_eval_step` (the plain route); each DBB model packed as f32 and as
    INT8 planes and run through ``cnn_apply(matmul="dbb")`` on the kernels
    (exact launch counts as the cnn phase's B256 runs) and the INT8 planes
    through the INT8 chain, each held against the plain route's classes
    outside near-ties."""
    import math

    from repro_torch.config import DbbConfig, RunConfig, ShapeSpec, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core.dbb_linear import pack_tree
    from repro_torch.core.sparsity import apply_dbb_to_tree
    from repro_torch.data.pipeline import SyntheticCNN
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.launch.train import train_loop
    from repro_torch.models import cnn
    from repro_torch.train.loop import make_eval_step

    steps = TRAIN_CNN_STEPS
    ok, paths, rows = True, [], []
    expect = {"lenet5-dbb": CNN_RUNS[3][4], "convnet-dbb": CNN_RUNS[0][4]}
    for arch in ("lenet5-dbb", "convnet-dbb"):
        base = get_config(arch)
        held = SyntheticCNN(base, 64, seed=0)
        batches = [{k: torch.from_numpy(v).to(dev)
                    for k, v in held.batch_at(TRAIN_HELD_OUT + i).items()}
                   for i in range(4)]
        images = torch.cat([b["images"] for b in batches])
        labels = torch.cat([b["labels"] for b in batches]).long()
        dense_acc = None
        for nnz in TRAIN_CNN_NNZ:
            dbb = (DbbConfig(enabled=False) if nnz is None else
                   DbbConfig(enabled=True, block=8, nnz=nnz,
                             apply_to=("conv",)))
            cfg = base.replace(dbb=dbb)
            rc = RunConfig(model=cfg, train=TrainConfig(
                steps=steps, learning_rate=3e-3, log_every=steps // 10,
                seed=0, dbb_prune_start=steps // 3,
                dbb_prune_ramp=steps // 3))
            reset_launches()
            t0 = time.perf_counter()
            state, hist = train_loop(rc, ShapeSpec("t", 16, 64, "train"),
                                     log=lambda *_: None, device=dev)
            torch.cuda.synchronize()
            t_train = time.perf_counter() - t0
            stray = {k: v for k, v in LAUNCHES.items() if v}
            losses = [h["loss"] for h in hist]
            train_ok = (not stray and all(map(math.isfinite, losses))
                        and losses[-1] < losses[0])
            ev = make_eval_step(rc, nnz=nnz)
            acc = statistics.mean(float(ev(state.params, b)["acc"])
                                  for b in batches)
            tag = "dense" if nnz is None else f"k{nnz}"
            line = (f"train: {arch} {tag}: {steps} steps in {t_train:.1f} s "
                    f"({t_train / steps * 1e3:.2f} ms a step), loss "
                    f"{losses[0]:.4f} -> {losses[-1]:.4f}, nnz "
                    f"{hist[-1]['nnz']}, kernel launches while training "
                    f"{stray or 0}; held-out acc (plain route) {acc:.4f}")
            rec = dict(steps=steps, train_s=t_train, losses=losses, acc=acc)
            if nnz is None:
                dense_acc = acc
                print(line + (" ok" if train_ok else " FAIL"))
                ok = ok and train_ok
                report["train"][f"{arch}_{tag}"] = rec
                continue
            with torch.no_grad():
                proj = apply_dbb_to_tree(state.params, cfg.dbb,
                                         straight_through=False)
                plain = cnn.cnn_apply(proj, cfg, images)
                path = f"train_{arch}_{tag}_dbb_b256"
                reset_launches()
                logits = cnn.cnn_apply(pack_tree(proj, cfg.dbb), cfg, images,
                                       matmul="dbb")
                torch.cuda.synchronize()
                counts[path] = dict(LAUNCHES)
                i8 = _int8_tree(torch, proj, cfg)
                path_i8 = f"train_{arch}_{tag}_int8_b256"
                reset_launches()
                li8 = _int8_cnn_forward(torch, i8, cfg, images, True)
                torch.cuda.synchronize()
                counts[path_i8] = dict(LAUNCHES)
                pi8 = _int8_cnn_forward(torch, i8, cfg, images, False)
            paths += [path, path_i8]
            want = {k: expect[arch].get(k, 0) for k in LAUNCHES}
            launch_ok = counts[path] == want
            s8 = {k: v for k, v in counts[path_i8].items() if v}
            s8_ok = bool(s8) and all("_s8" in k for k in s8)
            bad, ties = _argmax_agreement(torch, logits, plain,
                                          CNN_LOGIT_TOL)
            bad8, ties8 = _argmax_agreement(torch, li8, pi8, CNN_LOGIT_TOL)
            k_acc = float((logits.argmax(-1) == labels).float().mean())
            i8_acc = float((li8.argmax(-1) == labels).float().mean())
            run_ok = (train_ok and launch_ok and s8_ok and not bad
                      and not bad8 and bool(torch.isfinite(logits).all())
                      and bool(torch.isfinite(li8).all()))
            ok = ok and run_ok
            print(line + f"; kernel route (f32 planes, matmul='dbb') acc "
                  f"{k_acc:.4f}, classes vs plain route: {bad} differ "
                  f"outside near ties ({ties} rows excused, top-2 margin <= "
                  f"{CNN_LOGIT_TOL:g} of max); INT8 planes through the INT8 "
                  f"chain acc {i8_acc:.4f} ({bad8} differ, {ties8} excused; "
                  f"logits vs its plain route max abs diff "
                  f"{(li8 - pi8).abs().max().item():.3e}); launches "
                  f"{ {k: v for k, v in counts[path].items() if v} } (want "
                  f"{expect[arch]}{'' if launch_ok else ', FAIL'}), INT8 "
                  f"chain {s8}{'' if s8_ok else ' FAIL'} "
                  f"{'ok' if run_ok else 'FAIL'}")
            rec.update(kernel_acc=k_acc, int8_acc=i8_acc, excused=ties,
                       launches=counts[path], launches_int8=counts[path_i8])
            report["train"][f"{arch}_{tag}"] = rec
            rows.append((arch, f"{100 * nnz / 8:g}%", dense_acc, acc,
                         dense_acc - acc, k_acc, i8_acc))
    print(f"train: Table I on the card ({report['card']}; {steps} steps, "
          "held-out accuracy on 256 images; DBB acc on the plain route, "
          "kernel acc on the f32 planes, INT8 acc through the INT8 chain):")
    for arch, pct, d, a, delta, k_acc, i8 in rows:
        print(f"train: table1: {arch:12s} NNZ <= {pct:6s} dense {d:.4f} "
              f"dbb {a:.4f} delta {delta:+.4f} kernel {k_acc:.4f} "
              f"int8 {i8:.4f}")
    report["train"]["table1"] = rows
    return ok, paths


def _train_olmo(torch, dev, report, counts):
    """(b) olmo-1b at full width through ``repro_torch.launch.train.main``
    (TRAIN_LM_ARGV): every leaf's gradient on the first step finite and
    nonzero, no kernel launch during training, the loss falling; per-step
    ms, peak memory, the projection's time; then a resume from the
    ``--checkpoint-every`` checkpoint against the straight run's losses. (c)
    The
    trained masters projected at k 4 and packed as f32, INT8 and w4
    planes: held-out CE through ``registry.forward`` on the kernel route
    per plane beside the plain route; greedy generate of 8 held-out
    prompts against the plain route (TRAIN_LOGIT_TOL and the split rule);
    speculative serve (draft_k=2) at temperature 0 and 1 on both caches
    with the acceptance rate."""
    import gc

    from repro_torch.config import RunConfig, ShapeSpec
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import apply_dbb_to_tree, map_with_path
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.launch import train as train_cli
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.loop import (init_train_state, loss_and_grads,
                                        make_loss_fn)

    argv = TRAIN_LM_ARGV.split()
    seq, batch, resume_at = (int(argv[argv.index(f) + 1]) for f in (
        "--seq-len", "--batch", "--checkpoint-every"))
    cfg = get_config("olmo-1b")
    pipe = make_pipeline(cfg, ShapeSpec("cli", seq, batch, "train"), seed=0)

    def on_dev(b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    # the first step's gradients reach every leaf
    st0 = init_train_state(RunConfig(model=cfg), seed=0, device=dev)
    reset_launches()
    grads, _ = loss_and_grads(make_loss_fn(cfg, project_dbb=False),
                              st0.params, on_dev(pipe.batch_at(0)))
    norms = {}
    map_with_path(lambda p, g: norms.__setitem__(p, g.float().norm().item()),
                  grads)
    dead = [p for p, n in norms.items() if not 0 < n < float("inf")]
    grad_ok = not dead and not any(LAUNCHES.values())
    print(f"train: olmo-1b full width: first step's gradient norms on all "
          f"{len(norms)} leaves finite and nonzero (min "
          f"{min(norms.values()):.3e}, max {max(norms.values()):.3e})"
          + (f" FAIL: {dead}" if dead else " ok"))
    del st0, grads
    gc.collect()
    torch.cuda.empty_cache()

    ckdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "train_ckpt")
    shutil.rmtree(ckdir, ignore_errors=True)
    argv += ["--checkpoint-dir", ckdir]
    runs = {}
    for name in ("straight", "resumed"):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        rep, lines = {}, []
        t0 = time.perf_counter()
        train_cli.main(argv, log=lines.append, report=rep)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hist = rep["history"]
        # step 0 carries the first call's set-up
        dts = [h["dt"] for h in hist if h["step"] > 0]
        runs[name] = dict(
            wall_s=wall, peak_bytes=torch.cuda.max_memory_allocated(),
            launches={k: v for k, v in LAUNCHES.items() if v},
            losses={h["step"]: h["loss"] for h in hist},
            step_ms=1e3 * statistics.median(dts),
            first_line=lines[0], steps=len(hist), state=rep["state"])
        r = runs[name]
        print(f"train: olmo-1b {name}: `python -m repro_torch.launch.train "
              f"{' '.join(argv[:-2])} --checkpoint-dir <build/train_ckpt>` "
              f"in process: {r['first_line']}; wall {wall:.1f} s, median "
              f"logged step {r['step_ms']:.1f} ms, peak device memory "
              f"{r['peak_bytes'] / 1e9:.3f} GB, kernel launches while "
              f"training {r['launches'] or 0} ({report['card']})")
        if name == "straight":
            saved = ckpt.available_steps(ckdir)
            print(f"train: checkpoints after the straight run: {saved}; "
                  f"resuming from step {resume_at}")
            shutil.rmtree(os.path.join(ckdir, f"step_{max(saved):09d}"))
            rep["state"].opt_state = None               # keep the masters
    shutil.rmtree(ckdir, ignore_errors=True)
    straight, resumed = runs["straight"], runs["resumed"]
    curve = sorted(straight["losses"].items())
    falls = curve[-1][1] < curve[0][1]
    common = sorted(set(resumed["losses"]) & set(straight["losses"]))
    spread = max(abs(resumed["losses"][s] - straight["losses"][s])
                 / straight["losses"][s] for s in common) if common else 1.0
    resume_ok = (bool(common) and min(common) == resume_at
                 and spread <= TRAIN_RESUME_RTOL)
    lm_ok = (grad_ok and falls and resume_ok and not straight["launches"]
             and not resumed["launches"])
    print(f"train: olmo-1b loss {curve[0][1]:.4f} (step {curve[0][0]}) -> "
          f"{curve[-1][1]:.4f} (step {curve[-1][0]}) "
          f"{'falls' if falls else 'FAIL: does not fall'}; resumed vs "
          f"straight losses at steps {common[0] if common else '-'}.."
          f"{common[-1] if common else '-'}: max relative difference "
          f"{spread:.3e} (tol {TRAIN_RESUME_RTOL:g}) "
          f"{'ok' if resume_ok else 'FAIL'}")

    masters = straight["state"].params
    del runs, straight["state"], resumed["state"]
    gc.collect()
    torch.cuda.empty_cache()
    with torch.no_grad():
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            proj = apply_dbb_to_tree(masters, cfg.dbb,
                                     straight_through=False)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    print(f"train: apply_dbb_to_tree over the {cfg.num_layers}-layer "
          f"masters (k {cfg.dbb.nnz}): {statistics.median(times):.1f} ms "
          f"(median of 3; a train step projects once)")
    report["train"]["olmo"] = dict(
        loss_curve=curve, step_ms=straight["step_ms"],
        peak_bytes=straight["peak_bytes"], wall_s=straight["wall_s"],
        resumed_wall_s=resumed["wall_s"], resume_spread=spread,
        project_ms=statistics.median(times))
    del masters
    gc.collect()
    return _train_olmo_kernels(torch, dev, report, counts, cfg, proj,
                               pipe) and lm_ok


def _train_olmo_kernels(torch, dev, report, counts, cfg, proj, pipe):
    """(c) of `_train_olmo`: the trained, projected olmo-1b through the
    kernels."""
    import dataclasses
    import gc
    import math

    from repro_torch.core.dbb_linear import pack_tree, tree_footprint_bytes
    from repro_torch.dist.collectives import cross_entropy
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.models import registry
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sampling import SamplingParams

    kcfg = cfg.replace(remat="none", gemm_impl="pallas")
    xcfg = kcfg.replace(gemm_impl="xla")
    w4 = dataclasses.replace(cfg.dbb, weight_bits=4, quant_group=W4_GROUP)
    planes = {"f32": ("", pack_tree(proj, cfg.dbb)),
              "int8": ("_i8", pack_tree(proj, cfg.dbb, quantize=True)),
              "w4": ("_w4", pack_tree(proj, w4))}
    held = [{k: torch.from_numpy(v).to(dev)
             for k, v in pipe.batch_at(TRAIN_HELD_OUT + i).items()}
            for i in range(2)]

    def held_out_ce(tree, c):
        with torch.no_grad():
            ces = []
            for b in held:
                h, _ = registry.forward(tree, c, b)
                ces.append(cross_entropy(h, registry.lm_head_weight(tree, c),
                                         b["labels"], b["loss_mask"]).item())
        return statistics.mean(ces)

    ok = True
    ce = {"plain": held_out_ce(proj, xcfg)}
    del proj
    gc.collect()
    for name, (suffix, tree) in planes.items():
        reset_launches()
        ce[name] = held_out_ce(tree, kcfg)
        torch.cuda.synchronize()
        path = f"train_olmo_ce_{name}"
        counts[path] = dict(LAUNCHES)
        need = ("dbb_gemm" + suffix, "flash_prefill")
        other = {k: v for k, v in counts[path].items() if v and k.startswith(
            "dbb") and not k.endswith((suffix, "_tc"))}
        run_ok = (all(counts[path][k] for k in need) and not other
                  and math.isfinite(ce[name]))
        ok = ok and run_ok
        print(f"train: olmo-1b held-out CE ({len(held)} batches of "
              f"{held[0]['tokens'].shape[0]} x {held[0]['tokens'].shape[1]} "
              f"at stream steps {TRAIN_HELD_OUT}+) on {name} planes "
              f"({tree_footprint_bytes(tree) / 1e9:.3f} GB), kernel route: "
              f"{ce[name]:.5f} (plain route on the projected f32 masters "
              f"{ce['plain']:.5f}, {ce[name] - ce['plain']:+.5f}); launches "
              f"{ {k: v for k, v in counts[path].items() if v} } "
              f"{'ok' if run_ok else 'FAIL'}")
    rel = abs(ce["f32"] - ce["plain"]) / ce["plain"]
    ce_ok = rel <= TRAIN_CE_RTOL
    ok = ok and ce_ok
    print(f"train: f32 planes' CE vs the plain route: {rel:.3e} relative "
          f"(tol {TRAIN_CE_RTOL:g}) {'ok' if ce_ok else 'FAIL'}")

    packed = planes["f32"][1]
    del planes
    gc.collect()
    toks = held[0]["tokens"].cpu()
    prompts = [toks[i, :n].tolist() for i, n in enumerate(FAMILY_LENS)]
    engine = ServeEngine(kcfg, packed, max_batch=8, paged=False, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=TRAIN_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["train_olmo_generate"] = dict(LAUNCHES)
    missing = [k for k in GENERATE_KERNELS
               if not counts["train_olmo_generate"][k]]
    last_logits = _logits_fn(torch, dev, engine)
    lk, lp = last_logits(kcfg, prompts), last_logits(xcfg, prompts)
    control = (last_logits(xcfg.replace(dtype="float32"), prompts)
               - lp).abs().max().item()
    scale = lp.abs().max().item()
    tol = TRAIN_LOGIT_TOL * scale
    diff = (lk - lp).abs().max().item()
    xout = ServeEngine(xcfg, packed, max_batch=8, paged=False,
                       device=dev).generate(prompts,
                                            max_new_tokens=TRAIN_NEW)
    same, total, split = _split_rows(out, xout)
    gaps = _split_gaps(torch, last_logits, xcfg, prompts, out, xout, split)
    gen_ok = not missing and diff <= tol and all(g <= 2 * tol for g in gaps)
    ok = ok and gen_ok
    print(f"train: trained olmo-1b greedy generate (f32 planes, 8 held-out "
          f"prompts of {FAMILY_LENS[-1]}-{FAMILY_LENS[0]} tokens, "
          f"{TRAIN_NEW} new): {wall * 1e3:.1f} ms; prefill logits vs plain "
          f"route max abs diff {diff:.4e} of max |logit| {scale:.4e} "
          f"({diff / scale:.3e} of max; tol {TRAIN_LOGIT_TOL:g}; control: "
          f"the plain route at bf16 vs f32 activations {control / scale:.3e})"
          f"; tokens {same}/{total} equal, splits (row, step, "
          f"plain-route gap) {[(i, j, g) for (i, j), g in zip(split, gaps)]}"
          f" (excused where gap <= {2 * tol:.4e}); launches "
          f"{ {k: v for k, v in counts['train_olmo_generate'].items() if v} }"
          + (f"; FAIL: never launched {missing}" if missing else "")
          + (" ok" if gen_ok else " FAIL"))

    spec, rates = {}, {}
    for temp in (0.0, 1.0):
        sp = [SamplingParams(temperature=temp, seed=i)
              for i in range(len(prompts))]
        for paged in (False, True):
            name = f"train_olmo_spec_t{temp:g}_{'paged' if paged else 'contig'}"
            eng = ServeEngine(kcfg.replace(kv_page_size=64), packed,
                              max_batch=8, paged=paged, device=dev)
            reset_launches()
            spec[name] = eng.serve(prompts, max_new_tokens=TRAIN_NEW,
                                   sampling=sp, draft_k=2)
            torch.cuda.synchronize()
            counts[name] = dict(LAUNCHES)
            stats = eng.serve_stats
            rates[name] = (stats["spec_emitted"] / stats["spec_steps"] - 1) / 2
            missing = [k for k in SPEC_KERNELS if not counts[name][k]]
            ok = ok and not missing and 0 <= rates[name] <= 1
            print(f"train: {name} (draft_k=2, temperature {temp:g}): "
                  f"{stats['spec_steps']} speculative row-steps emitted "
                  f"{stats['spec_emitted']} tokens: acceptance rate "
                  f"{rates[name]:.4f} (an earlier sample phase on random "
                  f"weights at sampled temperatures: 0.8452)"
                  + (f"; FAIL: never launched {missing}" if missing else ""))
        a, b = (spec[f"train_olmo_spec_t{temp:g}_{c}"]
                for c in ("contig", "paged"))
        ok = ok and a == b
        print(f"train: speculative streams at temperature {temp:g}, "
              f"contiguous vs paged cache: {'equal' if a == b else 'FAIL'}")
    same, total, split = _split_rows(spec["train_olmo_spec_t0_contig"], out)
    gaps = _split_gaps(torch, last_logits, xcfg, prompts,
                       spec["train_olmo_spec_t0_contig"], out, split)
    t0_ok = all(g <= 2 * tol for g in gaps)
    ok = ok and t0_ok
    print(f"train: speculative at temperature 0 vs greedy generate: "
          f"{same}/{total} tokens equal, splits "
          f"{[(i, j, g) for (i, j), g in zip(split, gaps)]} "
          f"{'ok' if t0_ok else 'FAIL'}")
    report["train"]["olmo"].update(
        held_out_ce=ce, ce_rel_f32=rel, logit_max_abs_diff=diff,
        logit_scale=scale, bf16_control=control,
        token_agreement=[same, total], acceptance=rates)
    return ok


def _area_tables():
    """The STA area model's Table II and Fig. 5 sweep (CPU arithmetic,
    printed for the record)."""
    from repro_torch.core import area_model
    for name, (area, power) in area_model.table2().items():
        paper = area_model.PAPER_TABLE2[name]
        print(f"train: table2: {name:14s} area eff {area:.3f} power eff "
              f"{power:.3f} (paper {paper[0]:.2f} / {paper[1]:.2f})")
    rows = area_model.fig5_sweep()
    print("train: fig5 (AxBxC: STA area / power, STA-DBB area / power, "
          "normalized to SA): " + "; ".join(
              f"{r['a']}x{r['b']}x{r['c']} {r['sta_area']:.3f}/"
              f"{r['sta_power']:.3f}"
              + (f" {r['dbb_area']:.3f}/{r['dbb_power']:.3f}"
                 if "dbb_area" in r else "") for r in rows))


# ---------------------------------------------------------------------------
# phase 15: the moe_lm family at full width
# ---------------------------------------------------------------------------

# (arch, experts run, layers run, why the cuts). Widths are never cut.
MOE_MODELS = (
    ("arctic-480b", 16, 8,
     "experts 128 -> 16, the reference's fused-expert ceiling "
     "(_FUSED_EXPERT_MAX; at 128 one layer's w4 planes take ~5.5 GB and "
     "its dense expand ~27 GB of bf16, and the batched expert route is "
     "kimi's run); layers 35 -> 8 keep the phase's time"),
    ("kimi-k2-1t-a32b", 32, 4,
     "experts 384 -> 32 (above 16, so the expert FFN takes the batched "
     "route, top-8 of 32); layers 61 -> 4 keep the phase's time"))
# generate: 8 prompts of one length (a left pad's row is unspecified on the
# flash route and still takes expert capacity, so a ragged batch's rows
# would not be comparable across the routes; serve's packed prefill has
# no such rows and takes the ragged requests)
MOE_PROMPTS, MOE_PROMPT_LEN, MOE_NEW = 8, 32, 16
MOE_SERVE_LENS = [96, 40, 72, 17, 55, 128, 33, 80, 64, 21]
MOE_SERVE_BUDGETS = [8, 16, 12, 10, 14, 9, 16, 11, 13, 8]
MOE_TIE_RTOL = 1e-3       # router near-tie: k-th vs (k+1)-th gate, relative
# one layer's moe_apply, kernel vs plain route, of max |y|: bf16 outputs of
# a chain of three bf16 GEMMs, where one bf16 step at the largest value is
# up to 2^-7 of it
MOE_LAYER_TOL = 2e-2
MOE_CLI_ARGV = ("--arch arctic-480b --packed --gemm-impl pallas --batch 4 "
                "--requests 7 --prompt-len 16 --max-new 8")
# the GEMM routes that launch a kernel on the expanded (dense) MoE layers
MOE_GEMM_KERNELS = {"sta": "sta_gemm", "skinny_sta": "sta_gemm_skinny"}


class _RouteRecorder:
    """Wraps ``repro_torch.models.moe._route`` (the package has no switch
    for this): each call records the tokens' top-k experts and the
    relative gap between their k-th and (k+1)-th gates, recomputed from
    the same f32 router product."""

    def __init__(self, torch):
        from repro_torch.models import moe
        self.torch, self.mod, self.real = torch, moe, moe._route
        self.calls = []

    def __enter__(self):
        self.calls = []
        self.mod._route = self._route
        return self

    def __exit__(self, *exc):
        self.mod._route = self.real

    def _route(self, x, w, cfg):
        out = self.real(x, w, cfg)
        torch = self.torch
        with torch.no_grad():
            gates = torch.softmax(x.float() @ w.float(), dim=-1)
            k = cfg.moe.top_k
            top = torch.topk(gates, k + 1, dim=-1).values
            gap = (top[:, k - 1] - top[:, k]) / top[:, k - 1]
        self.calls.append((out[0], gap))
        return out


def _moe_kept(torch, top_idx, e: int, cap: int):
    """Which (token, expert) pairs `_dispatch_compute_combine` keeps: the
    first ``cap`` of each expert in token order."""
    flat = top_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    se = flat[order]
    start = torch.searchsorted(se, torch.arange(e, device=flat.device))
    rank = torch.empty_like(flat)
    rank[order] = torch.arange(flat.numel(), device=flat.device) - start[se]
    return (rank < cap).reshape(top_idx.shape)


def _moe_route_diff(torch, cfg, kcalls, pcalls, rows_of):
    """Compare two runs' recorded routing call by call, in order: (rows
    with a router near-tie on either route, rows whose top-k or kept pairs
    differ in some call, the top-k set differences in rows whose routing
    had not yet differed that sit at no near-tie, as (call, row, kernel-route
    gap, plain-route gap) — where both routes saw the same inputs up to
    rounding, only a near-tie may flip). ``rows_of(i, T)`` gives call i's
    [T] row per token (-1: no real token of a row whose inputs still
    agree)."""
    from repro_torch.models import moe
    near, moved, bad = set(), set(), []
    e = cfg.moe.num_experts
    for i, ((ki, kg), (pi, pg)) in enumerate(zip(kcalls, pcalls)):
        # a token's expert set decides its output, not the set's order
        ki, pi = ki.sort(1).values, pi.sort(1).values
        t = ki.shape[0]
        rows = rows_of(i, t)
        real = rows >= 0
        cap = moe._capacity(t, cfg)
        tie = (kg < MOE_TIE_RTOL) | (pg < MOE_TIE_RTOL)
        flip = (ki != pi).any(1)
        kept = (_moe_kept(torch, ki, e, cap)
                != _moe_kept(torch, pi, e, cap)).any(1)
        fresh = torch.tensor([r not in moved for r in rows.tolist()],
                             device=rows.device)
        near.update(rows[tie & real].tolist())
        for tok in (flip & ~tie & real & fresh).nonzero()[:, 0].tolist():
            bad.append((i, int(rows[tok]), kg[tok].item(), pg[tok].item()))
        moved.update(rows[(flip | kept) & real].tolist())
    return near, moved, bad


def _moe_expected(torch, cfg, calls, heads, head_kernel, attn):
    """The launches a run's config implies, from its recorded MoE calls
    (one per layer and forward pass, each with its token count T): per
    call the experts' three GEMMs at M = capacity(T) each (E <= 16 on the
    kernel route; the batched products above it launch nothing) and the
    dense MLP's three at M = T, on the kernel the route table picks; plus
    ``heads`` head launches of ``head_kernel`` and the attention launches
    ``attn`` ({kernel: count}). The tensor-core counters follow their
    bodies' rules (`sta_gemm.ops.tc_body`, `attn.ops.tc_body`); no DBB
    kernel runs (the MoE layers run expanded)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attn.ops import tc_body as flash_tc
    from repro_torch.kernels.sta_gemm.ops import tc_body as gemm_tc
    from repro_torch.models import moe
    from repro_torch.models.common import dtype_of
    dt = dtype_of(cfg)
    want = dict(attn)
    if flash_tc(dt, cfg.resolved_head_dim):
        for k in ("flash_prefill", "flash_prefill_packed"):
            want[k + "_tc"] = want.get(k, 0)
    want[head_kernel] = want.get(head_kernel, 0) + heads
    d, f, df = cfg.d_model, cfg.d_ff, cfg.moe.dense_residual_ff
    fused = cfg.moe.num_experts <= moe._FUSED_EXPERT_MAX
    memo = {}

    def kernel(m, k, n, ops):
        key = (m, k, n, ops)
        if key not in memo:
            memo[key] = MOE_GEMM_KERNELS.get(dispatch.explain(
                "matmul", m=m, k=k, n=n, dtype=dt, cfg=cfg,
                epilogue_ops=ops)[0].name)
        return memo[key]

    for top_idx, _ in calls:
        t = top_idx.shape[0]
        gemms = [(t, d, df, 0), (t, d, df, 1), (t, df, d, 0)] if df else []
        if fused:
            c = moe._capacity(t, cfg)
            gemms += [(c, d, f, 0), (c, d, f, 1),
                      (c, f, d, 0)] * cfg.moe.num_experts
        for g in gemms:
            name = kernel(*g)
            if name:
                want[name] = want.get(name, 0) + 1
            if name == "sta_gemm" and gemm_tc(dt, g[1], g[2]):
                want["sta_gemm_tc"] = want.get("sta_gemm_tc", 0) + 1
    return {k: v for k, v in want.items() if v}


def _moe_check_launches(tag, counts, want):
    """Every kernel's launches against ``want`` (missing keys: zero)."""
    got = {k: v for k, v in counts.items() if v}
    ok = got == want
    print(f"moe: {tag}: launches {got}; expected from the config {want} "
          f"{'ok' if ok else 'FAIL'}")
    return ok


def _moe_generate(torch, dev, tag, cfg, tree, prompts, rec, run):
    """``generate`` on one route, the launch counts reset just before and
    read just after and the routing recorded, then a
    ``max_new_tokens=1`` call for the time to first token: (tokens,
    counts, routing calls, engine)."""
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.serve.engine import ServeEngine
    engine = ServeEngine(cfg, tree, max_batch=len(prompts), device=dev)
    engine.generate(prompts, max_new_tokens=2)                # warm-up
    torch.cuda.synchronize()
    engine.last_decode_steps = 0
    with _RouteRecorder(torch) as routes:
        reset_launches()
        t0 = time.perf_counter()
        out = engine.generate(prompts, max_new_tokens=MOE_NEW)
        torch.cuda.synchronize()
        t_total = time.perf_counter() - t0
        counts = dict(LAUNCHES)
    steps = engine.last_decode_steps
    t0 = time.perf_counter()
    engine.generate(prompts, max_new_tokens=1)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    decode_ms = (t_total - ttft) / max(steps, 1) * 1e3
    print(f"moe: {tag}: {run} route generate {len(prompts)} x "
          f"{len(prompts[0])} tokens, {MOE_NEW} new: {t_total * 1e3:.1f} "
          f"ms; ttft {ttft * 1e3:.1f} ms (a max_new_tokens=1 call); decode "
          f"{decode_ms:.3f} ms/step over {steps} steps")
    rec[run] = dict(total_ms=t_total * 1e3, ttft_ms=ttft * 1e3,
                    decode_ms_per_step=decode_ms, steps=steps)
    return out, counts, routes.calls, engine


def _moe_layer_check(torch, dev, tag, cfg, tree, rec):
    """Layer 0's ``moe_apply`` at full width on one h [8, 64, d] (bf16),
    expanded as the layer bodies expand it, on both routes: equal top-k,
    outputs within MOE_LAYER_TOL of max |y|, no host synchronisation on the
    plain route (CUDA's sync debug mode), and each route's time."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    xcfg = cfg.replace(gemm_impl="xla")
    lp = tf._unpack_layer(tf._layer(tree["layers"], 0), cfg)["moe"]
    gen = torch.Generator(device=dev).manual_seed(5)
    h = torch.randn((8, 64, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    res = {}
    for c in (cfg, xcfg):
        with _RouteRecorder(torch) as r:
            y, aux = moe.moe_apply(lp, c, h)
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(3):
            moe.moe_apply(lp, c, h)
        e.record()
        e.synchronize()
        res[c.gemm_impl] = (y, aux, r.calls[0][0], s.elapsed_time(e) / 3)
    (yk, ak, ik, mk), (yp, ap, ip, mp) = res["pallas"], res["xla"]
    # routing, dispatch and combine read nothing back to the host: a
    # synchronising call raises here (the plain route: no kernel wrapper)
    torch.cuda.set_sync_debug_mode("error")
    try:
        moe.moe_apply(lp, xcfg, h)
        sync_free = True
    except RuntimeError as e:
        sync_free = False
        print(f"moe: {tag}: FAIL: moe_apply synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    same = torch.equal(ik, ip)
    err = (yk.float() - yp.float()).abs().max().item()
    scale = yp.float().abs().max().item()
    ok = same and sync_free and err <= MOE_LAYER_TOL * scale and bool(
        torch.isfinite(yk).all())
    print(f"moe: {tag}: layer 0 moe_apply on h [8, 64, {cfg.d_model}] "
          f"bf16: top-k {'equal' if same else 'DIFFERENT'} on the two "
          f"routes; output max abs diff {err:.3e} of max |y| {scale:.3e} "
          f"({err / scale:.2e} of max; tol {MOE_LAYER_TOL:g}) "
          f"{'ok' if ok else 'FAIL'}; aux {ak.item():.5f} / "
          f"{ap.item():.5f}; kernel route {mk:.2f} ms, plain route "
          f"{mp:.2f} ms")
    rec["layer"] = dict(topk_equal=same, max_abs_diff=err, scale=scale,
                        kernel_ms=mk, plain_ms=mp)
    del lp
    return ok


def _moe_vs_plain(torch, dev, tag, cfg, tree, rec):
    """generate of MOE_PROMPTS prompts on both routes, compared as the
    module doc says (phase 15): a row is left out where its routing (top-k
    or kept pairs, recorded on both runs) differs in some layer, and every
    top-k difference must sit at a router near-tie. Returns the kernel
    route's (tokens, counts, routing calls) and whether the check held."""
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(2, cfg.vocab_size, (MOE_PROMPT_LEN,),
                             generator=gen).tolist()
               for _ in range(MOE_PROMPTS)]
    out, counts, kcalls, engine = _moe_generate(
        torch, dev, tag, cfg, tree, prompts, rec, "kernel")
    xcfg = cfg.replace(gemm_impl="xla")
    xout, _, pcalls, _ = _moe_generate(torch, dev, tag, xcfg, tree, prompts,
                                       rec, "plain")
    b, n_l = len(prompts), cfg.num_layers
    # the step whose input token first differs between the two streams
    # (a split at a logit near-tie): from then on the row's routing is
    # not comparable
    split_at = {r: next((j for j, (u, v) in enumerate(zip(out[r], xout[r]))
                         if u != v), None) for r in range(b)}

    def rows_of(i, t):
        rows = torch.arange(t, device=dev) // (t // b)
        if i >= n_l:                      # decode step (i - L) // L
            step = (i - n_l) // n_l
            for r, j in split_at.items():
                if j is not None and j <= step:
                    rows[r] = -1
        return rows
    near, moved, bad = _moe_route_diff(torch, cfg, kcalls, pcalls, rows_of)
    excluded = moved
    keep = [i for i in range(b) if i not in excluded]
    last_logits = _logits_fn(torch, dev, engine)
    lk, lp = last_logits(cfg, prompts), last_logits(xcfg, prompts)
    scale = lp.abs().max().item()
    tol = LOGIT_TOL * scale
    diff = ((lk - lp)[keep].abs().max().item() if keep else float("nan"))
    lok = bool(keep) and diff <= tol
    same, total, split = _split_rows([out[i] for i in keep],
                                     [xout[i] for i in keep])
    gaps = _split_gaps(torch, last_logits, xcfg, [prompts[i] for i in keep],
                       [out[i] for i in keep], [xout[i] for i in keep],
                       split)
    tok_ok = all(g <= 2 * tol for g in gaps)
    ok = lok and tok_ok and not bad
    print(f"moe: {tag}: rows excluded from the comparison (their top-k or "
          f"kept pairs differ between the routes in some layer): "
          f"{len(excluded)} of {b}; rows with a router near-tie (within "
          f"{MOE_TIE_RTOL:g} on either route; compared unless excluded): "
          f"{len(near)}; top-k differences away from a near-tie (call, "
          f"row, kernel-route gap, plain-route gap): {bad[:8]}"
          f"{f' and {len(bad) - 8} more' if len(bad) > 8 else ''} "
          f"{'FAIL' if bad else 'ok'}")
    print(f"moe: {tag}: prefill last-position logits of the {len(keep)} "
          f"rows left, kernel vs plain route: max abs diff {diff:.4e} of "
          f"max |logit| {scale:.4e} (tol {LOGIT_TOL:g}) "
          f"{'ok' if lok else 'FAIL'}; tokens {same}/{total} equal; splits "
          f"(row, step, plain-route gap) "
          f"{[(keep[i], j, g) for (i, j), g in zip(split, gaps)]} "
          f"{'ok' if tok_ok else 'FAIL'}")
    rec.update(excluded=sorted(excluded), near_tie_rows=sorted(near),
               moved_rows=sorted(moved), logit_max_abs_diff=diff,
               logit_scale=scale, token_agreement=[same, total],
               logit_spread=statistics.median(lp.std(dim=-1).tolist()))
    del engine
    return out, counts, kcalls, ok


def _moe_expand(torch, dev, tag, cfg, tree, rec):
    """The expand each MoE layer pays on every forward pass (the layers run
    decompressed): `decompress` of layer 0's gate expert stack [E, d, f]
    and `_unpack_layer` of the whole layer, as `_time_ms` times (L2
    flushed), against the kernel route's decode step."""
    from repro_torch.core.dbb_linear import decompress
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import dtype_of
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    lp = tf._layer(tree["layers"], 0)
    wi = lp["moe"]["experts"]["wi"]
    stack_ms = _time_ms(torch, lambda: decompress(wi, dtype_of(cfg)), flush)
    layer_ms = _time_ms(torch, lambda: tf._unpack_layer(lp, cfg), flush)
    step = rec["generate"]["kernel"]["decode_ms_per_step"]
    share = cfg.num_layers * layer_ms / step
    print(f"moe: {tag}: expand of one expert stack ({cfg.moe.num_experts} x "
          f"{cfg.d_model} x {cfg.d_ff}, w4 -> bf16) {stack_ms:.3f} ms; of "
          f"layer 0 (_unpack_layer) {layer_ms:.3f} ms; x {cfg.num_layers} "
          f"layers = {share:.1%} of the kernel route's {step:.3f} ms decode "
          f"step")
    rec["expand"] = dict(stack_ms=stack_ms, layer_ms=layer_ms,
                         decode_share=share)


def _moe_serve(torch, dev, tag, cfg, tree, rec, sampling=None,
               caches=(False, True)):
    """``serve`` of MOE_SERVE_LENS requests (packed prefill) through 8
    slots on the contiguous cache and / or the paged pool (page 64), the
    counts reset before and read after each, the routing recorded:
    ({path: (counts, routing calls, prefill calls, decode steps)},
    {path: streams})."""
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.serve.engine import ServeEngine
    gen = torch.Generator().manual_seed(3)
    reqs = [torch.randint(2, cfg.vocab_size, (n,), generator=gen).tolist()
            for n in MOE_SERVE_LENS]
    scfg = cfg.replace(kv_page_size=64)
    runs, outs = {}, {}
    kw = {} if sampling is None else dict(sampling=sampling)
    for paged in caches:
        name = (f"serve_{'paged' if paged else 'packed'}"
                + ("_sampled" if sampling else ""))
        eng = ServeEngine(scfg, tree, max_batch=8, paged=paged, device=dev)
        eng.serve(reqs[:2], max_new_tokens=2)                # warm-up
        torch.cuda.synchronize()
        eng.last_decode_steps = 0
        with _RouteRecorder(torch) as routes:
            reset_launches()
            t0 = time.perf_counter()
            outs[name] = eng.serve(reqs, max_new_tokens=MOE_SERVE_BUDGETS,
                                   **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(LAUNCHES)
        st = eng.serve_stats
        ttft = sorted(st["ttft_s"])
        n_tok = sum(len(o) for o in outs[name])
        print(f"moe: {tag}: {name}: {len(reqs)} requests of "
              f"{min(MOE_SERVE_LENS)}-{max(MOE_SERVE_LENS)} tokens, budgets "
              f"{MOE_SERVE_BUDGETS}: {wall * 1e3:.1f} ms, "
              f"{n_tok / wall:.1f} generated tokens/s; ttft median "
              f"{ttft[len(ttft) // 2] * 1e3:.1f} ms, max "
              f"{ttft[-1] * 1e3:.1f} ms; {st['prefill_calls']} prefill "
              f"calls, {eng.last_decode_steps} decode steps")
        rec[name] = dict(wall_ms=wall * 1e3, tokens=n_tok,
                         ttft_median_ms=ttft[len(ttft) // 2] * 1e3,
                         prefill_calls=st["prefill_calls"],
                         decode_steps=eng.last_decode_steps)
        runs[name] = (counts, routes.calls, st["prefill_calls"],
                      eng.last_decode_steps)
        del eng
    return runs, outs


def _moe_model(torch, dev, report, arch, experts, layers, why):
    """One model of the moe phase (module doc, phase 15): (by_path, ok)."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.core.dbb_linear import tree_footprint_bytes
    from repro_torch.models import registry
    from repro_torch.serve.sampling import SamplingParams
    t_model = time.perf_counter()
    full = get_config(arch)
    cfg = full.replace(
        num_layers=layers, remat="none", gemm_impl="pallas",
        moe=dataclasses.replace(full.moe, num_experts=experts),
        dbb=dataclasses.replace(full.dbb, weight_bits=4, quant_group=128))
    short = arch.split("-")[0]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree = registry.init_params_by_layer(cfg, seed=len(arch), device=dev,
                                         pack=True, layer_hook=_family_noise)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    layer_bytes = tree_footprint_bytes(tree["layers"])
    resident = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()
    print(f"moe: {arch}: {layers} of {full.num_layers} layers, "
          f"{experts} of {full.moe.num_experts} experts (cut: {why}); d "
          f"{cfg.d_model}, {cfg.num_heads} heads over {cfg.num_kv_heads} KV "
          f"heads of {cfg.resolved_head_dim}, expert d_ff {cfg.d_ff}, top-"
          f"{cfg.moe.top_k}, capacity factor {cfg.moe.capacity_factor}, "
          f"dense residual {cfg.moe.dense_residual_ff}, vocab "
          f"{cfg.vocab_size}; w4 planes (G 128) of the attention and the "
          f"experts, f32 dense_mlp and router; built layer by layer in "
          f"{t_build:.1f} s; layers {layer_bytes / 1e9:.3f} GB (format "
          f"bytes), {resident / 1e9:.3f} GB resident on the card, build "
          f"peak {peak / 1e9:.3f} GB ({report['card']})")
    rec = {"layers": layers, "experts": experts, "build_s": t_build,
           "layer_bytes": layer_bytes, "resident_bytes": resident,
           "build_peak_bytes": peak, "generate": {}}
    report["moe"][arch] = rec
    by_path = {}
    ok = _moe_layer_check(torch, dev, arch, cfg, tree, rec)
    out, counts, kcalls, cmp_ok = _moe_vs_plain(torch, dev, arch, cfg, tree,
                                                rec["generate"])
    ok = ok and cmp_ok
    _moe_expand(torch, dev, arch, cfg, tree, rec)
    steps = rec["generate"]["kernel"]["steps"]
    head = _head_kernel(torch, cfg, MOE_PROMPTS)
    attn = {"flash_prefill": layers, "paged_decode": layers * steps}
    want = _moe_expected(torch, cfg, kcalls, 1 + steps, head, attn)
    path = f"moe_{short}_generate"
    by_path[path] = counts
    ok = _moe_check_launches(path, counts, want) and ok

    if short == "arctic":
        runs, outs = _moe_serve(torch, dev, arch, cfg, tree, rec)
        for name, (counts, calls, prefills, steps) in runs.items():
            attn = {"flash_prefill_packed": layers * prefills,
                    "paged_decode": layers * steps}
            want = _moe_expected(torch, cfg, calls, prefills + steps, head,
                                 attn)
            path = f"moe_{short}_{name}"
            by_path[path] = counts
            ok = _moe_check_launches(path, counts, want) and ok
        same = outs["serve_packed"] == outs["serve_paged"]
        print(f"moe: {arch}: serve streams, paged vs contiguous "
              f"{'equal' if same else 'DIFFERENT'}")
        ok = ok and same
    else:
        spread = rec["generate"]["logit_spread"]
        n = len(SAMPLE_T_SPREAD)
        sp = [SamplingParams(
            temperature=0.0 if i == 0 else spread * SAMPLE_T_SPREAD[i % n],
            seed=i * 7919 + 1) for i in range(len(MOE_SERVE_LENS))]
        runs, outs = _moe_serve(torch, dev, arch, cfg, tree, rec,
                                sampling=sp, caches=(True,))
        _, gouts = _moe_serve(torch, dev, arch, cfg, tree, rec,
                              caches=(True,))
        for name, (counts, calls, prefills, steps) in runs.items():
            attn = {"flash_prefill_packed": layers * prefills,
                    "paged_decode": layers * steps}
            want = _moe_expected(torch, cfg, calls, prefills + steps,
                                 "head_sample_fused", attn)
            path = f"moe_{short}_{name}"
            by_path[path] = counts
            ok = _moe_check_launches(path, counts, want) and ok
        sout, gout = outs["serve_paged_sampled"], gouts["serve_paged"]
        moved = sum(a != b for s, g in zip(sout, gout) for a, b in zip(s, g))
        valid = all(0 <= t < cfg.vocab_size for s in sout for t in s)
        print(f"moe: {arch}: sampled serve (temperatures "
              f"{[round(p.temperature, 3) for p in sp]}): {moved} tokens "
              f"differ from the greedy serve's, all in the vocabulary "
              f"{'ok' if moved and valid else 'FAIL'}")
        ok = ok and moved > 0 and valid

    del tree
    gc.collect()
    torch.cuda.empty_cache()
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["phase_s"] = time.perf_counter() - t_model
    g = rec["generate"]
    print(f"moe: {arch}: decode {g['kernel']['decode_ms_per_step']:.3f} "
          f"ms/step on the kernel route, {g['plain']['decode_ms_per_step']:.3f}"
          f" on the plain route (the expand {rec['expand']['layer_ms']:.3f} "
          f"ms a layer); ttft {g['kernel']['ttft_ms']:.1f} / "
          f"{g['plain']['ttft_ms']:.1f} ms; peak device memory "
          f"{rec['peak_bytes'] / 1e9:.3f} GB; {rec['phase_s']:.1f} s "
          f"({report['card']})")
    return by_path, ok


def _head_kernel(torch, cfg, rows: int) -> str:
    """The kernel the greedy head GEMV at ``rows`` rows takes."""
    from repro_torch.kernels import dispatch
    name = dispatch.explain("matmul", m=rows, k=cfg.d_model,
                            n=cfg.vocab_size, dtype=torch.float32, cfg=cfg,
                            gemv=True)[0].name
    return MOE_GEMM_KERNELS.get(name, name)


def _moe_cli(torch, dev, report):
    """The serve CLI on arctic-480b smoke, packed, kernel route: every
    route its tables choose launched its kernel. Its decode-layer table is
    the packed one (as the reference CLI prints it) while the MoE layers
    run expanded, so a DBB route there is held against its dense kernel."""
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.launch import serve
    dense_of = {"skinny_dbb": "skinny_sta", "skinny_dbb_w4": "skinny_sta",
                "dbb_packed": "sta", "dbb_packed_w4": "sta"}
    rep = {}
    reset_launches()
    t0 = time.perf_counter()
    rc = serve.main(MOE_CLI_ARGV.split(), report=rep)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    routes = {dom: dense_of.get(r, r) if dom == "matmul" else r
              for dom, r in rep["routes"].items()}
    missing = [f"{dom} {r}" for dom, r in routes.items()
               if r in ROUTE_KERNELS
               and not sum(counts[k] for k in ROUTE_KERNELS[r])]
    dbb = {k: v for k, v in counts.items() if k.startswith("dbb") and v}
    ok = rc == 0 and not missing and not dbb
    print(f"moe: cli {MOE_CLI_ARGV}: tables chose {rep['routes']} (the "
          f"matmul route held as {routes['matmul']}: the layers run "
          f"expanded); launches { {k: v for k, v in counts.items() if v} }; "
          f"wall {wall:.1f} s "
          + ("ok" if ok else f"FAIL: missing {missing}, DBB {dbb}"))
    report["moe"]["cli"] = dict(argv=MOE_CLI_ARGV, routes=rep["routes"],
                                wall_s=wall, launches={
                                    k: v for k, v in counts.items() if v})
    return counts, ok


def _moe_phase(torch, dev, report, out_dir):
    """The moe_lm family at the published widths (module doc, phase 15)."""
    report["moe"] = {}
    by_path, ok = {}, True
    for arch, experts, layers, why in MOE_MODELS:
        counts, model_ok = _moe_model(torch, dev, report, arch, experts,
                                      layers, why)
        by_path.update(counts)
        ok = ok and model_ok
    counts, cli_ok = _moe_cli(torch, dev, report)
    by_path["moe_cli_arctic_smoke"] = counts
    report["moe"]["kernels"] = _moe_kernels(torch, dev)
    return by_path, ok and cli_ok


def _moe_kernels(torch, dev):
    """The kernels at the moe phase's new shapes (bf16), each against its
    plain version and timed as the kernel phase times (medians of single
    calls, L2 flushed) beside its bound and the library call: the skinny
    GEMM at arctic's decode capacity (M8: the expert's gate K7168 N4864
    with silu, its down projection K4864 N7168), the M-tiled GEMM at its
    generate capacity (M40, the same two), flash_prefill at arctic's G 7 D
    128 and kimi's G 8 D 112 (the FMA body: D is no multiple of 64; B8
    T=S=32, generate's prefill), flash_prefill_packed at the same two (a
    packed call of the first 8 serve lengths, the body each takes
    printed), paged_decode at the same two (B8, S48 in 16-slot pages,
    lengths 40; through the identity table), and head_sample_fused at
    kimi's sampled decode head (M8 K7168 N163840 f32; `_head_sample_case`'s
    rules)."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.attn.ops import (flash_attention,
                                              packed_flash_attention,
                                              paged_decode_attention)
    from repro_torch.kernels.attn.ref import (flash_prefill_ref,
                                              packed_prefill_ref,
                                              paged_decode_ref)
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.skinny.ops import sta_gemm_skinny
    from repro_torch.kernels.sta_gemm.ops import sta_gemm
    from repro_torch.kernels.sta_gemm.ref import sta_gemm_ref
    from repro_torch.models.moe import _capacity
    gen = torch.Generator(device=dev).manual_seed(7)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    bf16, i32 = torch.bfloat16, dict(dtype=torch.int32, device=dev)
    rows, failures = {}, []

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(bf16)

    def record(label, err, ok, ms, pms, lms, lib, bms, by, note=""):
        if not ok:
            failures.append(f"{label}: max err {err}")
        print(f"kernel {label}: max abs err {err:.3e} {'ok' if ok else 'FAIL'}"
              f"; kernel {ms:.4f} ms{note}, plain {pms:.4f} ms, {lib} "
              f"{lms:.4f} ms ({ms / lms:.2f}x), bound {bms:.4f} ms ({by})")
        rows[label] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                           library_ms=lms, bound_ms=bms, bound_by=by)

    arctic = get_config("arctic-480b")
    cap = _capacity(MOE_PROMPTS * MOE_PROMPT_LEN, arctic.replace(
        moe=dataclasses.replace(arctic.moe, num_experts=MOE_MODELS[0][1])))
    for name, fn, m, k, n, act in (
            ("sta_gemm_skinny", sta_gemm_skinny, 8, 7168, 4864, "silu"),
            ("sta_gemm_skinny", sta_gemm_skinny, 8, 4864, 7168, "none"),
            ("sta_gemm", sta_gemm, cap, 7168, 4864, "silu"),
            ("sta_gemm", sta_gemm, cap, 4864, 7168, "none")):
        x, w = randn(m, k), randn(k, n, scale=k ** -0.5)
        got, want = fn(x, w, act=act), sta_gemm_ref(x, w, act=act)
        err, ok = _close(torch, got, want, 2e-2)
        ms = _time_ms(torch, lambda: fn(x, w, act=act), flush)
        pms = _time_ms(torch, lambda: sta_gemm_ref(x, w, act=act), flush)
        lms = _time_ms(torch, lambda: torch.matmul(x, w), flush)
        bms, by = _bound_ms((x.numel() + w.numel() + m * n) * 2,
                            2.0 * m * k * n, BF16_OPS_PER_S)
        record(f"{name} M{m} K{k} N{n} bf16 act {act}", err, ok, ms, pms,
               lms, "torch.matmul", bms, by)

    b, t = MOE_PROMPTS, MOE_PROMPT_LEN
    for hq, hkv, d in ((56, 8, 128), (64, 8, 112)):
        g = hq // hkv
        scale = d ** -0.5
        q, k, v = randn(b, t, hq, d), randn(b, t, hkv, d), randn(b, t, hkv, d)
        st = torch.zeros((b,), **i32)
        qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        kx, vx = (a.repeat_interleave(g, dim=1) for a in (kh, vh))
        tc_before = LAUNCHES["flash_prefill_tc"]
        got = flash_attention(q, k, v, st)
        want = flash_prefill_ref(qh, kh, vh, st, st, sm_scale=scale)
        torch.cuda.synchronize()
        body = ("tensor-core" if LAUNCHES["flash_prefill_tc"] > tc_before
                else "FMA")
        err, ok = _close(torch, got, want.transpose(1, 2), ATTN_RTOL,
                         ATTN_ATOL)
        ms = _time_ms(torch, lambda: flash_attention(q, k, v, st), flush)
        pms = _time_ms(torch, lambda: flash_prefill_ref(
            qh, kh, vh, st, st, sm_scale=scale), flush)
        lms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kx, vx, is_causal=True), flush)
        pairs = b * t * (t + 1) // 2
        bms, by = _bound_ms(2 * 2 * b * t * (hq + hkv) * d,
                            4.0 * d * pairs * hq, BF16_OPS_PER_S)
        record(f"flash_prefill B{b} T=S={t} Hq{hq} Hkv{hkv} D{d} bf16", err,
               ok, ms, pms, lms, "scaled_dot_product_attention", bms, by,
               f" ({body} body)")

        lens = MOE_SERVE_LENS[:8]
        tp = sum(lens)
        q, k, v = randn(tp, hq, d), randn(tp, hkv, d), randn(tp, hkv, d)
        seg = torch.repeat_interleave(torch.arange(len(lens), **i32),
                                      torch.tensor(lens, device=dev))
        ii = torch.arange(tp, device=dev)
        mask = (ii[None, :] <= ii[:, None]) & (seg[None, :] == seg[:, None])
        qh, kh, vh = (a.transpose(0, 1).contiguous() for a in (q, k, v))
        kx, vx = (a.repeat_interleave(g, dim=0) for a in (kh, vh))
        tc_before = LAUNCHES["flash_prefill_packed_tc"]
        got = packed_flash_attention(q, k, v, seg)
        want = packed_prefill_ref(qh, kh, vh, seg, sm_scale=scale)
        torch.cuda.synchronize()
        body = ("tensor-core"
                if LAUNCHES["flash_prefill_packed_tc"] > tc_before else "FMA")
        err, ok = _close(torch, got, want.transpose(0, 1), ATTN_RTOL,
                         ATTN_ATOL)
        ms = _time_ms(torch, lambda: packed_flash_attention(q, k, v, seg),
                      flush)
        pms = _time_ms(torch, lambda: packed_prefill_ref(
            qh, kh, vh, seg, sm_scale=scale), flush)
        lms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            qh[None], kx[None], vx[None], attn_mask=mask), flush)
        pairs = sum(n * (n + 1) // 2 for n in lens)
        bms, by = _bound_ms(2 * 2 * tp * (hq + hkv) * d,
                            4.0 * d * pairs * hq, BF16_OPS_PER_S)
        record(f"flash_prefill_packed T{tp} over {len(lens)} segments "
               f"Hq{hq} Hkv{hkv} D{d} bf16", err, ok, ms, pms, lms,
               "scaled_dot_product_attention", bms, by, f" ({body} body)")
        del q, k, v, qh, kh, vh, kx, vx, mask

        s, page, length = t + MOE_NEW, 16, t + MOE_NEW // 2
        n_log = s // page
        qd = randn(b, hkv, g, d)
        kc, vc = randn(b, s, hkv, d), randn(b, s, hkv, d)
        kp = kc.view(b * n_log, page, hkv, d)
        vp = vc.view(b * n_log, page, hkv, d)
        table = (torch.arange(b, **i32)[:, None] * n_log
                 + torch.arange(n_log, **i32)[None, :])
        lengths = torch.full((b,), length, **i32)

        def run_kernel():
            return paged_decode_attention(qd, kp, vp, table, lengths, st)
        got = run_kernel()
        want = paged_decode_ref(qd, kp, vp, table, lengths, st,
                                sm_scale=scale)
        err, ok = _close(torch, got, want, 2e-2)
        qs = qd.reshape(b, hq, 1, d)
        ks, vs = (a.transpose(1, 2).repeat_interleave(g, dim=1)
                  for a in (kc, vc))
        am = (torch.arange(s, device=dev) <= length)[None, None, None, :]
        ms = _time_ms(torch, run_kernel, flush)
        pms = _time_ms(torch, lambda: paged_decode_ref(
            qd, kp, vp, table, lengths, st, sm_scale=scale), flush)
        lms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=am), flush)
        valid = b * (length + 1)
        bms, by = _bound_ms(qd.numel() * 2 * 2 + valid * hkv * d * 2 * 2,
                            4.0 * valid * hq * d, BF16_OPS_PER_S)
        record(f"paged_decode B{b} Hkv{hkv} G{g} D{d} S{s} page{page} bf16",
               err, ok, ms, pms, lms, "scaled_dot_product_attention", bms,
               by)

    kimi = get_config("kimi-k2-1t-a32b")
    res, fail = _head_sample_case(torch, dev, flush, 8, kimi.d_model,
                                  kimi.vocab_size, 8)
    if fail:
        failures.append(fail)
    rows[f"head_sample_fused M8 K{kimi.d_model} N{kimi.vocab_size} f32"] = {
        key: res[key] for key in ("max_abs_err", "ms", "plain_ms",
                                  "library_ms", "bound_ms", "bound_by",
                                  "head_matmul_ms")}
    torch.cuda.empty_cache()
    if failures:
        raise SystemExit(_fail("a kernel disagrees with its plain version "
                               "at the moe shapes: " + "; ".join(failures)))
    return rows


# ---------------------------------------------------------------------------
# phase 11: the INT8 datapath (INT8 x INT8 -> INT32) at full width
# ---------------------------------------------------------------------------

def _expect(launches, want):
    """Launch counts equal ``want`` exactly (every other counter, float
    branches included, at 0)."""
    return {k: v for k, v in launches.items() if v} == want


def _s8_tc_taken(branch, k_dim, n) -> bool:
    """Whether an int8 branch runs (K, N) on the int8 tensor-core body: the
    M-tiled two, by their wrappers' rules."""
    from repro_torch.kernels.dbb_gemm.ops import s8_tc_body as dbb_rule
    from repro_torch.kernels.sta_gemm.ops import s8_tc_body as sta_rule
    return ((branch == "sta_gemm_s8" and sta_rule(k_dim, n))
            or (branch == "dbb_gemm_s8" and dbb_rule(k_dim, n)))


def _with_s8_tc(want, k_dim, n):
    """``want`` plus the ``_s8_tc`` count of each branch in it that runs
    (K, N) on the int8 tensor-core body."""
    out = dict(want)
    for name in want:
        if _s8_tc_taken(name, k_dim, n):
            out[name + "_tc"] = want[name]
    return out


def _s8_tc_check(counts) -> bool:
    """Every M512 sta_gemm_s8 / dbb_gemm_s8 launch of the olmo-1b int8 runs
    ran the int8 tensor-core body: the ``_s8_tc`` counts equal the
    branches' counts."""
    ok = True
    for path, c in counts.items():
        if not path.endswith("_m512"):
            continue
        good = all(c[f"{b}_tc"] == c[b] for b in ("sta_gemm_s8",
                                                  "dbb_gemm_s8"))
        ok = ok and good
        print(f"s8 tc: {path}: sta_gemm_s8_tc {c['sta_gemm_s8_tc']} of "
              f"sta_gemm_s8 {c['sta_gemm_s8']}, dbb_gemm_s8_tc "
              f"{c['dbb_gemm_s8_tc']} of dbb_gemm_s8 {c['dbb_gemm_s8']} "
              f"{'ok' if good else 'FAIL'}")
    return ok


def _int8_olmo(torch, dev, report, counts):
    """(a) olmo-1b's layer GEMMs (16 layers x 7) on the seed-0 projected
    weights through ``dispatch.matmul`` with int8 activations, at M8 and
    M512, on the dense INT8 weights (quantize_weight) and on the
    INT8-valued packed tree (pack_tree(quantize=True)); three epilogues
    each (_s8_epilogues with silu on N 8192, the requant with relu),
    every output against the plain route's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.dbb_linear import pack_tree
    from repro_torch.core.quant import act_scale, quantize_weight
    from repro_torch.core.sparsity import apply_dbb_to_tree
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.models import registry

    cfg = get_config("olmo-1b")
    proj = apply_dbb_to_tree(registry.init_params(cfg, seed=0, device=dev),
                             cfg.dbb, straight_through=False)
    packed = pack_tree(proj, cfg.dbb, quantize=True)
    leaves = [(f"{g}.{n}", sub["w"], packed["layers"][g][n]["w"])
              for g in ("attn", "mlp")
              for n, sub in proj["layers"][g].items()
              if isinstance(sub, dict) and "w" in sub]
    gen = torch.Generator(device=dev).manual_seed(11)
    ok = True
    for kind in ("dense", "dbb"):
        # (label, weight, the caller's share of x_s·w_s, K, N): a dense
        # weight's w_s rides the caller's scale, a packed leaf carries its
        # own and dispatch folds the caller's x_s into it
        weights = []
        for label, dense, leaf in leaves:
            for layer in range(cfg.num_layers):
                if kind == "dense":
                    qw = quantize_weight(dense[layer])
                    weights.append((label, qw.q, qw.scale, *qw.q.shape))
                else:
                    lw = leaf.map(lambda a, i=layer: a[i])
                    weights.append((label, lw, 1.0, lw.k_dim, lw.n_dim))
        for m in (8, 512):
            xq = {k: _quantized(torch, gen, (m, k), dev)
                  for k in {w[3] for w in weights}}
            bias = {n: torch.randn(n, generator=gen, device=dev)
                    for n in {w[4] for w in weights}}
            worst, offs, bad = 0.0, 0, []
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            for label, w, wscale, k_dim, n in weights:
                x, xs = xq[k_dim]
                act = "silu" if n == cfg.d_ff else "none"

                def run(pallas, act, bias=None, scale=None, out_dtype=None):
                    ww = w       # the raw sum takes a packed leaf unscaled
                    if kind == "dbb" and scale is None:
                        ww = dataclasses.replace(w, scale=None)
                    return dispatch.matmul(x, ww, bias, scale, act=act,
                                           out_dtype=out_dtype,
                                           pallas=pallas)
                ys = act_scale(run(False, act, bias[n], xs * wscale))
                for tag, kw, a in _s8_epilogues(torch, xs, wscale, bias[n],
                                                act, ys):
                    a = "relu" if tag == "int8" else a
                    got, want = run(True, a, **kw), run(False, a, **kw)
                    err, off, good = _s8_check(torch, got, want, a)
                    worst, offs = max(worst, err), offs + off
                    if not good:
                        bad.append(f"{label} {tag} {a}: err {err}")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            path = f"int8_olmo_{kind}_m{m}"
            counts[path] = dict(LAUNCHES)
            branch = {("dense", 8): "sta_gemm_skinny_s8",
                      ("dense", 512): "sta_gemm_s8",
                      ("dbb", 8): "dbb_gemm_skinny_s8",
                      ("dbb", 512): "dbb_gemm_s8"}[kind, m]
            want = {branch: 3 * len(weights)}
            tc = 3 * sum(_s8_tc_taken(branch, w[3], w[4]) for w in weights)
            if tc:
                want[branch + "_tc"] = tc
            launch_ok = _expect(counts[path], want)
            ok = ok and launch_ok and not bad
            print(f"int8: (a) olmo-1b full width, {kind} INT8 weights, "
                  f"M{m}: {len(weights)} layer GEMMs x 3 epilogues (int32; "
                  f"f32 x_s·w_s + bias, silu on N{cfg.d_ff}; int8 requant "
                  f"relu) through dispatch.matmul, kernel vs plain route: "
                  f"max abs err {worst:.3e}, {offs} elements off by one "
                  f"{'ok' if not bad else 'FAIL ' + '; '.join(bad[:5])}; "
                  f"{wall:.2f} s with the plain route; launches "
                  f"{ {k: v for k, v in counts[path].items() if v} } (want "
                  f"{want}{'' if launch_ok else ', FAIL'})")
            report["int8"][path] = dict(max_abs_err=worst, off_by_one=offs,
                                        wall_s=wall, ok=not bad and launch_ok)
    return ok


def _int8_cnn_forward(torch, params, cfg, images, use_kernel):
    """convnet's INT8 chain through the front doors: each layer's input
    quantized per tensor (act_scale), the conv with x_s·w_s fused, bias
    and relu to f32, the 2x2 max-pool, requantized, ..., the classifier
    (f32 logits)."""
    from repro_torch.core.quant import QuantizedWeight, act_scale
    from repro_torch.kernels import dispatch
    from repro_torch.models.cnn import max_pool_2x2
    x, k = images, cfg.cnn_kernel

    def quantize(a):
        s = act_scale(a)
        return torch.clamp(torch.round(a / s), -127, 127).to(torch.int8), s
    for i in range(len(cfg.cnn_channels)):
        p = params[f"conv{i}"]
        xq, xs = quantize(x)
        w, scale = p["w"], xs
        if isinstance(w, QuantizedWeight):
            w, scale = w.q, xs * w.scale
        y = dispatch.conv(xq, w, p["b"], scale, kh=k, kw=k, act="relu",
                          out_dtype=torch.float32, use_kernel=use_kernel)
        x = max_pool_2x2(y)
    xq, xs = quantize(x.reshape(x.shape[0], -1))
    return dispatch.matmul(xq, params["fc"]["w"], params["fc"]["b"], xs,
                           pallas=use_kernel, out_dtype=torch.float32)


def _int8_cnn(torch, dev, report, counts):
    """(b) convnet-dbb at full width, INT8 weights (conv0 dense from
    quantize_weight, conv1-2 and the classifier pack_tree(quantize=True)),
    the INT8 chain at batch 256 and 1 on the kernel and the plain routes:
    logits and classes bit-equal."""
    from repro_torch.configs import get_config
    from repro_torch.core.dbb_linear import pack_tree
    from repro_torch.core.quant import quantize_weight
    from repro_torch.core.sparsity import apply_dbb_to_tree
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.kernels.conv_gemm.ops import small_body
    from repro_torch.kernels.conv_gemm.ops import tc_body as conv_tc_body
    from repro_torch.models import registry

    cfg = get_config("convnet-dbb")
    params = pack_tree(apply_dbb_to_tree(
        registry.init_params(cfg, seed=0, device=dev), cfg.dbb,
        straight_through=False), cfg.dbb, quantize=True)
    params["conv0"] = dict(params["conv0"],
                           w=quantize_weight(params["conv0"]["w"]))
    ok = True
    for batch, fc in ((256, "dbb_gemm_s8"), (1, "dbb_gemm_skinny_s8")):
        gen = torch.Generator(device=dev).manual_seed(batch)
        images = torch.randn(batch, cfg.cnn_img, cfg.cnn_img, cfg.cnn_in_ch,
                             generator=gen, device=dev)
        _int8_cnn_forward(torch, params, cfg, images, True)      # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        logits = _int8_cnn_forward(torch, params, cfg, images, True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        path = f"int8_cnn_b{batch}"
        counts[path] = dict(LAUNCHES)
        want = _with_s8_tc({"conv_gemm_s8": 1, "conv_gemm_dbb_s8": 2,
                            fc: 1}, params["fc"]["w"].k_dim,
                           cfg.cnn_classes)
        # conv0 (C 3, 3x3, N 64) on conv_gemm's small-C body
        if small_body(torch.int8, cfg.cnn_in_ch, cfg.cnn_kernel,
                      cfg.cnn_kernel, cfg.cnn_channels[0]):
            want["conv_gemm_s8_small"] = 1
        # conv1 and conv2 (C 64 / 128) on the conv's int8 tensor-core body
        conv_tc = sum(conv_tc_body(torch.int8, c, cfg.cnn_kernel,
                                   cfg.cnn_kernel, 1, n)
                      for c, n in zip(cfg.cnn_channels[:-1],
                                      cfg.cnn_channels[1:]))
        if conv_tc:
            want["conv_gemm_dbb_s8_tc"] = conv_tc
        launch_ok = _expect(counts[path], want)
        plain = _int8_cnn_forward(torch, params, cfg, images, False)
        same = bool(torch.equal(logits, plain))
        classes = bool(torch.equal(logits.argmax(-1), plain.argmax(-1)))
        finite = bool(torch.isfinite(logits).all())
        run_ok = (same and classes and finite and launch_ok
                  and tuple(logits.shape) == (batch, cfg.cnn_classes))
        ok = ok and run_ok
        print(f"int8: (b) convnet-dbb full width, INT8 chain, batch {batch}:"
              f" logits vs plain route {'bit-equal' if same else 'DIFFER'} "
              f"(max abs diff {(logits - plain).abs().max().item():.3e} of "
              f"max |logit| {plain.abs().max().item():.4e}), classes "
              f"{'equal' if classes else 'DIFFER'} "
              f"{'ok' if run_ok else 'FAIL'}; one forward {wall:.3f} ms "
              f"after a warm-up; launches "
              f"{ {k: v for k, v in counts[path].items() if v} } (want "
              f"{want}{'' if launch_ok else ', FAIL'})")
        report["int8"][path] = dict(wall_ms=wall, bit_equal=same, ok=run_ok)
    return ok


def _int8_exact(torch, dev, report):
    """(c) all-127 operands through every int8 branch at K >= 1152 (the
    convs' tensor-core body at C 128, their IMAD bodies at C 131 / 136):
    the int32 sum is K·127² (past 2^24) exactly, and each branch launches
    once."""
    from repro_torch.core.dbb import pack_dbb
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.kernels.conv_gemm import conv_gemm, conv_gemm_dbb
    from repro_torch.kernels.dbb_gemm import dbb_gemm
    from repro_torch.kernels.skinny import dbb_gemm_skinny, sta_gemm_skinny
    from repro_torch.kernels.sta_gemm import sta_gemm

    def full(*shape):
        return torch.full(shape, 127, dtype=torch.int8, device=dev)
    p1184 = pack_dbb(full(1184, 256), 8, 8)
    p1224 = pack_dbb(full(1224, 64), 8, 8)
    p1152 = pack_dbb(full(1152, 64), 8, 8)
    runs = {"sta_gemm_s8": (1179, lambda: sta_gemm(full(512, 1179),
                                                   full(1179, 256))),
            "sta_gemm_s8_tc": (1184, lambda: sta_gemm(full(512, 1184),
                                                      full(1184, 256))),
            "sta_gemm_skinny_s8": (1184, lambda: sta_gemm_skinny(
                full(8, 1184), full(1184, 256))),
            "dbb_gemm_s8": (1184, lambda: dbb_gemm(
                full(512, 1184), p1184.values, p1184.bitmask, nnz=8)),
            "dbb_gemm_skinny_s8": (1184, lambda: dbb_gemm_skinny(
                full(8, 1184), p1184.values, p1184.bitmask, nnz=8)),
            "conv_gemm_s8": (1179, lambda: conv_gemm(
                full(2, 5, 5, 131), full(1179, 64), kh=3, kw=3,
                padding="VALID")),
            "conv_gemm_dbb_s8": (1224, lambda: conv_gemm_dbb(
                full(2, 5, 5, 136), p1224.values, p1224.bitmask, kh=3, kw=3,
                padding="VALID", nnz=8)),
            "conv_gemm_dbb_s8_tc": (1152, lambda: conv_gemm_dbb(
                full(2, 5, 5, 128), p1152.values, p1152.bitmask, kh=3, kw=3,
                padding="VALID", nnz=8)),
            "conv_gemm_s8_tc": (1152, lambda: conv_gemm(
                full(2, 5, 5, 128), full(1152, 64), kh=3, kw=3,
                padding="VALID"))}
    ok, res = True, {}
    for name, (k, run) in runs.items():
        reset_launches()
        y = run()
        torch.cuda.synchronize()
        exact = (y.dtype == torch.int32
                 and bool((y == k * 127 * 127).all()))
        branch = name.removesuffix("_tc")
        want = (_with_s8_tc({branch: 1}, k, y.shape[-1])
                if not branch.startswith("conv") else
                {branch: 1, **({name: 1} if name != branch else {})})
        launched = _expect(dict(LAUNCHES), want)
        res[name] = exact and launched
        ok = ok and res[name]
    print(f"int8: (c) all-127 operands, the int32 sum K·127² exactly (K "
          f"1152-1224, past 2^24; sta_gemm_s8 at K 1179 on the IMAD body "
          f"and 1184 on the tensor-core one; conv_gemm_dbb_s8 at C 136 on "
          f"the IMAD body and C 128 on the tensor-core one, conv_gemm_s8 at "
          f"C 131 on the IMAD body and C 128 on the tensor-core one) and one "
          f"launch "
          f"each: "
          + ", ".join(f"{k} {'ok' if v else 'FAIL'}" for k, v in res.items()))
    report["int8"]["exact"] = res
    return ok


def _int8_phase(torch, dev, report):
    """Phase 11: (a) olmo-1b's layer GEMMs, (b) convnet's INT8 chain, (c)
    the exactness case; (d) every run's launch counts exactly what the
    route table implies, no float branch moving, and every M512 M-tiled
    int8 launch on the int8 tensor-core body."""
    report["int8"] = {}
    counts = {}
    ok = _int8_olmo(torch, dev, report, counts)
    ok = _int8_cnn(torch, dev, report, counts) and ok
    ok = _int8_exact(torch, dev, report) and ok
    ok = _s8_tc_check(counts) and ok
    return counts, ok


if __name__ == "__main__":
    sys.exit(main())
