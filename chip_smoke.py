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
            ``gemm_impl="pallas"``: starcoder2-15b (10 of its 40 layers;
            the cli phase runs all 40;
            LayerNorm, GQA G 12, QKV bias, GeLU MLP, 4096-token window):
            generate of 8 left-padded prompts of 64-15 tokens (32 new),
            generate of one 5120-token prompt (16 new; the window bites),
            serve of 8 requests including that one (packed prefill) on the
            contiguous cache and on the paged pool; qwen2.5-14b (12 of
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
            reference's fused-expert ceiling; 4 of 35 layers; top-2,
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
            above 16, so the batched expert products run, top-8 of 32; 2 of
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
16. zamba2  the zamba2 hybrid (after phase 15) at full width and 12 of 38
            layers: zamba2-1.2b (d 2048, d_in 4096, N 64, P 64, chunk 128; the
            shared attention + MLP block, 32 heads of D 64, d_ff 8192, a
            4096-token window, after every 6 Mamba2 layers: 2 calls a pass at
            12 layers; vocab 32000), built one layer at a time with the family
            phase's noise hook, packed with f32 values (k 4),
            ``gemm_impl="pallas"``. ``registry.forward`` on B2 x 256 tokens
            (the Mamba layers expanded layer by layer, the shared block
            streaming its packed planes through dbb_gemm) against the plain
            route: at f32 activations within ZAMBA_F32_TOL of max |h|, at bf16
            no farther from the f32 plain route than ZAMBA_BF16_MARGIN times
            the bf16 plain route is (bf16's own error here is ~3e-2 of max |h|,
            ~1.5e-2 of max |logit|). Greedy ``generate`` on both routes of 8
            prompts of 256 tokens (the chunked scan; 32 new), of a ragged batch
            of 64-200 tokens (the recurrence; 16 new; the pads-feed-the-state
            warning must be given) and of one 4608-token prompt (16 new; the
            ring wraps in the prefill; one decode step must write ring slot
            4608 % 4096 and no other): prefill logits within LOGIT_TOL of max
            at f32 activations and, at bf16, by the forward's margin rule;
            streams equal outside the split rule at bf16's reach (gaps
            recomputed on each row's own context: a zamba2 row's pads feed its
            state); ms a decode step and time to first token on both routes. A
            sampled generate of the 8 prompts on the kernel route through
            head_sample_fused with ``draft_k=2`` refused (the warning; the
            temperature-0 row equal to the greedy stream, the others moved by
            the noise); serve of 12 requests through max_batch 8 as static
            waves (the warning), streams equal to generate on the same waves;
            two training steps through ``launch.train`` at B4 S256 (plain
            route, no launch, finite loss and parameters, peak memory); the
            serve CLI (``--full --packed --gemm-impl pallas --batch 8``). Every
            run's launches equal exactly those the config implies: per prefill
            or decode call one shared-block call a group of 6 Mamba2 layers,
            each with its MLP's three
            GEMMs on the route the table picks (the engine expands the shared
            block, so its projections take the plain matmul and no DBB kernel
            runs; ``forward`` on the packed tree adds its four projections on
            dbb_gemm), flash_prefill once per shared-block call of a
            full-sequence pass, no paged_decode (the ring decode takes the
            plain route), one head a call. Then one Mamba layer's parts in a
            decode step (the transient expand, norm + in_proj, conv, SSD step,
            gate + norm, out_proj) and the 256-token chunked scan timed beside
            the decode step, and the kernels at the phase's new shapes, each
            against its plain version beside bound and library call
            (``zamba2_shapes`` in the kernels line): flash_prefill bf16 Hq =
            Hkv = 32 D 64 at B8 T=S=256 and B1 T=S=4608 with the 4096 window,
            sta_gemm at M2048 K2048 N8192 (gelu) and K8192 N2048,
            sta_gemm_skinny at the head (M8 K2048 N32000 f32) and
            head_sample_fused at M8 K2048 N32000.
17. rwkv6   rwkv6-1.6b (after phase 16) at full width and 8 of 24 layers (d
            2048, 32 WKV heads of D 64, d_ff 7168, vocab 65536, untied;
            its layers expanded from packed f32 planes layer by layer and
            run in plain PyTorch, as the reference runs them in plain XLA,
            so its paths launch the heads only): ``registry.forward`` on
            B2 x 256 (no launch) against the plain route at f32 within
            LM_F32_TOL and at bf16 by the LM_BF16_MARGIN rule (zamba2's);
            greedy ``generate`` on both routes of 8 prompts of 256 tokens
            (the chunked WKV; 32 new) and of a ragged batch of 64-200
            tokens (the recurrence; 16 new; the pads-feed-the-state
            warning), held as zamba2's; a sampled generate with
            ``draft_k=2`` refused (the warning; row 0 at temperature 0
            equal to the greedy stream); serve of 12 requests as static
            waves; two training steps (B4 S256) and the serve CLI
            (``--full --packed --gemm-impl pallas --batch 8``).
18. vlm_audio  paligemma-3b (6 of 18 layers: MQA, 8 query heads on one KV
            head of D 256; gated GeLU d_ff 16384; the tied f32 head
            [2048, 257216]) and musicgen-medium (12 of 48 layers: 24 heads of
            D 64, GeLU d_ff 6144, vocab 2048), packed f32 planes streamed
            through the DBB kernels: ``registry.forward`` on B2 x 256 (256
            prefix embeds in front for paligemma, frame embeds for
            musicgen), ``prefill`` from the family's own inputs then 4
            token decode steps, both by the forward's rules; greedy
            ``generate`` of 8 ragged prompts (64-200 tokens, 32 new) as
            above; ``serve`` of 12 requests in 64-slot pages: packed into
            the contiguous cache and into the paged pool (equal streams),
            paligemma's with 64-token chunks too (split rule against the
            packed streams), and sampled on the pool (paligemma: its head
            at vocab 257216, no multiple of head_sample_fused's 128-column
            tile, takes the plain sampler, as the reference's guard sends
            it; musicgen: ``draft_k=2``); two training steps each
            (paligemma B2 x (256 + 128), musicgen B4 S256); the serve
            CLI's refusal of both (the reference's own text). Every run of
            phases 17 and 18 launches exactly what its recorded entry-point
            and head calls imply (`_CallRecorder`, `_lm_expected`): per
            call and layer the four projections and the MLP's GEMMs on the
            kernels the route table picks, the attention kernel of the
            call's kind and cache, one head a call. Then the kernels at the
            new shapes beside plain version, bound and library call
            (``last_families_shapes``): flash_prefill / flash_prefill_packed
            at D 256 G 8 (the two-warpgroup tensor-core body),
            paged_decode at G 8 D 256, the greedy heads at N 257216 and
            65536, head_sample_fused at N 65536, and the paligemma and
            musicgen MLP GEMMs (dbb_gemm M512, dbb_gemm_skinny M8, and
            paligemma's N 256 K/V projection).
19. analysis  after int8 (phase 11): the port's verifier on the card,
            ``repro_torch.analysis.lint.run()``: one line a materialization
            check (``analysis:``; name, shape, the walker's largest tensor,
            the allocator's peak requested / allocated, out + workspace and
            the dense bound, in bytes), the absence claims per kernel route
            (no [B,Hq,T,S] scores on the flash prefills, no [Hq,T,T] on the
            packed one, no dense [K,N] on dbb_gemm / dbb_gemm_skinny on the
            f32, INT8 and w4 planes with bf16 and int8 x, no gathered
            [B,S,Hkv,D] K/V in paged decode, no [M,V] logits in the
            sampling head, no [M,K] im2col in conv_gemm / conv_gemm_dbb, a
            full-width olmo-1b decode step with no [K,N] of a packed leaf
            and 0 ``decompress`` calls, > 0 on the plain route), each
            kernel's launch counted; one line a shared-memory body
            (``smem:``; its instances' largest dynamic + ptxas static bytes
            against the card's opt-in limit); the workspace split counts
            against the libraries'; the dispatch sweep, the tp-smem pass
            and the layering. Any violation fails the run.
20. tp      after sample (phase 6): tensor-parallel serving. Each rank is
            a process spawned (the ``spawn`` start method) on cuda:0 that
            joins a gloo world through a ``file://`` store: the ranks
            share one H100, so this holds the port at the shard shapes,
            not TP speed (NCCL refuses two ranks on one device). olmo-1b
            at full width and 16 layers, packed f32 planes (k 4), built
            by every rank from seed 0 as the slice phase builds them,
            under ``use_mesh(make_mesh(1, tp))``: the engine's TP wrap on
            every rank (column-parallel QKV and up-projections,
            row-parallel o_proj / wo with one boundary all-reduce each,
            local KV heads, the vocab-parallel embedding and head).
            Both worlds start at once; the 4-rank one sets up and waits
            for a gate that opens when the 2-rank one is done.
            tp 2 and 4: f32 ``generate`` of the slice's 8 prompts (64 new
            at tp 2, 16 at tp 4, where four contexts time-share the card):
            prefill logits within TP_LOGIT_TOL of the single-device kernel
            route, greedy streams equal outside the split rule, every
            rank's kernels launched as often as the single device's, 0
            ``decompress`` calls, the ranks' streams equal. tp 2 only:
            bf16 ``serve`` of the serve phase's first 8 requests (packed
            prefill, paged, 256-token chunks): their logits no farther
            from the f32 single-device route than LM_BF16_MARGIN times
            the single-device bf16 route's own distance, streams against
            the serve phase's ``serve_chunked`` streams by the split rule
            at that distance, kernels as its; a sampled ``draft_k=2``
            serve of 3 requests (request 0 at temperature 0 against its
            greedy stream); expert parallelism on arctic-480b's config
            (2 layers, 16 experts, w4 planes, f32 activations; the wrap
            stays off for MoE, each rank runs its 8 experts and one
            all-reduce sums them) against the single-device kernel route
            at TP_LOGIT_TOL, each rank's expert window read from its MoE
            dispatches, its expert GEMMs launched half as often as the
            single device's and its other kernels as often. The routes ``dispatch.explain(tp=2,
            collective=...)`` picks at olmo's M8 / M512 GEMMs and head are
            the kernels the ranks launched. The collectives' host ms a
            decode step is printed (gloo on one card). Then the kernels at
            the 2-rank shard shapes (``tp_shapes`` in the kernels line):
            dbb_gemm / dbb_gemm_skinny at N/2 and K/2, sta_gemm, the
            greedy head at N 25152, paged_decode at 8 KV heads, the flash
            prefills at 8 heads, and head_sample_fused on a 128-aligned
            column slice with ``base`` 25088 (olmo's N/2 is no multiple of
            its tile, so the TP sampled head takes the plain sampler).

21. tp_train after train (phase 14): training on a mesh. Two gloo
            worlds spawned on cuda:0 at once, of 2 and 4 ranks, each
            running its jobs in turn (a gated job once the parent opens
            its gate): olmo-1b at full width cut to TP_TRAIN_LAYERS
            layers, f32, B8 S256, AdamW, the DBB bound annealed 8 -> 4
            over TP_TRAIN_STEPS steps, on 1 x 2 (TP + sequence
            parallelism) and 2 x 2 (data x model; ZeRO on every leaf at
            this width): each step's loss and grad norm within
            TP_TRAIN_LOSS_RTOL of one device's (run here first, its params
            saved after every step), the ranks' update (params less the
            initial tree) within TP_TRAIN_UPDATE_RTOL of its update,
            relative to its size, and their params within
            TP_TRAIN_PARAM_TOL of its params, the step's ms, no kernel launch while training, each rank's peak
            device memory beside one device's and the split leaves' (with
            their Adam moments) bytes on a rank against whole; arctic-480b's
            expert-parallel training on 1 x 2 (TP_TRAIN_MOE: 16 experts,
            1 layer, f32, SGD) against one device's loss, aux and grad
            norm; the
            training CLI (``python -m repro_torch.launch.train``
            TP_TRAIN_ARGV ``--mesh 2x2``) as 4 torchrun-style ranks (the
            env:// variables set, ``launch.train.main`` called in process,
            the depth cut and a metric line every step by patching its
            ``get_config`` and run config) with a checkpoint after each
            step, its first line naming the mesh and backend, every step's
            loss and grad norm against ``--mesh none`` run here;
            then a run that resumes from the checkpoint before the last,
            whose last checkpoint must equal the straight run's leaf for
            leaf (bit-exact); that checkpoint restored on one device (its
            update within TP_TRAIN_CLI_UPDATE_RTOL of ``--mesh none``'s,
            bf16 activations), projected at k 4, packed as f32 planes and greedy-served
            through the kernels against the one-device run's tree
            (logits within TP_TRAIN_LOGIT_TOL, streams by the
            split rule; its launches are the ``tp_train_serve_f32`` path).
22. dryrun  after serve (phase 5): per-step costs. (i) olmo-1b at full
            width and depth (the slice phase's packed f32 planes, bf16,
            ``gemm_impl="pallas"``): one B8 decode step on the serve
            phase's paged pool (64-slot pages, DRYRUN_SMAX slots a row)
            and one packed prefill of DRYRUN_PREFILL_LENS, each counted by
            ``roofline.counts.count_step`` on the card and on the meta
            device (the tree's meta twin, the same inputs as shapes):
            flops, each route's calls, flops and bytes, and the collective
            bytes must be equal, and each route's calls must equal its
            kernel's launches (ROUTE_KERNEL); each step's measured time
            (CUDA events around the whole step, median of
            DRYRUN_STEP_REPS after warm-up) is printed beside
            ``roofline_terms``' step_time_lb and roofline_fraction, and
            the allocator's peak above the step's inputs
            (``max_memory_allocated``) must lie within ALLOC_ROUND bytes
            an allocation of the counter's peak. (ii) DRYRUN_CELLS through
            ``python -m repro_torch.launch.dryrun`` (olmo-1b decode_32k
            pod --packed, qwen2.5-14b train_4k pod), started on the host
            after the build and run beside phases 3-5, must end "ok";
            their roofline dicts are printed.

Every bf16 launch of sta_gemm, dbb_gemm and the two flash prefills on the
main paths of phases 4-6, 8, 9, 12-14, 16-18, 20 (bf16) and 22 must have run
the tensor-core body: ``sta_gemm_tc`` equals ``sta_gemm``, ``dbb_gemm_tc`` equals the f32,
``_i8`` and ``_w4`` branches' sum, ``flash_prefill_tc`` equals
``flash_prefill`` and ``flash_prefill_packed_tc`` equals
``flash_prefill_packed`` on each of those runs (their activations are bf16,
D 64, 128 or 256), or the run fails. Likewise every float dbb_gemm_skinny
launch of phases 4-9, 12-18, 20 and 22 must have run the split-K body
(``dbb_gemm_skinny_split`` equals the f32, ``_i8`` and ``_w4`` branches'
sum) and every f32-x dbb_gemm launch (the CNN classifier, N 10) the narrow
body (``dbb_gemm_narrow`` equals ``dbb_gemm`` on the CNN runs, 0 on the
LM runs).

The line before the last is the per-kernel JSON record (``launches``: the
sum over the main-path runs of phases 4-9, 11 (a)-(b), 12-18, 20 (rank
0's counts), 21 (the served tree) and 22 (the counted card steps);
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
import collections
import contextlib
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

    t_start = time.perf_counter()
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
    t_build = time.perf_counter() - t0
    print(f"build: {t_build:.1f} s wall "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})")
    _ptxas_report(build)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        for f in build.BUILD_DIR.glob("*.log"):
            shutil.copy(f, os.path.join(args.out, f.name))

    report = {"card": card, "phase_s": {}}
    # the dry-run cells run on the host beside the card's phases
    dryrun_cells = _dryrun_spawn(args.out)

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
    dryrun_counts, ok = timed("dryrun", _dryrun_phase, packed, dryrun_cells)
    if not ok:
        return _fail("the dryrun phase failed (see above)")
    by_path["dryrun_steps"] = dryrun_counts
    del packed
    sample_counts, ok = timed("sample", _sample_phase, args.out)
    if not ok:
        return _fail("the sample phase failed (see above)")
    by_path.update(sample_counts)
    tp_counts, ok = timed("tp", _tp_phase, args.out)
    if not ok:
        return _fail("the tensor-parallel phase failed (see above)")
    by_path.update(tp_counts)
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
    # the mesh-training ranks start and warm up while the train phase runs
    tp_train = _tp_train_spawn(torch, dev)
    train_counts, train_cnn, ok = timed("train", _train_phase)
    if not ok:
        _tp_train_stop(tp_train)
        return _fail("the training phase failed (see above)")
    by_path.update(train_counts)
    tp_train_counts, ok = timed("tp_train", _tp_train_phase, tp_train)
    if not ok:
        return _fail("the mesh-training phase failed (see above)")
    by_path.update(tp_train_counts)
    moe_counts, ok = timed("moe", _moe_phase, args.out)
    if not ok:
        return _fail("the moe_lm family phase failed (see above)")
    by_path.update(moe_counts)
    zamba_counts, ok = timed("zamba2", _zamba_phase, args.out)
    if not ok:
        return _fail("the zamba2 phase failed (see above)")
    by_path.update(zamba_counts)
    rwkv_counts, ok = timed("rwkv6", _rwkv_phase, args.out)
    if not ok:
        return _fail("the rwkv6 phase failed (see above)")
    by_path.update(rwkv_counts)
    vlm_counts, ok = timed("vlm_audio", _vlm_audio_phase, args.out)
    if not ok:
        return _fail("the vlm / audio phase failed (see above)")
    by_path.update(vlm_counts)
    cnn_paths = list(cnn_counts) + train_cnn
    # the moe paths check their tensor-core counts themselves (kimi's D 112
    # prefill runs the FMA body; the CLI run's smoke config is f32), and
    # the tp phase's f32 runs take no tensor-core body
    lm = [p for p in by_path
          if p not in cnn_paths and not p.startswith("moe_")
          and not (p.startswith("tp") and p.endswith("_f32"))]
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
    if not timed("analysis", _analysis_phase):
        return _fail("the analysis phase found violations (see above)")
    for entry in kernels:
        name = entry["name"]
        moe = {k: v for k, v in report["moe"]["kernels"].items()
               if k.startswith(name + " ")}
        if moe:
            entry["moe_shapes"] = moe
        zamba = {k: v for k, v in report["zamba2"]["kernels"].items()
                 if k.startswith(name + " ")}
        if zamba:
            entry["zamba2_shapes"] = zamba
        last = {k: v for k, v in report["vlm_audio"]["kernels"].items()
                if k.startswith(name + " ")}
        if last:
            entry["last_families_shapes"] = last
        tp = {k: v for k, v in report["tp"]["kernels"].items()
              if k.startswith(name + " ")}
        if tp:
            entry["tp_shapes"] = tp
        entry["launches"] = sum(c[name] for c in by_path.values())
        entry["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
    report["total_s"] = time.perf_counter() - t_start
    print(f"total: {report['total_s']:.1f} s (build {t_build:.1f} s; "
          + ", ".join(f"{k} {v:.1f} s" for k, v in report["phase_s"].items())
          + ")")
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
    report["serve"]["streams"] = outs
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
QUARTER_DEPTH = ("the cli phase runs every layer; a quarter of the depth "
                 "here keeps the script in its time limit beside the train "
                 "and tp phases")
FAMILY_MODELS = (
    ("starcoder2-15b", 10, QUARTER_DEPTH),
    ("qwen2.5-14b", 12, QUARTER_DEPTH),
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
# the run resumes from its --checkpoint-every checkpoint. 50 steps: the
# checks need a falling loss, a bit-exact resume over two logged steps (30
# and 40) and a trained tree, not a longer curve (at 70 steps the straight
# and resumed runs took 59.9 + 36.6 s of the script's 1200 s on the H100;
# the mesh-training phase took the time)
TRAIN_LM_ARGV = ("--arch olmo-1b --full --steps 50 --seq-len 256 --batch 8 "
                 "--dbb-ramp 25 --checkpoint-every 30")
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
    ("arctic-480b", 16, 4,
     "experts 128 -> 16, the reference's fused-expert ceiling "
     "(_FUSED_EXPERT_MAX; at 128 one layer's w4 planes take ~5.5 GB and "
     "its dense expand ~27 GB of bf16, and the batched expert route is "
     "kimi's run); layers 35 -> 4 keep the script's time"),
    ("kimi-k2-1t-a32b", 32, 2,
     "experts 384 -> 32 (above 16, so the expert FFN takes the batched "
     "route, top-8 of 32); layers 61 -> 2 keep the script's time"))
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


def _check_launches(phase, tag, counts, want):
    """Every kernel's launches against ``want`` (missing keys: zero)."""
    got = {k: v for k, v in counts.items() if v}
    ok = got == want
    print(f"{phase}: {tag}: launches {got}; expected from the config {want} "
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
    ok = _check_launches("moe", path, counts, want) and ok

    if short == "arctic":
        runs, outs = _moe_serve(torch, dev, arch, cfg, tree, rec)
        for name, (counts, calls, prefills, steps) in runs.items():
            attn = {"flash_prefill_packed": layers * prefills,
                    "paged_decode": layers * steps}
            want = _moe_expected(torch, cfg, calls, prefills + steps, head,
                                 attn)
            path = f"moe_{short}_{name}"
            by_path[path] = counts
            ok = _check_launches("moe", path, counts, want) and ok
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
            ok = _check_launches("moe", path, counts, want) and ok
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


def _analysis_phase(torch, dev, report):
    """Phase 19: ``repro_torch.analysis.lint.run()`` on the card; a line a
    materialization case and a shared-memory body, the rest by count.
    True when every pass is clean."""
    from repro_torch.analysis import lint
    torch.cuda.empty_cache()
    rep = lint.run(device="cuda")
    report["analysis"] = rep
    for r in rep["passes"]["materialize"]["rows"]:
        if "skipped" in r:
            print(f"analysis: {r['check']}: SKIPPED ({r['skipped']})")
            continue
        extra = "".join(
            f", {k} {v}" for k, v in (
                ("out + workspace", r["allowed_bytes"]),
                ("dense", r["dense_bytes"]), ("launches", r["launches"]),
                ("decompress calls", r["decompress_calls"])) if v)
        print(f"analysis: {r['check']} [{r['case']}]: walker peak "
              f"{r['peak_bytes']} B ({r['peak_op']}), allocator peak "
              f"{r['requested_peak']} B requested / {r['alloc_peak']} B "
              f"allocated{extra}")
    bodies = {}
    for r in rep["passes"]["smem"]["rows"]:
        if r["admitted"]:
            name = r["name"].split("[")[0]
            total = r["dynamic"] + (r["static"] or 0)
            if total > bodies.get(name, (0,))[0]:
                bodies[name] = (total, r)
    for name, (total, r) in bodies.items():
        print(f"smem: {name}: largest admitted {r['name']}: dynamic "
              f"{r['dynamic']} B + static {r['static']} B = {total} B of "
              f"{r['limit']} B")
    splits = [r for r in rep["passes"]["workspace"]["rows"]
              if "library" in r]
    print(f"analysis: {len(splits)} split counts, Python rule == library "
          f"on {sum(r['python'] == r['library'] for r in splits)}")
    for name, p in rep["passes"].items():
        print(f"analysis pass {name}: checked {p['checked']}, "
              f"{len(p['violations'])} violation(s)")
        for v in p["violations"]:
            print(f"  FAIL [{v['code']}] {v['subject']}: {v['message']}")
    return rep["ok"]


# ---------------------------------------------------------------------------
# phase 16: the zamba2 hybrid at full width and full depth
# ---------------------------------------------------------------------------

ZAMBA_ARCH = "zamba2-1.2b"
ZAMBA_FWD = (2, 256)                  # forward: B2 x 256 tokens
ZAMBA_LEN, ZAMBA_NEW = 256, 32        # 8 prompts of two scan chunks each
# left-padded to 200 tokens, no multiple of the chunk: the recurrence
ZAMBA_RAGGED, ZAMBA_RAGGED_NEW = [200, 64, 137, 90, 175, 112, 153, 71], 16
ZAMBA_LONG, ZAMBA_LONG_NEW = 4608, 16  # past the 4096-token window
ZAMBA_SERVE_LENS = [96, 40, 72, 17, 55, 128, 33, 80, 64, 21, 100, 48]
ZAMBA_SERVE_BUDGETS = [8, 16, 12, 10, 14, 9, 16, 11, 13, 8, 15, 12]
# forward hidden states at f32 activations, kernel vs plain route, of max
# |h| (both routes take the same f32 products in another order)
ZAMBA_F32_TOL = 1e-4
# at the config's bf16 activations the plain route's own rounding moves
# zamba2's O(1) logits (an untied random head) by ~1.7e-2 of max and its
# hidden states by ~3e-2 against the same route at f32, growing block by
# block through the 45 residual blocks: far above LOGIT_TOL. So the bf16
# kernel route is held against the f32 plain route, within this factor of
# the bf16 plain route's own distance from it, and a stream split is
# excused where the plain route's gap is within twice that distance
ZAMBA_BF16_MARGIN = 1.5
ZAMBA_TRAIN_ARGV = ("--arch zamba2-1.2b --full --steps 2 --seq-len 256 "
                    "--batch 4")
ZAMBA_CLI_ARGV = ("--arch zamba2-1.2b --full --packed --gemm-impl pallas "
                  "--batch 8")
# a GEMM route's kernel and the body counter beside it
ZAMBA_GEMM_KERNELS = dict(MOE_GEMM_KERNELS, dbb_packed="dbb_gemm",
                          skinny_dbb="dbb_gemm_skinny")
ZAMBA_WARN_RAGGED = "ragged batch pads feed the recurrent state"
ZAMBA_WARN_SPEC = "has no slot-addressed K/V cache for batched verify"
ZAMBA_WARN_WAVES = "falling back to static waves"


def _zamba_expected(torch, cfg, calls, head=None, packed=False):
    """The launches the config implies for ``calls`` [(kind, rows, M)]:
    kind "prefill" (M = rows x tokens), "decode" (M = rows) or "forward"
    (no head). Each call runs the shared block once per group (7 at full
    depth): on a packed block (``forward`` on the packed tree) its four
    attention projections and three MLP GEMMs, on the expanded block
    (the engine's) its three MLP GEMMs (the projections take the plain
    matmul, as in the reference), each on the kernel the route table
    picks; flash_prefill once per group on a full-sequence call (decode
    attention on the ring takes the plain route: no paged_decode); and
    ``head`` once per prefill or decode call. The body counters follow
    their rules (`sta_gemm.ops.tc_body`, `dbb_gemm.ops.tc_body`,
    `attn.ops.tc_body`; a float DBB skinny launch runs the split-K
    body)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attn.ops import tc_body as flash_tc
    from repro_torch.kernels.sta_gemm.ops import tc_body as gemm_tc
    from repro_torch.models.common import dtype_of
    from repro_torch.models.transformer import _n_groups
    dt = dtype_of(cfg)
    d, f = cfg.d_model, cfg.d_ff
    hq = cfg.num_heads * cfg.resolved_head_dim
    hkv = cfg.num_kv_heads * cfg.resolved_head_dim
    groups = _n_groups(cfg)
    want, memo = {}, {}

    def add(name, n=1):
        want[name] = want.get(name, 0) + n

    def kernel(m, k, n, ops):
        key = (m, k, n, ops)
        if key not in memo:
            memo[key] = ZAMBA_GEMM_KERNELS.get(dispatch.explain(
                "matmul", m=m, k=k, n=n, dtype=dt, cfg=cfg, packed=packed,
                epilogue_ops=ops)[0].name)
        return memo[key]

    for kind, rows, m in calls:
        gemms = [(m, d, f, 0), (m, d, f, 1), (m, f, d, 0)]
        if packed:
            gemms += [(m, d, hq, 0), (m, d, hkv, 0), (m, d, hkv, 0),
                      (m, hq, d, 0)]
        for g in gemms:
            name = kernel(*g)
            if name is None:
                continue
            add(name, groups)
            if name == "sta_gemm" and gemm_tc(dt, g[1], g[2]):
                add("sta_gemm_tc", groups)
            elif name == "dbb_gemm" and dt == torch.bfloat16:
                add("dbb_gemm_tc", groups)
            elif name == "dbb_gemm_skinny":
                add("dbb_gemm_skinny_split", groups)
        if kind != "decode":
            add("flash_prefill", groups)
            if flash_tc(dt, cfg.resolved_head_dim):
                add("flash_prefill_tc", groups)
        if kind != "forward":
            add(head)
    return want


def _zamba_logits(torch, dev, engine):
    """`_logits_fn` one context at a time, for contexts of unequal length:
    a zamba2 row's pads feed its recurrent state, so a context is run
    exactly as its generate row ran it (its own left pads, given in the
    context, and no others)."""
    base = _logits_fn(torch, dev, engine)

    def last_logits(c, contexts):
        return torch.cat([base(c, [t]) for t in contexts])
    return last_logits


def _zamba_generate(torch, dev, cfg, tree, prompts, new, sampling=None):
    """`_lm_generate` with ``draft_k=2`` asked on a sampled call: (tokens,
    counts, decode steps, engine, warnings, times)."""
    out, counts, _, engine, warned, times = _lm_generate(
        torch, dev, cfg, tree, prompts, new, sampling,
        draft_k=None if sampling is None else 2)
    return out, counts, times["steps"], engine, warned, times


def _zamba_warned(warned, need) -> bool:
    """The run's warnings are exactly ``need``, in order (substrings)."""
    return (len(warned) == len(need)
            and all(n in w for n, w in zip(need, warned)))


def _zamba_run(torch, dev, tag, cfg, tree, prompts, new, rec):
    """One greedy batch on the kernel route and on the plain route:
    prefill logits at f32 activations within LOGIT_TOL of max |logit|;
    at bf16, the kernel route's no farther from the f32 plain route than
    ZAMBA_BF16_MARGIN times the bf16 plain route's own distance from it
    (bf16's reach); streams equal outside the split rule at that reach;
    launches exactly those the config implies; ms per decode step and
    the time to first token on both routes: (kernel tokens, counts,
    engine, bf16 plain-route logits, ok)."""
    from repro_torch.models.transformer import _n_groups
    from repro_torch.serve.engine import ServeEngine
    xcfg = cfg.replace(gemm_impl="xla")
    out, counts, steps, engine, warned, kt = _zamba_generate(
        torch, dev, cfg, tree, prompts, new)
    xout, _, _, _, _, pt = _zamba_generate(torch, dev, xcfg, tree, prompts,
                                           new)
    # the rows as generate ran them: each with its own left pads (equal
    # widths, so the batch adds none)
    pads = [[0] * (max(map(len, prompts)) - len(p)) + p for p in prompts]
    last_logits = _logits_fn(torch, dev, engine)
    lk, lp = last_logits(cfg, pads), last_logits(xcfg, pads)
    cfg32 = cfg.replace(dtype="float32")
    e32 = ServeEngine(cfg32, tree, max_batch=len(prompts), device=dev)
    logits32 = _logits_fn(torch, dev, e32)
    lk32 = logits32(cfg32, pads)
    lp32 = logits32(cfg32.replace(gemm_impl="xla"), pads)
    del e32
    scale = lp32.abs().max().item()
    f32 = (lk32 - lp32).abs().max().item()
    reach = (lp - lp32).abs().max().item()         # bf16's own reach
    diff = (lk - lp32).abs().max().item()
    same, total, split = _split_rows(out, xout)
    gaps = _split_gaps(torch, _zamba_logits(torch, dev, engine), xcfg, pads,
                       out, xout, split)
    rows = len(prompts)
    want = _zamba_expected(torch, cfg, [("prefill", rows, rows * len(pads[0]))]
                           + [("decode", rows, rows)] * steps,
                           _head_kernel(torch, cfg, rows))
    ragged = len(set(map(len, prompts))) > 1
    ok = (f32 <= LOGIT_TOL * scale and diff <= ZAMBA_BF16_MARGIN * reach
          and all(g <= 2 * reach for g in gaps)
          and _zamba_warned(warned, [ZAMBA_WARN_RAGGED] if ragged else []))
    print(f"zamba2: {tag}: {rows} prompt(s) of "
          f"{sorted(set(map(len, prompts)))} tokens, {new} new: prefill "
          f"last-position logits, of max |logit| "
          f"{scale:.4e}: f32 activations, kernel vs plain route "
          f"{f32 / scale:.3e} (tol {LOGIT_TOL:g}); bf16 against the f32 "
          f"plain route: plain {reach / scale:.3e}, kernel {diff / scale:.3e}"
          f" (tol {ZAMBA_BF16_MARGIN:g} x plain's); tokens {same}/{total} "
          f"equal; splits (row, step, plain-route gap; bound "
          f"{2 * reach:.4e}) {[(i, j, g) for (i, j), g in zip(split, gaps)]}"
          f"; warnings {warned} {'ok' if ok else 'FAIL'}")
    print(f"zamba2: {tag}: kernel route decode "
          f"{kt['decode_ms_per_step']:.3f} ms/step over {steps} steps, ttft "
          f"{kt['ttft_ms']:.1f} ms; plain route decode "
          f"{pt['decode_ms_per_step']:.3f} ms/step, ttft {pt['ttft_ms']:.1f} "
          f"ms ({_n_groups(cfg)} shared-block calls a step)")
    rec[tag] = dict(kernel=kt, plain=pt, logit_f32_diff=f32,
                    logit_bf16_plain_diff=reach, logit_bf16_kernel_diff=diff,
                    logit_scale=scale, token_agreement=[same, total],
                    token_splits=[[i, j, g] for (i, j), g in zip(split, gaps)],
                    warnings=warned, launches={k: v for k, v in counts.items()
                                               if v})
    ok = _check_launches("zamba2", tag, counts, want) and ok
    return out, counts, engine, lp, ok


def _zamba_sampled(torch, dev, cfg, tree, prompts, greedy, lp, rec):
    """A sampled generate of the greedy batch on the kernel route, with
    ``draft_k=2`` asked (refused with the warning): one head_sample_fused
    launch a call, row 0 (temperature 0, no penalty) equal to the greedy
    stream token for token (the sampling epilogue at T 0 is the greedy
    head bit for bit), and other rows moved by the noise (temperatures of
    SAMPLE_T_SPREAD times the plain route's logit spread ``lp``):
    (counts, ok)."""
    from repro_torch.serve.sampling import SamplingParams
    spread = statistics.median(lp.std(dim=-1).tolist())
    n = len(SAMPLE_T_SPREAD)
    sp = [SamplingParams(
        temperature=0.0 if i == 0 else spread * SAMPLE_T_SPREAD[i % n],
        seed=i * 7919 + 1) for i in range(len(prompts))]
    out, counts, steps, _, warned, kt = _zamba_generate(
        torch, dev, cfg, tree, prompts, ZAMBA_NEW, sampling=sp)
    rows = len(prompts)
    want = _zamba_expected(torch, cfg, [("prefill", rows, rows * ZAMBA_LEN)]
                           + [("decode", rows, rows)] * steps,
                           "head_sample_fused")
    moved = sum(a != b for s, g in zip(out[1:], greedy[1:])
                for a, b in zip(s, g))
    ok = (out[0] == greedy[0] and moved > 0
          and _zamba_warned(warned, [ZAMBA_WARN_SPEC]))
    print(f"zamba2: generate_sampled: {rows} prompts of {ZAMBA_LEN} tokens, "
          f"{ZAMBA_NEW} new, temperatures "
          f"{[round(p.temperature, 3) for p in sp]}, draft_k=2 asked: row 0 "
          f"(T 0) {'equal to' if out[0] == greedy[0] else 'DIFFERS FROM'} "
          f"the greedy stream; {moved} tokens of the other rows moved; "
          f"warnings {warned}; decode {kt['decode_ms_per_step']:.3f} ms/step"
          f", ttft {kt['ttft_ms']:.1f} ms {'ok' if ok else 'FAIL'}")
    rec["generate_sampled"] = dict(kernel=kt, moved=moved, warnings=warned,
                                   launches={k: v for k, v in counts.items()
                                             if v})
    ok = _check_launches("zamba2", "generate_sampled", counts, want) and ok
    return counts, ok


def _zamba_forward(torch, dev, cfg, tree, rec):
    """`registry.forward` on B2 x 256 tokens, kernel route (the shared
    block streams its packed planes through dbb_gemm) against the plain
    route: at f32 activations within ZAMBA_F32_TOL of max |h|; at bf16
    no farther from the f32 plain route than ZAMBA_BF16_MARGIN times the
    bf16 plain route's own distance from it; exact launches."""
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.models import registry
    b, s = ZAMBA_FWD
    toks = torch.randint(2, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(3)).to(dev)
    xcfg = cfg.replace(gemm_impl="xla")
    with torch.no_grad():
        registry.forward(tree, cfg, {"tokens": toks})       # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        hk, _ = registry.forward(tree, cfg, {"tokens": toks})
        torch.cuda.synchronize()
        tk = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        t0 = time.perf_counter()
        hp, _ = registry.forward(tree, xcfg, {"tokens": toks})
        torch.cuda.synchronize()
        tp = time.perf_counter() - t0
        hk32, _ = registry.forward(tree, cfg.replace(dtype="float32"),
                                   {"tokens": toks})
        hp32, _ = registry.forward(tree, xcfg.replace(dtype="float32"),
                                   {"tokens": toks})
    scale = hp32.abs().max().item()
    f32 = (hk32 - hp32).abs().max().item() / scale
    own = (hp.float() - hp32).abs().max().item() / scale
    kern = (hk.float() - hp32).abs().max().item() / scale
    routes = (hk.float() - hp.float()).abs().max().item() / scale
    ok = (f32 <= ZAMBA_F32_TOL and kern <= ZAMBA_BF16_MARGIN * own
          and bool(torch.isfinite(hk).all()))
    print(f"zamba2: forward B{b} x {s}: hidden states, of max |h| "
          f"{scale:.4e}: f32 activations, kernel vs plain route "
          f"{f32:.3e} (tol {ZAMBA_F32_TOL:g}); bf16 against the f32 plain "
          f"route: plain {own:.3e}, kernel {kern:.3e} (tol "
          f"{ZAMBA_BF16_MARGIN:g} x plain's); bf16 kernel vs plain route "
          f"{routes:.3e} {'ok' if ok else 'FAIL'}; bf16 kernel route "
          f"{tk * 1e3:.1f} ms, plain route {tp * 1e3:.1f} ms")
    want = _zamba_expected(torch, cfg, [("forward", b, b * s)], packed=True)
    rec["forward"] = dict(f32_diff_of_max=f32, bf16_plain_of_max=own,
                          bf16_kernel_of_max=kern, bf16_routes_of_max=routes,
                          kernel_ms=tk * 1e3, plain_ms=tp * 1e3)
    ok = _check_launches("zamba2", "forward", counts, want) and ok
    return counts, ok


def _zamba_ring(torch, dev, cfg, engine, long):
    """The long prompt's prefill on the kernel route, then one decode
    step: past the window the step writes ring slot ``length % win`` and
    no other, in every group."""
    from repro_torch.models import registry
    cache = registry.init_cache(cfg, 1, len(long) + ZAMBA_LONG_NEW,
                                device=dev)
    win = cache["shared_k"].shape[2]
    with torch.no_grad():
        _, cache = registry.prefill(engine.params, cfg,
                                    torch.tensor([long], device=dev), cache)
        before = cache["shared_k"].clone()
        registry.decode_step(engine.params, cfg,
                             torch.tensor([5], device=dev), cache)
    changed = (cache["shared_k"] != before).any(dim=-1).any(dim=-1)[:, 0]
    slots = sorted({int(i) for i in changed.nonzero()[:, 1]})
    ok = slots == [len(long) % win]
    print(f"zamba2: ring: window {win}, prompt {len(long)}: the decode step "
          f"wrote ring slot(s) {slots} (expected {[len(long) % win]}) "
          f"{'ok' if ok else 'FAIL'}")
    return ok


def _zamba_serve(torch, dev, cfg, tree, rec):
    """``serve`` of 12 ragged requests through max_batch 8: static waves
    (the warning), streams equal to ``generate`` on the same waves cut to
    the budgets, and exactly the launches those waves' calls imply."""
    import warnings

    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.serve.engine import ServeEngine
    gen = torch.Generator().manual_seed(4)
    reqs = [torch.randint(2, cfg.vocab_size, (n,), generator=gen).tolist()
            for n in ZAMBA_SERVE_LENS]
    engine = ServeEngine(cfg, tree, max_batch=8, device=dev)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        engine.serve(reqs[:2], max_new_tokens=2)              # warm-up
        torch.cuda.synchronize()
        seen.clear()
        reset_launches()
        t0 = time.perf_counter()
        outs = engine.serve(reqs, max_new_tokens=ZAMBA_SERVE_BUDGETS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        warned = [str(w.message) for w in seen]
        # the same waves through generate: the streams, and each wave's
        # calls (8 rows: generate pads a short wave to max_batch)
        want_out, calls = [], []
        for i in range(0, len(reqs), 8):
            wave, bud = reqs[i:i + 8], ZAMBA_SERVE_BUDGETS[i:i + 8]
            res = engine.generate(wave, max_new_tokens=max(bud))
            want_out += [r[:n] for r, n in zip(res, bud)]
            calls += ([("prefill", 8, 8 * max(map(len, wave)))]
                      + [("decode", 8, 8)] * engine.last_decode_steps)
    same = outs == want_out
    waves = any(ZAMBA_WARN_WAVES in w for w in warned)
    n_tok = sum(len(o) for o in outs)
    ok = same and waves
    print(f"zamba2: serve: {len(reqs)} requests (lengths "
          f"{ZAMBA_SERVE_LENS}), budgets {ZAMBA_SERVE_BUDGETS}, max_batch "
          f"8: {wall * 1e3:.1f} ms, {n_tok / wall:.1f} generated tokens/s; "
          f"streams {'equal to' if same else 'DIFFERENT FROM'} generate on "
          f"the same waves; static-wave warning "
          f"{'given' if waves else 'MISSING'} {'ok' if ok else 'FAIL'}")
    rec["serve"] = dict(wall_ms=wall * 1e3, tokens=n_tok, warnings=warned,
                        launches={k: v for k, v in counts.items() if v})
    want = _zamba_expected(torch, cfg, calls, _head_kernel(torch, cfg, 8))
    ok = _check_launches("zamba2", "serve", counts, want) and ok
    return counts, ok


def _zamba_cli(torch, dev, rec):
    """The serve CLI (ZAMBA_CLI_ARGV) in process: its tables' routes
    against its launches (the packed decode-GEMM table's route held as its
    dense counterpart: the engine expands the shared block; the decode
    attention table's route held as the plain route: the shared block's
    cache is a ring), and exact launches from the config."""
    import gc
    import warnings

    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.launch import serve
    dense_of = {"skinny_dbb": "skinny_sta", "skinny_dbb_w4": "skinny_sta",
                "dbb_packed": "sta", "dbb_packed_w4": "sta"}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rep = {}
    reset_launches()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = serve.main(ZAMBA_CLI_ARGV.split(), report=rep)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    routes = dict(rep["routes"])
    routes["matmul"] = dense_of.get(routes["matmul"], routes["matmul"])
    routes["attn_decode"] = "attn_decode_xla"
    missing = [f"{dom} {r}" for dom, r in routes.items()
               if r in ROUTE_KERNELS
               and not sum(counts[k] for k in ROUTE_KERNELS[r])]
    cfg, rows = rep["cfg"], len(rep["prompts"])
    width = max(map(len, rep["prompts"]))
    steps = rep["engine"].last_decode_steps
    want = _zamba_expected(torch, cfg, [("prefill", rows, rows * width)]
                           + [("decode", rows, rows)] * steps,
                           _head_kernel(torch, cfg, rows))
    ok = rc == 0 and not missing
    print(f"zamba2: cli {ZAMBA_CLI_ARGV}: tables chose {rep['routes']} "
          f"(held as {routes}); build {rep['build_s']:.1f} s, tree "
          f"{rep['tree_bytes'] / 1e9:.3f} GB, peak device memory "
          f"{peak / 1e9:.3f} GB, wall {wall:.1f} s "
          + ("ok" if ok else f"FAIL: no launch of {missing}"))
    rec["cli"] = dict(argv=ZAMBA_CLI_ARGV, routes=rep["routes"],
                      build_s=rep["build_s"], tree_bytes=rep["tree_bytes"],
                      peak_bytes=peak, wall_s=wall)
    ok = _check_launches("zamba2", "cli", counts, want) and ok
    del rep
    gc.collect()
    torch.cuda.empty_cache()
    return counts, ok


def _zamba_decode_parts(torch, dev, cfg, engine, rec):
    """Where a decode step's time goes: one Mamba layer's parts at B8, T 1
    (the transient expand of its packed in/out projections, the norm and
    in_proj, the conv, the SSD step, the gate and norm, out_proj, and the
    whole layer) and the chunked scan of a B8 x 256 prefill, each as
    device time (`_time_ms`: median of single calls, L2 flushed) and as
    host time (a loop of calls, synchronised at its end, per call)."""
    import torch.nn.functional as F

    from repro_torch.models import mamba2 as m2
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import norm_apply
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    b = 8
    d_in, h, pp, n = m2._dims(cfg)
    lp = tf._unpack_layer(tf._layer(engine.params["layers"], 0), cfg)
    mp = lp["mamba"]
    dt_ = torch.bfloat16
    x = torch.randn((b, 1, cfg.d_model), generator=gen, device=dev).to(dt_)
    ctx = torch.randn((b, cfg.ssm.conv_width - 1, d_in + 2 * n),
                      generator=gen, device=dev).to(dt_)
    st = torch.zeros((b, h, pp, n), device=dev)
    hn = norm_apply(cfg.norm, lp["ln"], x)
    proj = hn @ mp["in_proj"]["w"]
    z, xs, bm, cm, dtr = m2._split_proj(cfg, proj)
    conv_in = torch.cat([xs, bm, cm], dim=-1)
    co, _ = m2._causal_conv(conv_in, mp["conv_w"].to(dt_),
                            mp["conv_b"].to(dt_), ctx)
    co = F.silu(co)
    xs2, bm2, cm2 = torch.split(co, [d_in, n, n], dim=-1)

    def ssd():
        dtv = m2._softplus(dtr.float() + mp["dt_bias"][None, None, :])
        la = dtv * -torch.exp(mp["a_log"])[None, None, :]
        xh = xs2.reshape(b, 1, h, pp).float() * dtv[..., None]
        y, _ = m2.ssd_recurrent(xh, bm2, cm2, la, st)
        return y + mp["d_skip"][None, None, :, None] * \
            xs2.reshape(b, 1, h, pp).float()
    y = ssd().reshape(b, 1, d_in).to(dt_)
    g = norm_apply("rmsnorm", mp["norm"], y * F.silu(z))
    packed = tf._layer(engine.params["layers"], 0)
    parts = {
        "expand (in_proj + out_proj planes -> bf16)":
            lambda: tf._unpack_layer(packed, cfg),
        "norm + in_proj": lambda: norm_apply(cfg.norm, lp["ln"], x)
            @ mp["in_proj"]["w"],
        "conv + silu": lambda: F.silu(m2._causal_conv(
            conv_in, mp["conv_w"].to(dt_), mp["conv_b"].to(dt_), ctx)[0]),
        "ssd step (softplus, decay, recurrence, skip)": ssd,
        "gate + norm": lambda: norm_apply("rmsnorm", mp["norm"],
                                          y * F.silu(z)),
        "out_proj": lambda: g @ mp["out_proj"]["w"],
        "whole layer (no expand)": lambda: m2.mamba2_apply(
            mp, cfg, hn, state=st, conv_ctx=ctx),
    }
    xc = torch.randn((b, ZAMBA_LEN, h, pp), generator=gen, device=dev)
    bc = torch.randn((b, ZAMBA_LEN, n), generator=gen, device=dev)
    cc = torch.randn((b, ZAMBA_LEN, n), generator=gen, device=dev)
    lc = -torch.rand((b, ZAMBA_LEN, h), generator=gen, device=dev)
    s0 = torch.zeros((b, h, pp, n), device=dev)
    parts[f"chunked scan B{b} x {ZAMBA_LEN} (prefill)"] = \
        lambda: m2.ssd_chunked(xc, bc, cc, lc, s0, chunk=cfg.ssm.chunk)
    res = {}
    with torch.no_grad():
        for name, fn in parts.items():
            dev_ms = _time_ms(torch, fn, flush)
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) / REPS * 1e3
            res[name] = dict(device_ms=dev_ms, host_ms=host_ms)
    step = rec["generate_b8"]["kernel"]["decode_ms_per_step"]
    layer = (res["expand (in_proj + out_proj planes -> bf16)"]["host_ms"]
             + res["whole layer (no expand)"]["host_ms"])
    for name, r in res.items():
        print(f"zamba2: decode parts: {name}: device {r['device_ms']:.4f} "
              f"ms, host {r['host_ms']:.4f} ms a call")
    print(f"zamba2: decode parts: {cfg.num_layers} Mamba layers x (expand + "
          f"layer) host time {cfg.num_layers * layer:.3f} ms of the "
          f"kernel route's {step:.3f} ms decode step "
          f"({100 * cfg.num_layers * layer / step:.1f}%)")
    rec["decode_parts"] = dict(parts=res, step_ms=step,
                               mamba_share=cfg.num_layers * layer / step)


def _zamba_phase(torch, dev, report, out_dir):
    """zamba2-1.2b at full width and LM_DEPTH's 12 of 38 layers (module
    doc, phase 16): (by_path, ok)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.core.dbb_linear import tree_footprint_bytes
    from repro_torch.models import registry
    rec = report["zamba2"] = {}
    t_phase = time.perf_counter()
    cfg = get_config(ZAMBA_ARCH).replace(gemm_impl="pallas",
                                         num_layers=LM_DEPTH[ZAMBA_ARCH])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree = registry.init_params_by_layer(cfg, seed=29, device=dev, pack=True,
                                         layer_hook=_family_noise)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    layer_bytes = tree_footprint_bytes(tree["layers"])
    print(f"zamba2: {cfg.name}: {cfg.num_layers} Mamba2 layers (d "
          f"{cfg.d_model}, d_in {cfg.ssm.expand * cfg.d_model}, N "
          f"{cfg.ssm.state_size}, P {cfg.ssm.head_dim}, chunk "
          f"{cfg.ssm.chunk}) with the shared block (32 heads of D "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, window "
          f"{cfg.ssm.shared_window}) after every {cfg.ssm.shared_period}; "
          f"vocab {cfg.vocab_size}; packed f32 planes (k 4) built layer by "
          f"layer in {t_build:.1f} s; layers {layer_bytes / 1e9:.3f} GB; "
          f"build peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB "
          f"({report['card']})")
    rec.update(build_s=t_build, layer_bytes=layer_bytes)
    by_path = {}
    counts, ok = _zamba_forward(torch, dev, cfg, tree, rec)
    by_path["zamba2_forward"] = counts

    gen = torch.Generator().manual_seed(5)

    def draw(n):
        return torch.randint(2, cfg.vocab_size, (n,), generator=gen).tolist()
    equal = [draw(ZAMBA_LEN) for _ in range(8)]
    ragged = [draw(n) for n in ZAMBA_RAGGED]
    long = [draw(ZAMBA_LONG)]
    out, counts, engine, lp, run_ok = _zamba_run(
        torch, dev, "generate_b8", cfg, tree, equal, ZAMBA_NEW, rec)
    by_path["zamba2_generate_b8"] = counts
    ok = ok and run_ok
    _, counts, _, _, run_ok = _zamba_run(
        torch, dev, "generate_ragged", cfg, tree, ragged, ZAMBA_RAGGED_NEW,
        rec)
    by_path["zamba2_generate_ragged"] = counts
    ok = ok and run_ok
    _, counts, lengine, _, run_ok = _zamba_run(
        torch, dev, "generate_long", cfg, tree, long, ZAMBA_LONG_NEW, rec)
    by_path["zamba2_generate_long"] = counts
    ok = ok and run_ok and _zamba_ring(torch, dev, cfg, lengine, long[0])
    del lengine
    counts, run_ok = _zamba_sampled(torch, dev, cfg, tree, equal, out, lp,
                                    rec)
    by_path["zamba2_generate_sampled"] = counts
    ok = ok and run_ok
    counts, run_ok = _zamba_serve(torch, dev, cfg, tree, rec)
    by_path["zamba2_serve"] = counts
    ok = ok and run_ok
    _zamba_decode_parts(torch, dev, cfg, engine, rec)
    del engine, tree
    gc.collect()
    torch.cuda.empty_cache()
    ok = _lm_train(torch, dev, "zamba2", ZAMBA_TRAIN_ARGV, rec) and ok
    counts, run_ok = _zamba_cli(torch, dev, rec)
    by_path["zamba2_cli"] = counts
    ok = ok and run_ok
    rec["kernels"] = _zamba_kernels(torch, dev)
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"zamba2: phase {rec['phase_s']:.1f} s ({report['card']})")
    return by_path, ok


def _zamba_kernels(torch, dev):
    """The kernels at zamba2's new shapes, each against its plain version
    and timed as the kernel phase times them, beside the bound and the
    library call (``zamba2_shapes`` in the kernels line): flash_prefill
    bf16 Hq = Hkv = 32 D 64 at B8 T=S=256 (causal) and B1 T=S=4608 with
    the 4096 window; sta_gemm at the shared MLP's prefill GEMMs (M2048 =
    8 x 256: K2048 N8192 with gelu, K8192 N2048); sta_gemm_skinny at the
    greedy head (M8 K2048 N32000 f32, TF32 off for torch.matmul);
    head_sample_fused at the sampled head (M8 K2048 N32000 f32,
    `_head_sample_case`'s rules)."""
    import torch.nn.functional as F

    from repro_torch.kernels.attn.ops import flash_attention
    from repro_torch.kernels.attn.ref import flash_prefill_ref
    from repro_torch.kernels.skinny.ops import sta_gemm_skinny
    from repro_torch.kernels.sta_gemm.ops import sta_gemm
    from repro_torch.kernels.sta_gemm.ref import sta_gemm_ref
    gen = torch.Generator(device=dev).manual_seed(8)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    bf16, i32 = torch.bfloat16, dict(dtype=torch.int32, device=dev)
    rows, failures = {}, []

    def randn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def record(label, err, ok, ms, pms, lms, lib, bms, by):
        if not ok:
            failures.append(f"{label}: max err {err}")
        print(f"kernel {label}: max abs err {err:.3e} {'ok' if ok else 'FAIL'}"
              f"; kernel {ms:.4f} ms, plain {pms:.4f} ms, {lib} {lms:.4f} ms "
              f"({ms / lms:.2f}x), bound {bms:.4f} ms ({by})")
        rows[label] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                           library_ms=lms, bound_ms=bms, bound_by=by)

    hq = hkv = 32
    d = 64
    for b, t, window in ((8, ZAMBA_LEN, 0), (1, ZAMBA_LONG, 4096)):
        scale = d ** -0.5
        q, k, v = randn(b, t, hq, d), randn(b, t, hkv, d), randn(b, t, hkv, d)
        st = torch.zeros((b,), **i32)
        qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        got = flash_attention(q, k, v, st, window=window)
        want = flash_prefill_ref(qh, kh, vh, st, st, sm_scale=scale,
                                 window=window)
        err, ok = _close(torch, got, want.transpose(1, 2), ATTN_RTOL,
                         ATTN_ATOL)
        ii = torch.arange(t, device=dev)
        mask = ii[None, :] <= ii[:, None]
        if window:
            mask &= ii[None, :] > ii[:, None] - window
        ms = _time_ms(torch, lambda: flash_attention(q, k, v, st,
                                                     window=window), flush)
        pms = _time_ms(torch, lambda: flash_prefill_ref(
            qh, kh, vh, st, st, sm_scale=scale, window=window), flush)
        lms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask), flush)
        pairs = b * int(mask.sum().item())
        bms, by = _bound_ms(2 * 2 * b * t * (hq + hkv) * d,
                            4.0 * d * pairs * hq, BF16_OPS_PER_S)
        record(f"flash_prefill B{b} T=S={t} Hq{hq} Hkv{hkv} D{d} "
               f"window {window or 'none'} bf16", err, ok, ms, pms, lms,
               "scaled_dot_product_attention", bms, by)
        del q, k, v, qh, kh, vh, got, want, mask

    m = 8 * ZAMBA_LEN
    for k_dim, n, act in ((2048, 8192, "gelu"), (8192, 2048, "none")):
        x, w = randn(m, k_dim), randn(k_dim, n, scale=k_dim ** -0.5)
        got, want = sta_gemm(x, w, act=act), sta_gemm_ref(x, w, act=act)
        err, ok = _close(torch, got, want, 2e-2)
        ms = _time_ms(torch, lambda: sta_gemm(x, w, act=act), flush)
        pms = _time_ms(torch, lambda: sta_gemm_ref(x, w, act=act), flush)
        lms = _time_ms(torch, lambda: torch.matmul(x, w), flush)
        bms, by = _bound_ms((x.numel() + w.numel() + m * n) * 2,
                            2.0 * m * k_dim * n, BF16_OPS_PER_S)
        record(f"sta_gemm M{m} K{k_dim} N{n} bf16 act {act}", err, ok, ms,
               pms, lms, "torch.matmul", bms, by)

    x = randn(8, 2048, dtype=torch.float32)
    w = randn(2048, 32000, scale=2048 ** -0.5, dtype=torch.float32)
    got, want = sta_gemm_skinny(x, w), sta_gemm_ref(x, w)
    err, ok = _close(torch, got, want, 1e-4)
    ms = _time_ms(torch, lambda: sta_gemm_skinny(x, w), flush)
    pms = _time_ms(torch, lambda: sta_gemm_ref(x, w), flush)
    lms = _time_ms(torch, lambda: torch.matmul(x, w), flush)
    bms, by = _bound_ms((x.numel() + w.numel() + 8 * 32000) * 4,
                        2.0 * 8 * 2048 * 32000, F32_OPS_PER_S)
    record("sta_gemm_skinny M8 K2048 N32000 f32 (greedy head)", err, ok, ms,
           pms, lms, "torch.matmul", bms, by)
    del x, w, got, want

    res, fail = _head_sample_case(torch, dev, flush, 8, 2048, 32000, 9)
    if fail:
        failures.append(fail)
    rows["head_sample_fused M8 K2048 N32000 f32"] = {
        key: res[key] for key in ("max_abs_err", "ms", "plain_ms",
                                  "library_ms", "bound_ms", "bound_by",
                                  "head_matmul_ms")}
    torch.cuda.empty_cache()
    if failures:
        raise SystemExit(_fail("a kernel disagrees with its plain version "
                               "at the zamba2 shapes: " + "; ".join(failures)))
    return rows


# ---------------------------------------------------------------------------
# phases 17 and 18: rwkv6, then the vlm and audio families, at full width
# ---------------------------------------------------------------------------

# the depth phases 16-18 run each model at (of 38 / 24 / 18 / 48 layers):
# a third to a quarter, which frees room for the tp and tp_train phases in
# the run's time limit (half until the mesh-training phase came); the
# serve CLI and training steps keep every layer (their own --full argv)
LM_DEPTH = {"zamba2-1.2b": 12, "rwkv6-1.6b": 8, "paligemma-3b": 6,
            "musicgen-medium": 12}
RWKV_ARCH, VLM_ARCH, AUDIO_ARCH = "rwkv6-1.6b", "paligemma-3b", \
    "musicgen-medium"
LM_FWD = (2, 256)                     # forward: B2 x 256 tokens (or frames)
LM_LEN, LM_NEW = 256, 32              # rwkv6: 8 chunks of the chunked WKV
# left-padded to 200 tokens, no multiple of rwkv6's 32-token chunk: the
# recurrence
LM_RAGGED, LM_RAGGED_NEW = [200, 64, 137, 90, 175, 112, 153, 71], 16
LM_SERVE_LENS = [96, 40, 72, 17, 55, 128, 33, 80, 64, 21, 100, 48]
LM_SERVE_BUDGETS = [8, 16, 12, 10, 14, 9, 16, 11, 13, 8, 15, 12]
LM_DECODE_STEPS = 4                   # decode steps after a direct prefill
LM_CHUNK = 64                         # serve's chunked-prefill chunk
# hidden states at f32 activations, kernel vs plain route, of max |h|
LM_F32_TOL = 1e-4
# at bf16 activations the plain route's own rounding moves these models'
# logits far past LOGIT_TOL (as zamba2's, phase 16): the bf16 kernel route
# is held against the f32 plain route, within this factor of the bf16
# plain route's own distance from it, and a stream split is excused where
# the plain route's gap is within twice that distance
LM_BF16_MARGIN = 1.5
VLM_PREFIX_PROMPT = 128               # tokens after paligemma's 256 patches
RWKV_TRAIN_ARGV = ("--arch rwkv6-1.6b --full --steps 2 --seq-len 256 "
                   "--batch 4")
RWKV_CLI_ARGV = ("--arch rwkv6-1.6b --full --packed --gemm-impl pallas "
                 "--batch 8")
# paligemma's sequence is its 256 patches plus --seq-len tokens. AdamW
# over its 2.5 B parameters at full depth fits: the step peaked at 75.2 GB
# at batch 2 and at batch 1 alike (the f32 parameters, gradients, two
# moments and the DBB-projected copy, not the batch; H100 80GB HBM3, 700 W)
VLM_TRAIN_ARGV = ("--arch paligemma-3b --full --steps 2 --seq-len 128 "
                  "--batch 2")
AUDIO_TRAIN_ARGV = ("--arch musicgen-medium --full --steps 2 --seq-len 256 "
                    "--batch 4")
LM_REFUSED = "token-decoder serving only (modality frontends are stubs)"
LM_WARN_RAGGED = "ragged batch pads feed the recurrent state"
LM_WARN_SPEC = "has no slot-addressed K/V cache for batched verify"
LM_WARN_WAVES = "falling back to static waves"


class _CallRecorder:
    """While active, records the engine's model and head calls: the
    registry's cached entry points (module attributes the engine looks up
    at each call; the package has no hook for this) as (kind, cfg, M,
    the attention kernel the call's cache and the route table give), each
    head GEMV (`dispatch.matmul` with ``gemv=True``) as ("head", cfg,
    rows, kernel route) and each sampling head as ("sample", cfg, rows,
    top-k / top-p in the batch). `_lm_expected` turns the records into
    launches."""
    ENTRIES = ("prefill", "prefill_packed", "prefill_continue",
               "decode_step", "verify_step")

    def __init__(self, torch):
        from repro_torch.kernels import dispatch
        from repro_torch.models import registry
        from repro_torch.serve import sampling
        self.torch, self.calls, self.real = torch, [], {}
        self.slots = ([(registry, e) for e in self.ENTRIES]
                      + [(dispatch, "matmul"),
                         (sampling, "sample_from_hidden")])

    def __enter__(self):
        self.calls = []
        for mod, name in self.slots:
            self.real[mod, name] = getattr(mod, name)
            setattr(mod, name, self._wrap(name, getattr(mod, name)))
        return self

    def __exit__(self, *exc):
        for (mod, name), real in self.real.items():
            setattr(mod, name, real)

    def _attn_kernel(self, kind, cfg, cache):
        """The attention kernel of one layer of this call: flash prefill
        (padded or chunk continuation) or the packed one where the flash
        backend is active, paged_decode on a paged pool or where the
        contiguous cache's decode route picks it, none for verify (the
        naive route, as the reference's)."""
        import math

        from repro_torch.kernels import dispatch
        from repro_torch.kernels.attn.ops import DEFAULT_PAGE, flash_ok
        from repro_torch.models.common import dtype_of
        if cfg.family not in ("dense_lm", "vlm_lm", "audio_lm"):
            return None
        hd, dt = cfg.resolved_head_dim, dtype_of(cfg)
        flash = dispatch.flash_backend_active(cfg) and flash_ok(hd, dt)
        if kind in ("prefill", "prefill_continue"):
            return "flash_prefill" if flash else None
        if kind == "prefill_packed":
            return "flash_prefill_packed" if flash else None
        if kind == "verify_step":
            return None
        if "k_pages" in cache:
            return "paged_decode"
        smax = cache["k"].shape[2]
        route = dispatch.decode_attention_route(
            cfg, group=cfg.num_heads // cfg.num_kv_heads, head_dim=hd,
            page=cfg.kv_page_size or math.gcd(smax, DEFAULT_PAGE),
            smax=smax, itemsize=dt.itemsize)
        return "paged_decode" if route == "attn_decode_flash" else None

    def _wrap(self, name, real):
        from repro_torch.kernels import dispatch
        calls = self.calls
        if name == "matmul":
            def matmul(x, w, *a, **kw):
                if kw.get("gemv"):
                    cfg, pallas = kw.get("cfg"), kw.get("pallas")
                    if pallas is None:
                        pallas = dispatch.pallas_route_active(cfg)
                    calls.append(("head", cfg, x.shape[0], bool(pallas)))
                return real(x, w, *a, **kw)
            return matmul
        if name == "sample_from_hidden":
            def sample(hidden, w, state, **kw):
                calls.append(("sample", kw.get("cfg"), hidden.shape[0],
                              bool(kw.get("use_tt", False))))
                return real(hidden, w, state, **kw)
            return sample

        def entry(params, cfg, *a, **kw):
            tokens = a[0] if a else kw.get("tokens")
            cache = kw.get("cache")
            if cache is None:
                cache = next((c for c in a[1:] if isinstance(c, dict)), {})
            parts = [t for t in (tokens, kw.get("embeds"),
                                 kw.get("prefix_embeds")) if t is not None]
            m = (parts[0].shape[0] if name == "decode_step"
                 else sum(t.shape[0] * t.shape[1] for t in parts))
            calls.append((name, cfg, m, self._attn_kernel(name, cfg, cache)))
            return real(params, cfg, *a, **kw)
        return entry


def _lm_expected(torch, calls):
    """The launches the route table implies for recorded calls
    (`_CallRecorder`; a ("forward", cfg, M, attention kernel) record stands
    for `registry.forward`). A call of an attention family runs, in each
    of its ``cfg.num_layers`` layers, the four attention projections and
    the MLP's GEMMs (gated: wi, wg with the activation, wo; else wi with
    it, wo) on the packed planes at M, each on the kernel the table picks
    (`dispatch.explain`), and the attention kernel recorded; an rwkv6
    call runs its layers in plain matmuls (none). A head record adds the
    greedy head's kernel at its rows where the kernel route is active, a
    sampling head one head_sample_fused where the head_sample table picks
    it (not at paligemma's vocab 257216, no multiple of the 128-column
    tile: the plain sampler, as in the reference). The trees are packed with
    f32 values (vals_itemsize 4). The body counters follow
    their rules (`sta_gemm.ops.tc_body`, `attn.ops.tc_body`; a bf16
    dbb_gemm launch runs the tensor-core body, a float dbb_gemm_skinny
    launch the split-K body)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attn.ops import tc_body as flash_tc
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.sta_gemm.ops import tc_body as gemm_tc
    from repro_torch.models.common import dtype_of
    want, memo = {}, {}

    def add(name, n=1):
        if name in LAUNCHES and n:
            want[name] = want.get(name, 0) + n

    def kernel(cfg, m, k, n, ops):
        key = (cfg, m, k, n, ops)
        if key not in memo:
            memo[key] = ZAMBA_GEMM_KERNELS.get(dispatch.explain(
                "matmul", m=m, k=k, n=n, dtype=dtype_of(cfg), cfg=cfg,
                packed=True, block=cfg.dbb.block, nnz=cfg.dbb.nnz,
                vals_itemsize=4, epilogue_ops=ops)[0].name)
        return memo[key]

    for kind, cfg, m, extra in calls:
        if kind == "head":
            if extra:
                add(_head_kernel(torch, cfg, m))
            continue
        if kind == "sample":
            add(dispatch.explain(
                "head_sample", m=m, k=cfg.d_model, n=cfg.vocab_size,
                dtype=torch.float32, cfg=cfg, sample_tt=extra)[0].name)
            continue
        if cfg.family not in ("dense_lm", "vlm_lm", "audio_lm"):
            continue
        n_l, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
        hq = cfg.num_heads * cfg.resolved_head_dim
        hkv = cfg.num_kv_heads * cfg.resolved_head_dim
        mlp = ([(d, f, 0), (d, f, 1), (f, d, 0)] if cfg.mlp_gated
               else [(d, f, 1), (f, d, 0)])
        for k, n, ops in [(d, hq, 0), (d, hkv, 0), (d, hkv, 0),
                          (hq, d, 0)] + mlp:
            name = kernel(cfg, m, k, n, ops)
            add(name, n_l)
            if name == "sta_gemm" and gemm_tc(dtype_of(cfg), k, n):
                add("sta_gemm_tc", n_l)
            elif name == "dbb_gemm" and dtype_of(cfg) == torch.bfloat16:
                add("dbb_gemm_tc", n_l)
            elif name == "dbb_gemm_skinny":
                add("dbb_gemm_skinny_split", n_l)
        add(extra, n_l)
        if extra in ("flash_prefill", "flash_prefill_packed") and flash_tc(
                dtype_of(cfg), cfg.resolved_head_dim):
            add(extra + "_tc", n_l)
    return want


def _lm_generate(torch, dev, cfg, tree, prompts, new, sampling=None,
                 draft_k=None):
    """``generate`` on one route: a warm-up, the run with the launch
    counts reset just before and read just after and its calls recorded
    (warnings too), and a ``max_new_tokens=1`` call for the time to first
    token: (tokens, counts, calls, engine, warnings, times)."""
    import warnings

    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.serve.engine import ServeEngine
    engine = ServeEngine(cfg, tree, max_batch=len(prompts), device=dev)
    kw = {} if sampling is None else dict(sampling=sampling, draft_k=draft_k)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        engine.generate(prompts, max_new_tokens=1, **kw)      # warm-up
        torch.cuda.synchronize()
        seen.clear()
        with _CallRecorder(torch) as rec:
            reset_launches()
            t0 = time.perf_counter()
            out = engine.generate(prompts, max_new_tokens=new, **kw)
            torch.cuda.synchronize()
            t_total = time.perf_counter() - t0
            counts = dict(LAUNCHES)
        warned = [str(w.message) for w in seen]
        steps = engine.last_decode_steps
        t0 = time.perf_counter()
        engine.generate(prompts, max_new_tokens=1, **kw)
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
    times = dict(total_ms=t_total * 1e3, ttft_ms=ttft * 1e3, steps=steps,
                 decode_ms_per_step=(t_total - ttft) / max(steps, 1) * 1e3)
    return out, counts, rec.calls, engine, warned, times


def _lm_logits(torch, dev, engine, cfg):
    """Last-position f32 logits of contexts: `_logits_fn` (left-padded with
    ``start``), or one context at a time for rwkv6, whose pads feed the
    state (`_zamba_logits`)."""
    if cfg.family == "rwkv6":
        return _zamba_logits(torch, dev, engine)
    return _logits_fn(torch, dev, engine)


def _lm_contexts(cfg, prompts):
    """The contexts as generate ran them: rwkv6 rows with their left pads
    written out (pads are tokens to its state), the others as given (the
    logits take them left-padded with ``start``)."""
    if cfg.family != "rwkv6":
        return prompts
    width = max(map(len, prompts))
    return [[0] * (width - len(p)) + p for p in prompts]


def _lm_run(torch, dev, tag, cfg, tree, prompts, new, rec):
    """One greedy batch on the kernel route and on the plain route:
    prefill logits at f32 activations within LOGIT_TOL of max |logit|; at
    bf16 the kernel route no farther from the f32 plain route than
    LM_BF16_MARGIN times the bf16 plain route's own distance from it;
    streams equal outside the split rule at that reach; exactly the
    launches the recorded calls imply; rwkv6's ragged batch warns. Returns
    (kernel tokens, counts, engine, bf16 plain-route logits, reach, ok)."""
    from repro_torch.serve.engine import ServeEngine
    name = cfg.name
    xcfg = cfg.replace(gemm_impl="xla")
    out, counts, calls, engine, warned, kt = _lm_generate(
        torch, dev, cfg, tree, prompts, new)
    xout, _, _, xengine, _, pt = _lm_generate(torch, dev, xcfg, tree,
                                              prompts, new)
    del xengine
    ctx = _lm_contexts(cfg, prompts)
    last_logits = _logits_fn(torch, dev, engine)
    lk, lp = last_logits(cfg, ctx), last_logits(xcfg, ctx)
    cfg32 = cfg.replace(dtype="float32")
    e32 = ServeEngine(cfg32, tree, max_batch=len(prompts), device=dev)
    logits32 = _logits_fn(torch, dev, e32)
    lk32 = logits32(cfg32, ctx)
    lp32 = logits32(cfg32.replace(gemm_impl="xla"), ctx)
    del e32
    scale = lp32.abs().max().item()
    f32 = (lk32 - lp32).abs().max().item()
    reach = (lp - lp32).abs().max().item()         # bf16's own reach
    diff = (lk - lp32).abs().max().item()
    same, total, split = _split_rows(out, xout)
    gaps = _split_gaps(torch, _lm_logits(torch, dev, engine, cfg), xcfg,
                       ctx, out, xout, split)
    ragged = len(set(map(len, prompts))) > 1 and cfg.family == "rwkv6"
    ok = (f32 <= LOGIT_TOL * scale and diff <= LM_BF16_MARGIN * reach
          and all(g <= 2 * reach for g in gaps)
          and _zamba_warned(warned, [LM_WARN_RAGGED] if ragged else []))
    print(f"{name}: {tag}: {len(prompts)} prompt(s) of "
          f"{sorted(set(map(len, prompts)))} tokens, {new} new: prefill "
          f"last-position logits, of max |logit| {scale:.4e}: f32 "
          f"activations, kernel vs plain route {f32 / scale:.3e} (tol "
          f"{LOGIT_TOL:g}); bf16 against the f32 plain route: plain "
          f"{reach / scale:.3e}, kernel {diff / scale:.3e} (tol "
          f"{LM_BF16_MARGIN:g} x plain's); tokens {same}/{total} equal; "
          f"splits (row, step, plain-route gap; bound {2 * reach:.4e}) "
          f"{[(i, j, g) for (i, j), g in zip(split, gaps)]}; warnings "
          f"{warned} {'ok' if ok else 'FAIL'}")
    print(f"{name}: {tag}: kernel route decode "
          f"{kt['decode_ms_per_step']:.3f} ms/step over {kt['steps']} "
          f"steps, ttft {kt['ttft_ms']:.1f} ms; plain route decode "
          f"{pt['decode_ms_per_step']:.3f} ms/step, ttft {pt['ttft_ms']:.1f} "
          f"ms")
    rec[tag] = dict(kernel=kt, plain=pt, logit_f32_diff=f32,
                    logit_bf16_plain_diff=reach, logit_bf16_kernel_diff=diff,
                    logit_scale=scale, token_agreement=[same, total],
                    token_splits=[[i, j, g] for (i, j), g in zip(split, gaps)],
                    warnings=warned, launches={k: v for k, v in counts.items()
                                               if v})
    ok = _check_launches(name, tag, counts, _lm_expected(torch, calls)) \
        and ok
    return out, counts, engine, lp, reach, ok


def _lm_sampling(torch, lp, n):
    """``n`` SamplingParams: row 0 at temperature 0, the others at
    SAMPLE_T_SPREAD times the median spread of the plain route's logits
    ``lp`` (so the noise decides tokens)."""
    from repro_torch.serve.sampling import SamplingParams
    spread = statistics.median(lp.std(dim=-1).tolist())
    k = len(SAMPLE_T_SPREAD)
    return [SamplingParams(
        temperature=0.0 if i == 0 else spread * SAMPLE_T_SPREAD[i % k],
        seed=i * 7919 + 1) for i in range(n)]


def _lm_sampled(torch, dev, tag, cfg, tree, prompts, greedy, lp, rec):
    """A sampled generate of the greedy batch on the kernel route with
    ``draft_k=2`` asked (rwkv6 refuses it with the warning; the attention
    families speculate): row 0 (temperature 0) equal to the greedy
    stream, the other rows moved by the noise, exactly the launches the
    recorded calls imply (head_sample_fused for the fused heads; a
    speculative step's draft and verify heads take the greedy head's
    kernel)."""
    sp = _lm_sampling(torch, lp, len(prompts))
    out, counts, calls, _, warned, kt = _lm_generate(
        torch, dev, cfg, tree, prompts, LM_NEW, sampling=sp, draft_k=2)
    moved = sum(a != b for s, g in zip(out[1:], greedy[1:])
                for a, b in zip(s, g))
    need = [LM_WARN_SPEC] if cfg.family == "rwkv6" else []
    ok = (out[0] == greedy[0] and moved > 0
          and _zamba_warned(warned, need))
    print(f"{cfg.name}: {tag}: {len(prompts)} prompts, {LM_NEW} new, "
          f"temperatures {[round(p.temperature, 3) for p in sp]}, draft_k=2 "
          f"asked: row 0 (T 0) "
          f"{'equal to' if out[0] == greedy[0] else 'DIFFERS FROM'} the "
          f"greedy stream; {moved} tokens of the other rows moved; "
          f"warnings {warned}; decode {kt['decode_ms_per_step']:.3f} ms/step"
          f", ttft {kt['ttft_ms']:.1f} ms {'ok' if ok else 'FAIL'}")
    rec[tag] = dict(kernel=kt, moved=moved, warnings=warned,
                    launches={k: v for k, v in counts.items() if v})
    ok = _check_launches(cfg.name, tag, counts,
                         _lm_expected(torch, calls)) and ok
    return counts, ok


def _lm_hidden(torch, fn, cfg):
    """``fn(cfg)`` on the kernel route, timed, with the launch counts reset
    just before and read just after and its entry-point calls recorded;
    then the plain route at bf16, and both routes at f32 activations:
    ((kernel, plain, kernel f32, plain f32) hidden states, counts, calls,
    kernel ms, plain ms)."""
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    xcfg = cfg.replace(gemm_impl="xla")
    with torch.no_grad():
        fn(cfg)                                               # warm-up
        torch.cuda.synchronize()
        with _CallRecorder(torch) as rec:
            reset_launches()
            t0 = time.perf_counter()
            hk = fn(cfg)
            torch.cuda.synchronize()
            tk = time.perf_counter() - t0
            counts = dict(LAUNCHES)
        t0 = time.perf_counter()
        hp = fn(xcfg)
        torch.cuda.synchronize()
        tp = time.perf_counter() - t0
        hk32 = fn(cfg.replace(dtype="float32"))
        hp32 = fn(xcfg.replace(dtype="float32"))
    return (hk, hp, hk32, hp32), counts, rec.calls, tk * 1e3, tp * 1e3


def _lm_held(torch, name, tag, hs, tk, tp, want, counts, rec):
    """`_lm_hidden`'s states held: f32 activations within LM_F32_TOL of max
    |value|, bf16 no farther from the f32 plain route than LM_BF16_MARGIN
    times the bf16 plain route, finite; exact launches."""
    hk, hp, hk32, hp32 = (h.float() for h in hs)
    scale = hp32.abs().max().item()
    f32 = (hk32 - hp32).abs().max().item() / scale
    own = (hp - hp32).abs().max().item() / scale
    kern = (hk - hp32).abs().max().item() / scale
    ok = (f32 <= LM_F32_TOL and kern <= LM_BF16_MARGIN * own
          and bool(torch.isfinite(hk).all()))
    print(f"{name}: {tag}: of max |value| {scale:.4e}: f32 activations, "
          f"kernel vs plain route {f32:.3e} (tol {LM_F32_TOL:g}); bf16 "
          f"against the f32 plain route: plain {own:.3e}, kernel {kern:.3e} "
          f"(tol {LM_BF16_MARGIN:g} x plain's) {'ok' if ok else 'FAIL'}; "
          f"bf16 kernel route {tk:.1f} ms, plain route {tp:.1f} ms")
    rec[tag] = dict(f32_diff_of_max=f32, bf16_plain_of_max=own,
                    bf16_kernel_of_max=kern, kernel_ms=tk, plain_ms=tp)
    return _check_launches(name, tag, counts, want) and ok


def _lm_inputs(torch, dev, cfg, b, s, seed):
    """A batch of ``b`` rows: ``s`` tokens, or ``s`` frame embeddings
    (audio), with the vlm family's prefix embeddings in front (0.1 N(0, 1),
    as the data pipeline draws them)."""
    gen = torch.Generator().manual_seed(seed)
    batch = {}
    if cfg.embeds_input:
        batch["embeds"] = 0.1 * torch.randn((b, s, cfg.d_model),
                                            generator=gen)
    else:
        batch["tokens"] = torch.randint(2, cfg.vocab_size, (b, s),
                                        generator=gen)
    if cfg.prefix_embed_len:
        batch["prefix_embeds"] = 0.1 * torch.randn(
            (b, cfg.prefix_embed_len, cfg.d_model), generator=gen)
    return {k: v.to(dev) for k, v in batch.items()}


def _lm_forward(torch, dev, cfg, tree, rec):
    """`registry.forward` on B2 x 256 (tokens, frames, or paligemma's 256
    patches in front of 256 tokens) on the kernel route (the attention
    families stream their packed planes through the DBB kernels) against
    the plain route by `_lm_held`'s rules: (counts, ok)."""
    from repro_torch.kernels.attn.ops import flash_ok
    from repro_torch.kernels import dispatch
    from repro_torch.models import registry
    from repro_torch.models.common import dtype_of
    b, s = LM_FWD
    batch = _lm_inputs(torch, dev, cfg, b, s, 3)
    hs, counts, _, tk, tp = _lm_hidden(
        torch, lambda c: registry.forward(tree, c, batch)[0], cfg)
    m = b * (s + cfg.prefix_embed_len)
    attn = ("flash_prefill" if dispatch.flash_backend_active(cfg)
            and flash_ok(cfg.resolved_head_dim, dtype_of(cfg)) else None)
    want = _lm_expected(torch, [("forward", cfg, m, attn)])
    ok = _lm_held(torch, cfg.name, f"forward B{b} x {s}"
                  + (f" after {cfg.prefix_embed_len} prefix embeds"
                     if cfg.prefix_embed_len else "")
                  + (" frames" if cfg.embeds_input else ""),
                  hs, tk, tp, want, counts, rec)
    return counts, ok


def _lm_prefill_decode(torch, dev, cfg, tree, rec):
    """`registry.prefill` from the family's own inputs (paligemma: 256
    prefix embeds and a 128-token prompt; musicgen: 256 frame embeds),
    then LM_DECODE_STEPS token decode steps, on the kernel route against
    the plain route by `_lm_held`'s rules on the hidden states of every
    call; exactly the launches of those calls (the prefill's and each
    step's head taken outside): (counts, ok)."""
    from repro_torch.models import registry
    b = 2
    s = VLM_PREFIX_PROMPT if cfg.prefix_embed_len else LM_LEN
    batch = _lm_inputs(torch, dev, cfg, b, s, 4)
    total = s + cfg.prefix_embed_len
    nxt = torch.randint(2, cfg.vocab_size, (LM_DECODE_STEPS, b),
                        generator=torch.Generator().manual_seed(6)).to(dev)

    def run(c):
        cache = registry.init_cache(c, b, total + LM_DECODE_STEPS,
                                    device=dev)
        h, cache = registry.prefill(tree, c, batch.get("tokens"), cache,
                                    embeds=batch.get("embeds"),
                                    prefix_embeds=batch.get("prefix_embeds"))
        hs = [h[:, -1]]
        for i in range(LM_DECODE_STEPS):
            h, cache = registry.decode_step(tree, c, nxt[i], cache)
            hs.append(h[:, -1])
        return torch.stack(hs, 1)

    hs, counts, calls, tk, tp = _lm_hidden(torch, run, cfg)
    tag = (f"prefill B{b}: {cfg.prefix_embed_len} prefix embeds + {s} "
           f"tokens" if cfg.prefix_embed_len else f"prefill B{b} x {s} "
           f"frame embeds") + f", then {LM_DECODE_STEPS} token decode steps"
    ok = _lm_held(torch, cfg.name, tag, hs, tk, tp,
                  _lm_expected(torch, calls), counts, rec)
    return counts, ok


def _lm_serve_waves(torch, dev, cfg, tree, rec):
    """rwkv6's ``serve`` of 12 ragged requests through max_batch 8: static
    waves (the warning), streams equal to ``generate`` on the same waves
    cut to the budgets, exactly the launches of the recorded calls."""
    import warnings

    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.serve.engine import ServeEngine
    gen = torch.Generator().manual_seed(4)
    reqs = [torch.randint(2, cfg.vocab_size, (n,), generator=gen).tolist()
            for n in LM_SERVE_LENS]
    engine = ServeEngine(cfg, tree, max_batch=8, device=dev)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        engine.serve(reqs[:2], max_new_tokens=2)              # warm-up
        torch.cuda.synchronize()
        seen.clear()
        with _CallRecorder(torch) as calls:
            reset_launches()
            t0 = time.perf_counter()
            outs = engine.serve(reqs, max_new_tokens=LM_SERVE_BUDGETS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(LAUNCHES)
        warned = [str(w.message) for w in seen]
        want_out = []
        for i in range(0, len(reqs), 8):
            wave, bud = reqs[i:i + 8], LM_SERVE_BUDGETS[i:i + 8]
            res = engine.generate(wave, max_new_tokens=max(bud))
            want_out += [r[:n] for r, n in zip(res, bud)]
    same = outs == want_out
    waves = any(LM_WARN_WAVES in w for w in warned)
    n_tok = sum(len(o) for o in outs)
    ok = same and waves
    print(f"{cfg.name}: serve: {len(reqs)} requests (lengths "
          f"{LM_SERVE_LENS}), budgets {LM_SERVE_BUDGETS}, max_batch 8: "
          f"{wall * 1e3:.1f} ms, {n_tok / wall:.1f} generated tokens/s; "
          f"streams {'equal to' if same else 'DIFFERENT FROM'} generate on "
          f"the same waves; static-wave warning "
          f"{'given' if waves else 'MISSING'} {'ok' if ok else 'FAIL'}")
    rec["serve"] = dict(wall_ms=wall * 1e3, tokens=n_tok, warnings=warned,
                        launches={k: v for k, v in counts.items() if v})
    ok = _check_launches(cfg.name, "serve", counts,
                         _lm_expected(torch, calls.calls)) and ok
    return counts, ok


def _lm_serve(torch, dev, cfg, tree, greedy_logits, reach, sampled, chunked,
              rec):
    """The attention families' ``serve`` of 12 requests through max_batch
    8, 64-slot pages, on the kernel route: packed prefill into (a) the
    contiguous cache and (b) the paged pool, (c) where ``chunked``, packed
    with 64-token chunks, then (d) sampled on the paged pool with ``draft_k=sampled``
    (paligemma: 0, its sampled head at vocab 257216 on the plain sampler,
    no multiple of the fused head's 128-column tile, as in the reference;
    musicgen: 2, speculative). Each with exactly the
    launches of its recorded calls; (a) and (b) equal streams; (c) equal
    to (a) outside the split rule at bf16's reach (gaps on the plain
    route); (d)'s temperature-0 request equal to (b)'s stream outside that
    rule, others moved. Returns ({path: counts}, ok)."""
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.serve.engine import ServeEngine
    gen = torch.Generator().manual_seed(4)
    reqs = [torch.randint(2, cfg.vocab_size, (n,), generator=gen).tolist()
            for n in LM_SERVE_LENS]
    scfg = cfg.replace(kv_page_size=64)
    xcfg = scfg.replace(gemm_impl="xla")
    runs = (("serve_packed", False, 0, None),
            ("serve_paged", True, 0, None))
    if chunked:
        runs += (("serve_chunked", False, LM_CHUNK, None),)
    runs += (("serve_sampled", True, 0, sampled),)
    outs, by_path, ok = {}, {}, True
    for name, paged, chunk, smp in runs:
        sp = None
        if smp is not None:
            sp = _lm_sampling(torch, greedy_logits, len(reqs))
        eng = ServeEngine(scfg, tree, max_batch=8, paged=paged,
                          prefill_chunk=chunk, device=dev)
        kw = {} if sp is None else dict(sampling=sp, draft_k=smp)
        eng.serve(reqs[:2], max_new_tokens=2,
                  **({} if sp is None else dict(sampling=sp[:2],
                                                draft_k=smp)))
        torch.cuda.synchronize()
        with _CallRecorder(torch) as calls:
            reset_launches()
            t0 = time.perf_counter()
            outs[name] = eng.serve(reqs, max_new_tokens=LM_SERVE_BUDGETS,
                                   **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(LAUNCHES)
        n_tok = sum(len(o) for o in outs[name])
        ttft = sorted(eng.serve_stats["ttft_s"])
        print(f"{cfg.name}: {name}: {len(reqs)} requests, budgets "
              f"{LM_SERVE_BUDGETS}"
              + (f", sampled (draft_k={smp})" if sp else "")
              + f": {wall * 1e3:.1f} ms, {n_tok / wall:.1f} generated "
              f"tokens/s; ttft median {ttft[len(ttft) // 2] * 1e3:.1f} ms")
        rec[name] = dict(wall_ms=wall * 1e3, tokens=n_tok,
                         ttft_median_ms=ttft[len(ttft) // 2] * 1e3,
                         launches={k: v for k, v in counts.items() if v})
        ok = _check_launches(cfg.name, name, counts,
                             _lm_expected(torch, calls.calls)) and ok
        by_path[name] = counts
        del eng
    last_logits = _logits_fn(torch, dev, ServeEngine(xcfg, tree, max_batch=8,
                                                     device=dev))
    same = outs["serve_packed"] == outs["serve_paged"]
    chunk = outs.get("serve_chunked", outs["serve_packed"])
    c_same, c_total, split = _split_rows(chunk, outs["serve_packed"])
    gaps = _split_gaps(torch, last_logits, xcfg, reqs, chunk,
                       outs["serve_packed"], split)
    chunk_ok = all(g <= 2 * reach for g in gaps)
    s0 = [outs["serve_sampled"][0]]
    g0 = [outs["serve_paged"][0]]
    _, _, split0 = _split_rows(s0, g0)
    gaps0 = _split_gaps(torch, last_logits, xcfg, reqs[:1], s0, g0, split0)
    moved = sum(a != b for s, g in zip(outs["serve_sampled"][1:],
                                       outs["serve_paged"][1:])
                for a, b in zip(s, g))
    t0_ok = all(g <= 2 * reach for g in gaps0) and moved > 0
    ok = ok and same and chunk_ok and t0_ok
    print(f"{cfg.name}: serve streams: paged vs contiguous "
          f"{'equal' if same else 'DIFFERENT'}; "
          + (f"chunked vs packed {c_same}/{c_total} equal, splits (row, "
             f"step, plain-route gap; bound {2 * reach:.4e}) "
             f"{[(i, j, g) for (i, j), g in zip(split, gaps)]} "
             f"{'ok' if chunk_ok else 'FAIL'}; " if chunked else "")
          + f"sampled: the temperature-0 "
          f"request vs the greedy paged stream, splits "
          f"{[(j, g) for (_, j), g in zip(split0, gaps0)]}, {moved} tokens "
          f"of the others moved {'ok' if t0_ok else 'FAIL'}")
    return by_path, ok


def _lm_train(torch, dev, label, argv, rec):
    """Two steps of ``repro_torch.launch.train.main`` (``argv``, the plain
    route under autograd): finite loss and parameters, no kernel launch,
    peak memory."""
    import gc

    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.launch import train as train_cli
    from repro_torch.train.tree import tree_leaves
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lines, rep = [], {}
    reset_launches()
    t0 = time.perf_counter()
    rc = train_cli.main(argv.split(), log=lines.append, report=rep)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: v for k, v in LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated()
    logged = [json.loads(x) for x in lines if x.startswith("{")]
    finite = all(bool(torch.isfinite(a).all())
                 for a in tree_leaves(rep["state"].params))
    loss = logged[0]["loss"] if logged else float("nan")
    ok = (rc == 0 and rep["state"].step == 2 and finite and not launched
          and abs(loss) < float("inf"))
    print(f"{label}: train {argv}: loss at step 0 {loss:.4f}, "
          f"parameters finite after 2 steps: {finite}; kernel launches "
          f"{launched or 'none'}; wall {wall:.1f} s (the first step "
          f"{logged[0]['dt'] if logged else float('nan'):.3f} s); peak "
          f"device memory {peak / 1e9:.3f} GB {'ok' if ok else 'FAIL'}")
    rec["train"] = dict(argv=argv, loss=loss, wall_s=wall, peak_bytes=peak,
                        logged=logged)
    del rep
    gc.collect()
    torch.cuda.empty_cache()
    return ok


def _rwkv_cli(torch, dev, rec):
    """The serve CLI (RWKV_CLI_ARGV) in process: exactly the launches of
    its recorded calls (the greedy head's; rwkv6's layers run expanded in
    plain matmuls and it has no attention, so its tables' layer and
    attention routes launch nothing, as in the reference)."""
    import gc
    import warnings

    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.launch import serve
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rep = {}
    with _CallRecorder(torch) as calls:
        reset_launches()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rc = serve.main(RWKV_CLI_ARGV.split(), report=rep)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ok = rc == 0
    print(f"{RWKV_ARCH}: cli {RWKV_CLI_ARGV}: tables chose {rep['routes']}; "
          f"build {rep['build_s']:.1f} s, tree "
          f"{rep['tree_bytes'] / 1e9:.3f} GB, peak device memory "
          f"{peak / 1e9:.3f} GB, wall {wall:.1f} s {'ok' if ok else 'FAIL'}")
    rec["cli"] = dict(argv=RWKV_CLI_ARGV, routes=rep["routes"],
                      build_s=rep["build_s"], tree_bytes=rep["tree_bytes"],
                      peak_bytes=peak, wall_s=wall)
    ok = _check_launches(RWKV_ARCH, "cli", counts,
                         _lm_expected(torch, calls.calls)) and ok
    del rep
    gc.collect()
    torch.cuda.empty_cache()
    return counts, ok


def _lm_refused(torch, dev, rec):
    """The serve CLI refuses the two modality families with the
    reference's own SystemExit text, before it builds anything."""
    from repro_torch.launch import serve
    ok = True
    for arch in (VLM_ARCH, AUDIO_ARCH):
        try:
            serve.main(["--arch", arch, "--full"])
            said = "no SystemExit"
        except SystemExit as e:
            said = str(e)
        good = said == f"{arch}: {LM_REFUSED}"
        ok = ok and good
        print(f"{arch}: cli: {said!r} {'ok' if good else 'FAIL'}")
    rec["cli_refused"] = ok
    return ok


def _lm_build(torch, dev, cfg, seed, report):
    """The packed full-width tree of ``cfg``, one layer at a time with the
    family phase's noise hook: (tree, record)."""
    import gc

    from repro_torch.core.dbb_linear import tree_footprint_bytes
    from repro_torch.models import registry
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree = registry.init_params_by_layer(cfg, seed=seed, device=dev,
                                         pack=True, layer_hook=_family_noise)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    layer_bytes = tree_footprint_bytes(tree["layers"])
    attn = ("attention-free (time mix, channel mix)"
            if cfg.family == "rwkv6" else
            f"{cfg.num_heads} heads over {cfg.num_kv_heads} KV heads of D "
            f"{cfg.resolved_head_dim}, {'gated ' if cfg.mlp_gated else ''}"
            f"{cfg.act} MLP")
    print(f"{cfg.name}: {cfg.num_layers} layers (LM_DEPTH), d {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, {attn}, vocab {cfg.vocab_size}"
          f"{' (tied head)' if cfg.tie_embeddings else ''}; packed f32 "
          f"planes (k {cfg.dbb.nnz}) built layer by layer in {t_build:.1f} "
          f"s; layers {layer_bytes / 1e9:.3f} GB; build peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB "
          f"({report['card']})")
    return tree, dict(build_s=t_build, layer_bytes=layer_bytes)


def _lm_prompts(torch, cfg, seed):
    gen = torch.Generator().manual_seed(seed)

    def draw(n):
        return torch.randint(2, cfg.vocab_size, (n,), generator=gen).tolist()
    return [draw(LM_LEN) for _ in range(8)], [draw(n) for n in LM_RAGGED]


def _rwkv_phase(torch, dev, report, out_dir):
    """rwkv6-1.6b at full width and LM_DEPTH's 8 of 24 layers (module
    doc, phase 17): (by_path, ok)."""
    import gc

    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    cfg = get_config(RWKV_ARCH).replace(gemm_impl="pallas",
                                        num_layers=LM_DEPTH[RWKV_ARCH])
    tree, rec = _lm_build(torch, dev, cfg, 30, report)
    report["rwkv6"] = rec
    by_path = {}
    counts, ok = _lm_forward(torch, dev, cfg, tree, rec)
    by_path["rwkv6_forward"] = counts
    equal, ragged = _lm_prompts(torch, cfg, 5)
    out, counts, engine, lp, _, run_ok = _lm_run(
        torch, dev, "generate_b8", cfg, tree, equal, LM_NEW, rec)
    by_path["rwkv6_generate_b8"] = counts
    ok = ok and run_ok
    del engine
    _, counts, _, _, _, run_ok = _lm_run(
        torch, dev, "generate_ragged", cfg, tree, ragged, LM_RAGGED_NEW, rec)
    by_path["rwkv6_generate_ragged"] = counts
    ok = ok and run_ok
    counts, run_ok = _lm_sampled(torch, dev, "generate_sampled", cfg, tree,
                                 equal, out, lp, rec)
    by_path["rwkv6_generate_sampled"] = counts
    ok = ok and run_ok
    counts, run_ok = _lm_serve_waves(torch, dev, cfg, tree, rec)
    by_path["rwkv6_serve"] = counts
    ok = ok and run_ok
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    ok = _lm_train(torch, dev, RWKV_ARCH, RWKV_TRAIN_ARGV, rec) and ok
    counts, run_ok = _rwkv_cli(torch, dev, rec)
    by_path["rwkv6_cli"] = counts
    ok = ok and run_ok
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"{RWKV_ARCH}: phase {rec['phase_s']:.1f} s ({report['card']})")
    return by_path, ok


def _vlm_audio_model(torch, dev, report, arch, seed, sampled, chunked,
                     train_argv):
    """One model of phase 18 (``sampled``: the sampled serve's draft_k;
    ``chunked``: also serve with chunked prefill): (by_path, ok)."""
    import gc

    from repro_torch.configs import get_config
    t_model = time.perf_counter()
    cfg = get_config(arch).replace(gemm_impl="pallas",
                                   num_layers=LM_DEPTH[arch])
    tree, rec = _lm_build(torch, dev, cfg, seed, report)
    report["vlm_audio"][arch] = rec
    short = arch.split("-")[0]
    by_path = {}
    counts, ok = _lm_forward(torch, dev, cfg, tree, rec)
    by_path[f"{short}_forward"] = counts
    counts, run_ok = _lm_prefill_decode(torch, dev, cfg, tree, rec)
    by_path[f"{short}_prefill_decode"] = counts
    ok = ok and run_ok
    equal, _ = _lm_prompts(torch, cfg, 5)
    prompts = [p[:n] for p, n in zip(equal, LM_RAGGED)]      # ragged
    out, counts, engine, lp, reach, run_ok = _lm_run(
        torch, dev, "generate", cfg, tree, prompts, LM_NEW, rec)
    by_path[f"{short}_generate"] = counts
    ok = ok and run_ok
    del engine
    counts, run_ok = _lm_serve(torch, dev, cfg, tree, lp, reach, sampled,
                               chunked, rec)
    by_path.update({f"{short}_{k}": v for k, v in counts.items()})
    ok = ok and run_ok
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    ok = _lm_train(torch, dev, arch, train_argv, rec) and ok
    rec["phase_s"] = time.perf_counter() - t_model
    print(f"{arch}: {rec['phase_s']:.1f} s")
    return by_path, ok


def _vlm_audio_phase(torch, dev, report, out_dir):
    """paligemma-3b and musicgen-medium at full width and LM_DEPTH's
    depth (module doc, phase 18), then the kernels at the three
    families' new shapes: (by_path, ok)."""
    t_phase = time.perf_counter()
    report["vlm_audio"] = {}
    by_path = {}
    # the chunked serve on paligemma only: musicgen's 48 layers make it
    # ~17 s there (H100 80GB HBM3, 700 W), and it tests the same engine path
    counts, ok = _vlm_audio_model(torch, dev, report, VLM_ARCH, 31, 0, True,
                                  VLM_TRAIN_ARGV)
    by_path.update(counts)
    counts, run_ok = _vlm_audio_model(torch, dev, report, AUDIO_ARCH, 32, 2,
                                      False, AUDIO_TRAIN_ARGV)
    by_path.update(counts)
    ok = ok and run_ok and _lm_refused(torch, dev, report["vlm_audio"])
    report["vlm_audio"]["kernels"] = _last_kernels(torch, dev)
    report["vlm_audio"]["phase_s"] = time.perf_counter() - t_phase
    print(f"vlm_audio: phase {report['vlm_audio']['phase_s']:.1f} s "
          f"({report['card']})")
    return by_path, ok


def _last_kernels(torch, dev):
    """The kernels at the last three families' new shapes, each against
    its plain version and timed as the kernel phase times them, beside the
    bound and the library call (``last_families_shapes`` in the kernels
    line): flash_prefill bf16 at paligemma's MQA (Hq 8, Hkv 1, D 256) for
    B1 T=S=384 (the prefix and a 128-token prompt) and flash_prefill_packed
    at the serve lengths (both on the two-warpgroup tensor-core body, a
    ``_tc`` launch each), paged_decode at G 8 D 256 (B8, 64-slot pages),
    the greedy heads sta_gemm_skinny at M8 K2048 N257216 (paligemma's tied
    head) and N65536 (rwkv6's) f32 beside torch.matmul (TF32 off),
    head_sample_fused at rwkv6's sampled head M8 K2048 N65536
    (`_head_sample_case`'s rules; paligemma's N 257216 is no multiple of
    its 128-column tile, so its sampled head takes the plain sampler, as
    the reference's guard sends it),
    and the DBB MLP GEMMs: dbb_gemm at M512 K2048 N16384 with gelu
    (paligemma's gate) and K16384 N2048, musicgen's M512 K1536 N6144 (gelu)
    and K6144 N1536, and dbb_gemm_skinny at M8 of the same four plus
    paligemma's K/V projection (K2048 N256), beside torch.matmul on the
    decompressed weight."""
    import torch.nn.functional as F

    from repro_torch.core.dbb import decompress_bitmask, pack_dbb
    from repro_torch.kernels.attn.ops import (flash_attention,
                                              packed_flash_attention,
                                              paged_decode_attention)
    from repro_torch.kernels.attn.ref import (flash_prefill_ref,
                                              packed_prefill_ref,
                                              paged_decode_ref)
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.dbb_gemm.ops import dbb_gemm
    from repro_torch.kernels.dbb_gemm.ref import dbb_gemm_ref
    from repro_torch.kernels.skinny.ops import dbb_gemm_skinny, \
        sta_gemm_skinny
    from repro_torch.kernels.sta_gemm.ref import sta_gemm_ref
    gen = torch.Generator(device=dev).manual_seed(10)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    bf16, i32 = torch.bfloat16, dict(dtype=torch.int32, device=dev)
    rows, failures = {}, []

    def randn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def record(label, err, ok, ms, pms, lms, lib, bms, by, note=""):
        if not ok:
            failures.append(f"{label}: max err {err}")
        print(f"kernel {label}: max abs err {err:.3e} {'ok' if ok else 'FAIL'}"
              f"; kernel {ms:.4f} ms{note}, plain {pms:.4f} ms, {lib} "
              f"{lms:.4f} ms ({ms / lms:.2f}x), bound {bms:.4f} ms ({by})")
        rows[label] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                           library_ms=lms, bound_ms=bms, bound_by=by)

    hq, hkv, d = 8, 1, 256
    g, scale = hq // hkv, d ** -0.5
    b, t = 1, 256 + VLM_PREFIX_PROMPT
    q, k, v = randn(b, t, hq, d), randn(b, t, hkv, d), randn(b, t, hkv, d)
    st = torch.zeros((b,), **i32)
    qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    kx, vx = (a.repeat_interleave(g, dim=1) for a in (kh, vh))
    tc_before = LAUNCHES["flash_prefill_tc"]
    got = flash_attention(q, k, v, st)
    want = flash_prefill_ref(qh, kh, vh, st, st, sm_scale=scale)
    torch.cuda.synchronize()
    tc = LAUNCHES["flash_prefill_tc"] == tc_before + 1
    err, ok = _close(torch, got, want.transpose(1, 2), ATTN_RTOL, ATTN_ATOL)
    ms = _time_ms(torch, lambda: flash_attention(q, k, v, st), flush)
    pms = _time_ms(torch, lambda: flash_prefill_ref(
        qh, kh, vh, st, st, sm_scale=scale), flush)
    lms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kx, vx, is_causal=True), flush)
    pairs = b * t * (t + 1) // 2
    bms, by = _bound_ms(2 * 2 * b * t * (hq + hkv) * d,
                        4.0 * d * pairs * hq, BF16_OPS_PER_S)
    record(f"flash_prefill B{b} T=S={t} Hq{hq} Hkv{hkv} D{d} bf16", err,
           ok and tc, ms, pms, lms, "scaled_dot_product_attention", bms, by,
           " (two-warpgroup tensor-core body)" if tc else " (NO _tc launch)")

    lens = LM_SERVE_LENS[:8]
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
    tc = LAUNCHES["flash_prefill_packed_tc"] == tc_before + 1
    err, ok = _close(torch, got, want.transpose(0, 1), ATTN_RTOL, ATTN_ATOL)
    ms = _time_ms(torch, lambda: packed_flash_attention(q, k, v, seg), flush)
    pms = _time_ms(torch, lambda: packed_prefill_ref(
        qh, kh, vh, seg, sm_scale=scale), flush)
    lms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        qh[None], kx[None], vx[None], attn_mask=mask), flush)
    pairs = sum(n * (n + 1) // 2 for n in lens)
    bms, by = _bound_ms(2 * 2 * tp * (hq + hkv) * d, 4.0 * d * pairs * hq,
                        BF16_OPS_PER_S)
    record(f"flash_prefill_packed T{tp} over {len(lens)} segments Hq{hq} "
           f"Hkv{hkv} D{d} bf16", err, ok and tc, ms, pms, lms,
           "scaled_dot_product_attention", bms, by,
           " (two-warpgroup tensor-core body)" if tc else " (NO _tc launch)")
    del q, k, v, qh, kh, vh, kx, vx, mask

    b, page, s = 8, 64, 512
    length, n_log = 400, s // page
    qd = randn(b, hkv, g, d)
    kc, vc = randn(b, s, hkv, d), randn(b, s, hkv, d)
    kp, vp = (a.view(b * n_log, page, hkv, d) for a in (kc, vc))
    table = (torch.arange(b, **i32)[:, None] * n_log
             + torch.arange(n_log, **i32)[None, :])
    lengths = torch.full((b,), length, **i32)
    st = torch.zeros((b,), **i32)
    got = paged_decode_attention(qd, kp, vp, table, lengths, st)
    want = paged_decode_ref(qd, kp, vp, table, lengths, st, sm_scale=scale)
    err, ok = _close(torch, got, want, 2e-2)
    qs = qd.reshape(b, hq, 1, d)
    ks, vs = (a.transpose(1, 2).repeat_interleave(g, dim=1)
              for a in (kc, vc))
    am = (torch.arange(s, device=dev) <= length)[None, None, None, :]
    ms = _time_ms(torch, lambda: paged_decode_attention(
        qd, kp, vp, table, lengths, st), flush)
    pms = _time_ms(torch, lambda: paged_decode_ref(
        qd, kp, vp, table, lengths, st, sm_scale=scale), flush)
    lms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=am), flush)
    valid = b * (length + 1)
    bms, by = _bound_ms(qd.numel() * 2 * 2 + valid * hkv * d * 2 * 2,
                        4.0 * valid * hq * d, BF16_OPS_PER_S)
    record(f"paged_decode B{b} Hkv{hkv} G{g} D{d} S{s} page{page} bf16", err,
           ok, ms, pms, lms, "scaled_dot_product_attention", bms, by)
    del qd, kc, vc, kp, vp, qs, ks, vs

    for n in (257216, 65536):
        x = randn(8, 2048, dtype=torch.float32)
        w = randn(2048, n, scale=2048 ** -0.5, dtype=torch.float32)
        got, want = sta_gemm_skinny(x, w), sta_gemm_ref(x, w)
        err, ok = _close(torch, got, want, 1e-4)
        ms = _time_ms(torch, lambda: sta_gemm_skinny(x, w), flush)
        pms = _time_ms(torch, lambda: sta_gemm_ref(x, w), flush)
        lms = _time_ms(torch, lambda: torch.matmul(x, w), flush)
        bms, by = _bound_ms((x.numel() + w.numel() + 8 * n) * 4,
                            2.0 * 8 * 2048 * n, F32_OPS_PER_S)
        record(f"sta_gemm_skinny M8 K2048 N{n} f32 (greedy head)", err, ok,
               ms, pms, lms, "torch.matmul", bms, by)
        del x, w, got, want
    torch.cuda.empty_cache()
    res, fail = _head_sample_case(torch, dev, flush, 8, 2048, 65536, 10)
    if fail:
        failures.append(fail)
    rows["head_sample_fused M8 K2048 N65536 f32"] = {
        key: res[key] for key in ("max_abs_err", "ms", "plain_ms",
                                  "library_ms", "bound_ms", "bound_by",
                                  "head_matmul_ms")}
    torch.cuda.empty_cache()

    for name, fn, m, k_dim, n, act in (
            ("dbb_gemm", dbb_gemm, 512, 2048, 16384, "gelu"),
            ("dbb_gemm", dbb_gemm, 512, 16384, 2048, "none"),
            ("dbb_gemm", dbb_gemm, 512, 1536, 6144, "gelu"),
            ("dbb_gemm", dbb_gemm, 512, 6144, 1536, "none"),
            ("dbb_gemm_skinny", dbb_gemm_skinny, 8, 2048, 16384, "gelu"),
            ("dbb_gemm_skinny", dbb_gemm_skinny, 8, 16384, 2048, "none"),
            ("dbb_gemm_skinny", dbb_gemm_skinny, 8, 1536, 6144, "gelu"),
            ("dbb_gemm_skinny", dbb_gemm_skinny, 8, 6144, 1536, "none"),
            ("dbb_gemm_skinny", dbb_gemm_skinny, 8, 2048, 256, "none")):
        x = randn(m, k_dim)
        p = pack_dbb(torch.randn((k_dim, n), generator=gen, device=dev)
                     * k_dim ** -0.5, 8, 4)
        vals, bits = p.values, p.bitmask
        wd = decompress_bitmask(vals, bits, block=8)
        counter = REDESIGN[name][0]
        before = LAUNCHES[counter]
        got = fn(x, vals, bits, act=act)
        want = dbb_gemm_ref(x, vals, bits, act=act)
        torch.cuda.synchronize()
        err, ok = _close(torch, got, want, 2e-2)
        body = LAUNCHES[counter] == before + 1
        w_bf16 = wd.to(bf16)
        ms = _time_ms(torch, lambda: fn(x, vals, bits, act=act), flush)
        pms = _time_ms(torch, lambda: dbb_gemm_ref(x, vals, bits, act=act),
                       flush)
        lms = _time_ms(torch, lambda: torch.matmul(x, w_bf16), flush)
        stored = vals.numel() * vals.element_size() + bits.numel() \
            * bits.element_size()
        live = int((wd != 0).sum().item())
        bms, by = _bound_ms(x.numel() * 2 + stored + m * n * 2,
                            2.0 * m * live, BF16_OPS_PER_S)
        record(f"{name} M{m} K{k_dim} N{n} bf16 f32 planes act {act}", err,
               ok and body, ms, pms, lms,
               "torch.matmul on the decompressed weight", bms, by,
               f" ({counter} body)" if body else f" (NO {counter} launch)")
        del x, p, wd, vals, bits, got, want, w_bf16
    torch.cuda.empty_cache()
    if failures:
        raise SystemExit(_fail("a kernel disagrees with its plain version "
                               "at the last families' shapes: "
                               + "; ".join(failures)))
    return rows


# ---------------------------------------------------------------------------
# phase 20: tensor-parallel serving, gloo ranks sharing the card
# ---------------------------------------------------------------------------

TP_BACKEND = "gloo"              # NCCL refuses two ranks on one device
TP_NEW = 64                      # f32 generate: the slice phase's prompts
TP4_NEW = 16                     # tp 4: 4 contexts time-share the card
TP_CHUNK = 256                   # bf16 serve: packed prefill, paged, chunks
TP_SERVE_REQS = 8                # bf16 serve: the serve phase's first 8
                                 # requests (one prompt over TP_CHUNK); all
                                 # 24 took 47-61 s of a 133-148 s phase
TP_SAMPLE_REQS = 3               # the sampled draft_k=2 serve's requests
# f32 TP logits vs the single device, of max |logit|: a row split sums its
# partials in another order (1.2e-7 of max read at tp 2 and 4 on olmo-1b),
# while bf16 activations move them 6.3e-4; a limit between the two fails a
# TP path that lost f32 somewhere (a bf16 collective, embedding or head)
TP_LOGIT_TOL = 1e-5
TP_EP = ("arctic-480b", 16, 2)   # experts, layers (the moe phase's w4 tree)
TP_TIMEOUT = 240                 # seconds a world may take once it runs
TP_SMOKE = False                 # smoke configs (a CPU rehearsal sets it)


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _tp_olmo(torch, dev, dtype):
    """olmo-1b at full width and all 16 layers, packed f32 planes (k 4),
    as the slice phase builds them (seed 0; kv_page_size 0, the slice's
    generate config; serve runs take 64-slot pages): (config, tree)."""
    from repro_torch.configs import get_config
    from repro_torch.core.dbb_linear import pack_tree
    from repro_torch.core.sparsity import apply_dbb_to_tree
    from repro_torch.models import registry
    cfg = get_config("olmo-1b", smoke=TP_SMOKE).replace(
        remat="none", gemm_impl="pallas", dtype=dtype)
    tree = pack_tree(apply_dbb_to_tree(
        registry.init_params(cfg, seed=0, device=dev), cfg.dbb,
        straight_through=False), cfg.dbb)
    return cfg, tree


def _tp_ep_model(torch, dev):
    """The EP run's model: the moe phase's arctic tree (w4 planes of the
    attention and the experts, seed len(arch)) cut to TP_EP's experts and
    layers, f32 activations: (config, tree)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import registry
    arch, experts, layers = TP_EP
    full = get_config(arch, smoke=TP_SMOKE)
    cfg = full.replace(
        num_layers=layers, remat="none", gemm_impl="pallas", dtype="float32",
        moe=dataclasses.replace(full.moe, num_experts=experts),
        dbb=dataclasses.replace(full.dbb, weight_bits=4, quant_group=128))
    tree = registry.init_params_by_layer(cfg, seed=len(arch), device=dev,
                                         pack=True, layer_hook=_family_noise)
    return cfg, tree


def _tp_logits(torch, engine, cfg, contexts):
    """Last-position f32 head logits of left-padded ``contexts`` through
    the engine's own prefill step (under its TP wrap a shard body, the
    vocab columns gathered), in batches of 8."""
    from repro_torch.dist.collectives import all_gather
    from repro_torch.dist.mesh_ctx import shard_tp
    from repro_torch.kernels import dispatch
    from repro_torch.models import registry
    from repro_torch.serve.engine import make_prefill_step

    def head_logits(c):
        def head(last, w):
            lg = dispatch.matmul(last[:, -1].float().contiguous(), w,
                                 cfg=c, gemv=True)
            return all_gather(lg, dim=-1) if shard_tp() > 1 else lg
        return head

    step = engine._tp_step(make_prefill_step, head_logits)
    dev, out = engine.device, []
    for a in range(0, len(contexts), 8):
        ctx = contexts[a:a + 8]
        width = max(len(t) for t in ctx)
        toks = torch.zeros((len(ctx), width), dtype=torch.int32)
        for i, t in enumerate(ctx):
            toks[i, width - len(t):] = torch.tensor(t)
        pads = [width - len(t) for t in ctx]
        start = (torch.tensor(pads, dtype=torch.int32, device=dev)
                 if any(pads) else None)
        cache = registry.init_cache(engine._lcfg, len(ctx), width + 1,
                                    device=dev)
        lg, _ = step(engine.params, engine.head, cache, toks.to(dev), start)
        out.append(lg)
    return torch.cat(out)


def _tp_sampling(lg, n):
    """SamplingParams fields of ``n`` requests from the spread of logits
    ``lg`` (the sample phase's rule: temperatures SAMPLE_T_SPREAD times
    the median std over the vocabulary; request 0 at temperature 0)."""
    spread = statistics.median(lg.std(dim=-1).tolist())
    return [dict(temperature=0.0 if i == 0 else
                 spread * SAMPLE_T_SPREAD[i % len(SAMPLE_T_SPREAD)],
                 seed=i * 7919 + 1,
                 repetition_penalty=1.1 if i % 3 == 1 else 1.0)
            for i in range(n)]


def _tp_collective_ms(torch, dev, cfg, dtype, reps=5):
    """Host ms of one decode step's collectives at B8, timed alone: per
    layer the two boundary all-reduces ([8, 1, d] in the activation
    dtype), the embedding's f32 all-reduce, and the greedy head's [tp, 2,
    8] f64 gather."""
    from repro_torch.dist.collectives import all_gather, all_reduce
    y = torch.ones((8, 1, cfg.d_model), dtype=dtype, device=dev)
    e = torch.ones((8, 1, cfg.d_model), dtype=torch.float32, device=dev)
    s = torch.ones((2, 8), dtype=torch.float64, device=dev)

    def step():
        for _ in range(2 * cfg.num_layers):
            all_reduce(y)
        all_reduce(e)
        all_gather(s)
    step()
    _sync(torch, dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    _sync(torch, dev)
    return (time.perf_counter() - t0) / reps * 1e3


def _tp_run(torch, engine, call, *args, **kw):
    """``engine.generate`` or ``.serve`` with the launch counts and the
    decompress calls reset just before and read just after: (tokens,
    counts, decompress calls, decode steps, wall ms)."""
    from repro_torch.core.dbb_linear import DECOMPRESS_STATS
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    d0 = DECOMPRESS_STATS["calls"]
    reset_launches()
    t0 = time.perf_counter()
    out = getattr(engine, call)(*args, **kw)
    _sync(torch, engine.device)
    return (out, dict(LAUNCHES), DECOMPRESS_STATS["calls"] - d0,
            engine.last_decode_steps, (time.perf_counter() - t0) * 1e3)


@contextlib.contextmanager
def _ep_probe():
    """Records each MoE dispatch while it is open: the expert window a
    call ran (``e0``, ``e_loc``) and the kernel launches made inside it
    (the experts' GEMMs). Yields the list of ``(e0, e_loc, launches)``;
    the dispatch is `repro_torch.models.moe`'s own, called unchanged."""
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.models import moe
    inner = moe._dispatch_compute_combine
    calls = []

    def probe(x, ew, top_idx, top_p, e0, e_loc, capacity, cfg):
        before = dict(LAUNCHES)
        y = inner(x, ew, top_idx, top_p, e0, e_loc, capacity, cfg)
        calls.append((e0, e_loc, {k: v - before[k] for k, v in
                                  LAUNCHES.items() if v != before[k]}))
        return y
    moe._dispatch_compute_combine = probe
    try:
        yield calls
    finally:
        moe._dispatch_compute_combine = inner


def _ep_split(counts, calls):
    """(experts' launches, the other launches, sorted expert windows) of
    a run whose MoE dispatches `_ep_probe` recorded."""
    inside = collections.Counter()
    for _, _, launched in calls:
        inside.update(launched)
    outside = {k: v - inside[k] for k, v in counts.items()
               if v - inside[k]}
    return dict(inside), outside, sorted({(e0, n) for e0, n, _ in calls})


def _tp_rank(rank, world, store, path, queue):
    """One rank of a TP world on the job's device (spawned by
    `_tp_start`): the job's runs under the mesh; the result dict (or the
    traceback) goes to ``queue``. Every rank runs every collective; rank 0
    keeps the gathered logits, as numpy (a queued tensor's storage dies
    with its process)."""
    import pickle
    import traceback
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with open(path, "rb") as f:
            job = pickle.load(f)
        global TP_SMOKE
        TP_SMOKE = job["smoke"]
        dev = torch.device(job["device"])
        if dev.type == "cuda":
            dev = torch.device("cuda", dev.index or 0)
            torch.cuda.set_device(dev)
        dist.init_process_group(TP_BACKEND, init_method=f"file://{store}",
                                rank=rank, world_size=world)
        from repro_torch.dist.mesh_ctx import make_mesh, use_mesh
        from repro_torch.serve.engine import ServeEngine
        from repro_torch.serve.sampling import SamplingParams
        mesh = make_mesh(1, world, backend=TP_BACKEND)
        res = {"rank": rank}
        if job["gate"]:
            # started early: the set-up above overlaps the world before;
            # the runs wait until the parent opens the gate
            torch.zeros(1, device=dev)
            t0 = time.perf_counter()
            while not os.path.exists(job["gate"]):
                if time.perf_counter() - t0 > 2 * TP_TIMEOUT:
                    raise RuntimeError("the gate never opened")
                time.sleep(0.05)

        def keep(key, lg):
            if rank == 0:
                res[key] = lg.cpu().float().numpy()

        with use_mesh(mesh):
            cfg32, tree = _tp_olmo(torch, dev, "float32")
            eng = ServeEngine(cfg32, tree, max_batch=8, device=dev)
            res["tp_reason"] = eng.tp_reason
            res["gen"] = _tp_run(torch, eng, "generate", job["prompts"],
                                 max_new_tokens=job["new"])
            keep("gen_logits", _tp_logits(torch, eng, cfg32,
                                          job["prompts"]))
            res["collective_ms_f32"] = _tp_collective_ms(
                torch, dev, cfg32, torch.float32)
            del eng
            if job["full"]:
                cfg16 = cfg32.replace(dtype="bfloat16", kv_page_size=64)
                eng = ServeEngine(cfg16, tree, max_batch=8, device=dev,
                                  paged=True, prefill_chunk=TP_CHUNK)
                res["serve"] = _tp_run(torch, eng, "serve", job["serve"],
                                       max_new_tokens=job["budgets"])
                lg = _tp_logits(torch, eng, cfg16, job["serve"])
                keep("serve_logits", lg)
                # the same gathered logits on every rank: the same knobs
                sp = [SamplingParams(**k)
                      for k in _tp_sampling(lg.float(), TP_SAMPLE_REQS)]
                n = len(sp)
                res["sample"] = _tp_run(
                    torch, eng, "serve", job["serve"][:n],
                    max_new_tokens=job["budgets"][:n], sampling=sp,
                    draft_k=2)
                res["collective_ms_bf16"] = _tp_collective_ms(
                    torch, dev, cfg16, torch.bfloat16)
                del eng, tree
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                cfg_ep, tree_ep = _tp_ep_model(torch, dev)
                eng = ServeEngine(cfg_ep, tree_ep, max_batch=8, device=dev)
                res["ep_reason"] = eng.tp_reason
                with _ep_probe() as calls:
                    res["ep"] = _tp_run(torch, eng, "generate",
                                        job["ep_prompts"],
                                        max_new_tokens=job["ep_new"])
                res["ep_calls"] = calls
                keep("ep_logits", _tp_logits(torch, eng, cfg_ep,
                                             job["ep_prompts"]))
        dist.barrier()
        dist.destroy_process_group()
        queue.put(res)
    except Exception:                                   # noqa: BLE001
        queue.put({"rank": rank, "error": traceback.format_exc()})


def _tp_start(torch, world, job, gated=False, target=None):
    """Spawn ``world`` ranks of `_tp_rank` (the ``spawn`` start method, a
    ``file://`` store in a temporary directory; the job goes through a
    file, as a Process's arguments go down a pipe its child reads only
    after its imports) and return the world for `_tp_collect`. A
    ``gated`` world sets up (imports, CUDA context, process group) and
    then waits for `_tp_release`. The ranks are daemons: a parent that
    fails takes them down with it. ``target``: the rank function
    (default `_tp_rank`)."""
    import pickle
    import tempfile
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "job.pkl")
    gate = os.path.join(tmp.name, "gate")
    with open(path, "wb") as f:
        pickle.dump(dict(job, gate=gate if gated else None), f)
    q = ctx.Queue()
    procs = [ctx.Process(target=target or _tp_rank, daemon=True,
                         args=(r, world, os.path.join(tmp.name, "store"),
                               path, q)) for r in range(world)]
    for p in procs:
        p.start()
    return world, procs, q, tmp, time.perf_counter()


def _tp_release(started):
    """Open a gated world's gate; its clock starts now."""
    world, procs, q, tmp, _ = started
    open(os.path.join(tmp.name, "gate"), "w").close()
    return world, procs, q, tmp, time.perf_counter()


def _tp_stop(started):
    """Terminate a world that will not be collected."""
    _, procs, _, tmp, _ = started
    for p in procs:
        if p.is_alive():
            p.terminate()
        p.join()
    tmp.cleanup()


def _tp_collect(started):
    """The ranks' results in rank order and the world's wall seconds; a
    rank's error, a rank gone without a result or a world past TP_TIMEOUT
    raises. Every rank is joined, or terminated, before this returns."""
    import queue as queue_mod
    world, procs, q, tmp, t0 = started
    got = []
    try:
        while len(got) < world:
            try:
                got.append(q.get(timeout=5))
                continue
            except queue_mod.Empty:
                pass
            dead = [p.exitcode for p in procs
                    if not p.is_alive() and p.exitcode != 0]
            if dead or time.perf_counter() - t0 > TP_TIMEOUT:
                got.append({"rank": -1, "error": (
                    f"a rank exited with code {dead[0]} and no result"
                    if dead else f"no result within {TP_TIMEOUT} s")})
                break
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
        tmp.cleanup()
    errs = [g["error"] for g in got if "error" in g]
    if errs:
        raise RuntimeError(f"a rank of the tp={world} world failed:\n"
                           + errs[0])
    return sorted(got, key=lambda g: g["rank"]), time.perf_counter() - t0


def _tp_kernel_names(counts):
    """The kernels a run launched (sub-body counters left out)."""
    return {k: v for k, v in counts.items()
            if v and not k.endswith(("_tc", "_split", "_narrow", "_small"))}


def _tp_phase(torch, dev, report, out_dir):
    """Tensor-parallel serving (module doc, phase 20): olmo-1b over 2 and 4
    ranks and arctic's expert parallelism over 2, each rank a spawned
    process on cuda:0 over gloo, against the single-device kernel route;
    then the kernels at the shard shapes. Both worlds start first: the
    2-rank world builds and runs while this process runs the single-device
    references, the 4-rank world sets up and waits for its gate, which
    opens once the 2-rank world is done. (by_path, ok)."""
    import gc

    from repro_torch.kernels import dispatch
    from repro_torch.serve.engine import ServeEngine
    t_phase = time.perf_counter()
    rec = report["tp"] = {}
    print(f"tp: backend {TP_BACKEND}: 2 and 4 ranks sharing one H100, not "
          f"NVLink; no TP speed is measured ({report['card']})")
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(1)
    cfg32, tree = _tp_olmo(torch, dev, "float32")
    cfg16 = cfg32.replace(dtype="bfloat16", kv_page_size=64)
    prompts = [torch.randint(2, cfg32.vocab_size, (n,),
                             generator=gen).tolist()
               for n in [64, 57, 50, 43, 36, 29, 22, 15]]
    serve_prompts, budgets = (a[:TP_SERVE_REQS] for a in
                              _serve_requests(torch, cfg16))
    from repro_torch.configs import get_config
    gen = torch.Generator().manual_seed(7)
    ep_prompts = [torch.randint(2, get_config(TP_EP[0],
                                              smoke=TP_SMOKE).vocab_size,
                                (MOE_PROMPT_LEN,), generator=gen).tolist()
                  for _ in range(MOE_PROMPTS)]
    job = dict(prompts=prompts, serve=serve_prompts, budgets=budgets,
               ep_prompts=ep_prompts, device=str(dev), smoke=TP_SMOKE,
               ep_new=MOE_NEW)
    world2 = _tp_start(torch, 2, dict(job, full=True, new=TP_NEW))
    world4 = _tp_start(torch, 4, dict(job, full=False, new=TP4_NEW),
                       gated=True)
    try:
        # -- the single-device kernel route, f32 and bf16 ------------------
        eng32 = ServeEngine(cfg32, tree, max_batch=8, device=dev)
        single = {new: _tp_run(torch, eng32, "generate", prompts,
                               max_new_tokens=new)
                  for new in (TP_NEW, TP4_NEW)}
        last32 = _logits_fn(torch, dev, eng32)
        lg1 = last32(cfg32, prompts)
        lg32_serve = last32(cfg32, serve_prompts)
        eng16 = ServeEngine(cfg16, tree, max_batch=8, device=dev)
        last16 = _logits_fn(torch, dev, eng16)
        lg16_serve = last16(cfg16, serve_prompts)
        # the launches the ranks' bf16 serve must match: one device's serve
        # of the same requests on the same engine settings (the streams
        # are the serve phase's)
        eng16 = ServeEngine(cfg16, tree, max_batch=8, device=dev,
                            paged=True, prefill_chunk=TP_CHUNK)
        serve16 = _tp_run(torch, eng16, "serve", serve_prompts,
                          max_new_tokens=budgets)
        del eng32, eng16, tree
        cfg_ep, tree_ep = _tp_ep_model(torch, dev)
        eng_ep = ServeEngine(cfg_ep, tree_ep, max_batch=8, device=dev)
        with _ep_probe() as ep_calls:
            ep1 = _tp_run(torch, eng_ep, "generate", ep_prompts,
                          max_new_tokens=MOE_NEW)
        last_ep = _logits_fn(torch, dev, eng_ep)
        lg_ep1 = last_ep(cfg_ep, ep_prompts)
        _sync(torch, dev)
        # hand the references' cached blocks back to the card: the ranks
        # share it, and their EP runs expand a layer at a time
        gc.collect()
        torch.cuda.empty_cache()
        refs = dict(cfg32=cfg32, cfg16=cfg16, prompts=prompts, lg1=lg1,
                    last32=last32, serve_prompts=serve_prompts, last16=last16,
                    lg32_serve=lg32_serve, lg16_serve=lg16_serve,
                    single16=report["serve"]["streams"]["serve_chunked"][
                        :TP_SERVE_REQS],
                    single16_counts=serve16[1],
                    cfg_ep=cfg_ep, ep_prompts=ep_prompts, ep1=ep1,
                    ep_calls=ep_calls,
                    lg_ep1=lg_ep1, last_ep=last_ep)

        by_path, ok = {}, True
        for world in (2, 4):
            new = TP_NEW if world == 2 else TP4_NEW
            if world == 4:
                world4 = _tp_release(world4)
            ranks, wall = _tp_collect(world2 if world == 2 else world4)
            ok = _tp_generate_check(torch, dev, world, new, wall, ranks,
                                    single[new], refs, by_path, rec) and ok
            if world == 2:
                ok = _tp_full_checks(torch, dev, ranks, refs, by_path,
                                     rec) and ok
        # the routes explain() picks at olmo's serving shapes on 2 ranks are
        # the kernels each rank launched
        d, f = cfg32.d_model, cfg32.d_ff
        want = set()
        for m in (8, 512):
            for k, n, coll in ((d, d, ""), (d, d, "all-reduce"), (d, f, ""),
                               (f, d, "all-reduce")):
                dec = dispatch.explain("matmul", m=m, k=k, n=n, cfg=cfg32,
                                       tp=2, collective=coll, packed=True,
                                       nnz=4, vals_itemsize=4)
                want.add(dec[0].name)
        head = dispatch.explain("matmul", m=8, k=d, n=cfg32.vocab_size,
                                cfg=cfg32, tp=2, gemv=True, pallas=True)
        want.add(head[0].name)
        names = {"skinny_dbb": "dbb_gemm_skinny", "dbb_packed": "dbb_gemm",
                 "skinny_sta": "sta_gemm_skinny", "sta": "sta_gemm"}
        got = {k for k in by_path["tp2_generate_f32"] if k in names.values()
               and by_path["tp2_generate_f32"][k]}
        ex_ok = {names.get(w, w) for w in want} == got
        print(f"tp: explain(tp=2, collective=...) at olmo's M8 / M512 GEMMs "
              f"and head chose {sorted(want)}; rank 0 launched {sorted(got)} "
              f"{'ok' if ex_ok else 'FAIL'}")
        print(dispatch.format_table(dispatch.explain(
            "matmul", m=8, k=f, n=d, cfg=cfg32, tp=2, collective="all-reduce",
            packed=True, nnz=4, vals_itemsize=4)))
        ok = ok and ex_ok
        del tree_ep, eng_ep
        gc.collect()
        torch.cuda.empty_cache()
        rec["kernels"] = _tp_kernels(torch, dev,
                                     [len(p) for p in serve_prompts])
        rec["phase_s"] = time.perf_counter() - t_phase
        print(f"tp: phase {rec['phase_s']:.1f} s ({report['card']})")
        return by_path, ok
    finally:
        if any(p.is_alive() for p in world4[1]):
            _tp_stop(world4)


def _tp_generate_check(torch, dev, world, new, wall, ranks, single, refs,
                       by_path, rec):
    """A world's f32 generate against the single-device kernel route:
    prefill logits within TP_LOGIT_TOL, greedy streams by the split rule,
    every rank's kernels launched as often, 0 decompress calls, the ranks'
    streams equal. ok."""
    out1, counts1, _, steps1, _ = single
    r0 = ranks[0]
    out, counts, _, _, ms = r0["gen"]
    tag = f"tp{world}"
    same_ranks = all(r["gen"][0] == out for r in ranks)
    wrap = all(r["tp_reason"] == "" for r in ranks)
    lg1 = refs["lg1"]
    scale = lg1.abs().max().item()
    tol = TP_LOGIT_TOL * scale
    diff = (torch.from_numpy(r0["gen_logits"]).to(dev)
            - lg1).abs().max().item()
    same, total, split = _split_rows(out, out1)
    gaps = _split_gaps(torch, refs["last32"], refs["cfg32"],
                       refs["prompts"], out, out1, split)
    f32_ok = diff <= tol and all(g <= 2 * tol for g in gaps)
    kern1 = _tp_kernel_names(counts1)
    launch_ok = all(_tp_kernel_names(r["gen"][1]) == kern1
                    and r["gen"][2] == 0 and r["gen"][3] == steps1
                    for r in ranks)
    since = "spawn" if world == 2 else "its gate (set up while tp 2 ran)"
    print(f"{tag}: {world} ranks, {wall:.1f} s from {since} to the last "
          f"result; wrap {'on' if wrap else 'OFF'} on every rank; f32 "
          f"generate 8 prompts x {new} new ({ms:.1f} ms): prefill "
          f"logits vs the single-device kernel route max abs diff "
          f"{diff:.4e} of max |logit| {scale:.4e} (tol {TP_LOGIT_TOL:g} of "
          f"max); greedy tokens {same}/{total} equal, splits (row, step, "
          f"single-device gap; bound {2 * tol:.4e}) "
          f"{[(i, j, g) for (i, j), g in zip(split, gaps)]}; ranks' "
          f"streams {'equal' if same_ranks else 'DIFFERENT'}; collectives "
          f"alone {r0['collective_ms_f32']:.3f} ms a decode step (gloo on "
          f"one card, not NVLink) {'ok' if f32_ok else 'FAIL'}")
    print(f"{tag}: rank 0 launches {counts}; single device {counts1}; "
          f"decompress calls {[r['gen'][2] for r in ranks]} "
          f"{'ok' if launch_ok else 'FAIL'}")
    by_path[f"{tag}_generate_f32"] = counts
    rec[tag] = dict(wall_s=wall, generate_ms=ms, logit_diff=diff,
                    logit_scale=scale, token_agreement=[same, total],
                    token_splits=[[i, j, g] for (i, j), g
                                  in zip(split, gaps)],
                    collective_ms_f32=r0["collective_ms_f32"])
    return same_ranks and wrap and f32_ok and launch_ok


def _tp_full_checks(torch, dev, ranks, refs, by_path, rec):
    """The 2-rank world's bf16 serve, sampled serve and EP run against the
    single-device kernel route: ok."""
    r0 = ranks[0]
    same_ranks = all(r[k][0] == r0[k][0] for r in ranks
                     for k in ("serve", "sample", "ep"))
    # bf16: distance from f32 within LM_BF16_MARGIN x the single device's
    lg32, lg16 = refs["lg32_serve"], refs["lg16_serve"]
    reach = (lg16 - lg32).abs().max().item()          # bf16's own
    scale = lg32.abs().max().item()
    dist = (torch.from_numpy(r0["serve_logits"]).to(dev)
            - lg32).abs().max().item()
    out, counts, _, _, ms = r0["serve"]
    single16 = refs["single16"]
    same, total, split = _split_rows(out, single16)
    gaps = _split_gaps(torch, refs["last16"], refs["cfg16"],
                       refs["serve_prompts"], out, single16, split)
    kern = _tp_kernel_names(refs["single16_counts"])
    launch_ok = all(_tp_kernel_names(r["serve"][1]) == kern
                    and r["serve"][2] == 0 for r in ranks)
    bf16_ok = (dist <= LM_BF16_MARGIN * reach
               and all(g <= 2 * reach for g in gaps) and launch_ok)
    print(f"tp2: bf16 serve of the serve phase's first {TP_SERVE_REQS} "
          f"requests (packed prefill, paged, {TP_CHUNK}-token chunks): "
          f"{ms:.1f} ms; "
          f"last-position logits' distance from the single-device f32 "
          f"route {dist / scale:.3e} of max |logit|, the single-device "
          f"bf16 route's {reach / scale:.3e} (tol {LM_BF16_MARGIN:g} x); "
          f"tokens vs the serve phase's serve_chunked streams {same}/"
          f"{total} equal, splits (row, step, gap; bound {2 * reach:.4e}) "
          f"{[(i, j, g) for (i, j), g in zip(split, gaps)]}; launches "
          f"{counts} (as one device's serve of the same requests, "
          f"{refs['single16_counts']}: {'ok' if launch_ok else 'FAIL'}); "
          f"collectives alone "
          f"{r0['collective_ms_bf16']:.3f} ms a decode step (gloo on one "
          f"card) {'ok' if bf16_ok else 'FAIL'}")
    by_path["tp2_serve"] = counts
    # sampled draft_k=2: the temperature-0 request follows its greedy
    # stream up to the split rule (verify's head rounds apart from decode's)
    sout, scounts, _, _, sms = r0["sample"]
    tsame, ttotal, tsplit = _split_rows(sout[:1], out[:1])
    tgaps = _split_gaps(torch, refs["last16"], refs["cfg16"],
                        refs["serve_prompts"][:1], sout[:1], out[:1],
                        tsplit)
    t0_ok = all(g <= 2 * reach for g in tgaps)
    moved = sum(a != b for i in range(1, len(sout))
                for a, b in zip(sout[i], out[i]))
    print(f"tp2: sampled serve, draft_k=2, requests 0-{len(sout) - 1}: "
          f"{sms:.1f} ms; request 0 (temperature 0) vs its greedy stream "
          f"{tsame}/{ttotal} tokens equal, splits "
          f"{[(i, j, g) for (i, j), g in zip(tsplit, tgaps)]} (bound "
          f"{2 * reach:.4e}); {moved} tokens of the others moved by the "
          f"noise; launches {scounts} {'ok' if t0_ok else 'FAIL'}")
    by_path["tp2_sample"] = scounts
    # EP: arctic at tp 2 against the single-device kernel route
    eout, ecounts = r0["ep"][0], r0["ep"][1]
    ep1, ep_counts1 = refs["ep1"][0], refs["ep1"][1]
    lg_ep1 = refs["lg_ep1"]
    ep_scale = lg_ep1.abs().max().item()
    ep_tol = TP_LOGIT_TOL * ep_scale
    ep_diff = (torch.from_numpy(r0["ep_logits"]).to(dev)
               - lg_ep1).abs().max().item()
    esame, etotal, esplit = _split_rows(eout, ep1)
    egaps = _split_gaps(torch, refs["last_ep"], refs["cfg_ep"],
                        refs["ep_prompts"], eout, ep1, esplit)
    # expert parallelism ran: each rank's dispatches took its own half of
    # the experts, so (every expert runs) its expert GEMMs launch half as
    # often as the single device's and the rest (attention, the dense
    # residual, the head) as often
    arch, experts, layers = TP_EP
    in1, out1, win1 = _ep_split(ep_counts1, refs["ep_calls"])
    split = [_ep_split(r["ep"][1], r["ep_calls"]) for r in ranks]
    e_loc = experts // len(ranks)
    ep_split_ok = (win1 == [(0, experts)] and bool(in1) and all(
        win == [(i * e_loc, e_loc)] and out == out1
        and {k: 2 * v for k, v in inn.items()} == in1
        for i, (inn, out, win) in enumerate(split)))
    ep_ok = (ep_diff <= ep_tol and all(g <= 2 * ep_tol for g in egaps)
             and r0["ep_reason"] != "" and ep_split_ok)
    print(f"tp2: EP {arch} ({layers} layers, {experts} experts, w4 planes, "
          f"f32): wrap off ({r0['ep_reason']!r}); experts a rank, read "
          f"from each rank's MoE dispatches: "
          f"{[[n for _, n in win] for _, _, win in split]} (windows "
          f"{[win for _, _, win in split]}; single device {win1}); expert "
          f"GEMM launches a rank {[inn for inn, _, _ in split]}, single "
          f"device {in1}; other launches a rank as the single device's "
          f"{out1}: {'ok' if ep_split_ok else 'FAIL'}; prefill logits vs "
          f"the single-device kernel route {ep_diff:.4e} of max |logit| "
          f"{ep_scale:.4e} (tol {TP_LOGIT_TOL:g} of max); tokens "
          f"{esame}/{etotal} equal, splits "
          f"{[(i, j, g) for (i, j), g in zip(esplit, egaps)]}; rank 0 "
          f"launches {ecounts}, single device {ep_counts1} "
          f"{'ok' if ep_ok else 'FAIL'}")
    by_path["tp2_ep_f32"] = ecounts
    print(f"tp2: the ranks' bf16, sampled and EP streams "
          f"{'equal' if same_ranks else 'DIFFERENT'}")
    rec["tp2"].update(serve_ms=ms, bf16_dist=dist, bf16_reach=reach,
                      logit_scale_serve=scale,
                      serve_agreement=[same, total], sample_ms=sms,
                      ep_logit_diff=ep_diff, ep_agreement=[esame, etotal],
                      ep_experts_a_rank=[[n for _, n in win]
                                         for _, _, win in split],
                      collective_ms_bf16=r0["collective_ms_bf16"])
    return same_ranks and bf16_ok and t0_ok and ep_ok


def _tp_kernels(torch, dev, lens):
    """The kernels at olmo-1b's 2-rank shard shapes (``tp_shapes`` in the
    kernels line), each against its plain version and timed as the kernel
    phase times them: dbb_gemm (M512) and dbb_gemm_skinny (M8) bf16 on f32
    planes at the column splits K2048 N1024 (q / k / v) and N4096 (wi, wg)
    and the row splits K1024 N2048 (o_proj) and K4096 N2048 (wo), sta_gemm
    at M512 K2048 N4096 bf16 (a dense column split), the greedy head
    sta_gemm_skinny M8 K2048 N25152 f32, paged_decode at 8 KV heads (B8,
    S640, 64-slot pages, bf16), flash_prefill at 8 heads (B8 T=S=64 f32,
    generate's) and flash_prefill_packed (``lens``: the first 8 serve
    requests, bf16), and head_sample_fused on the 128-multiple column
    slice [25088, 50176) of olmo's head with base 25088 (olmo's N/2 =
    25152 is no multiple of the 128-column tile, so the TP sampled head
    takes the plain sampler)."""
    import torch.nn.functional as F

    from repro_torch.core.dbb import decompress_bitmask, pack_dbb
    from repro_torch.kernels.attn.ops import (flash_attention,
                                              packed_flash_attention,
                                              paged_decode_attention)
    from repro_torch.kernels.attn.ref import (flash_prefill_ref,
                                              packed_prefill_ref,
                                              paged_decode_ref)
    from repro_torch.kernels.dbb_gemm.ops import dbb_gemm
    from repro_torch.kernels.dbb_gemm.ref import dbb_gemm_ref
    from repro_torch.kernels.sample import (head_sample_fused,
                                            head_sample_fused_ref,
                                            sample_scores)
    from repro_torch.kernels.skinny.ops import dbb_gemm_skinny, \
        sta_gemm_skinny
    from repro_torch.kernels.sta_gemm.ops import sta_gemm
    from repro_torch.kernels.sta_gemm.ref import sta_gemm_ref
    gen = torch.Generator(device=dev).manual_seed(32)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    bf16, i32 = torch.bfloat16, dict(dtype=torch.int32, device=dev)
    rows, failures = {}, []

    def randn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def record(label, err, ok, ms, pms, lms, lib, bms, by):
        if not ok:
            failures.append(f"{label}: max err {err}")
        ratio = f" ({ms / lms:.2f}x)" if lms else ""
        print(f"kernel {label} (tp 2 shard): max abs err {err:.3e} "
              f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms, "
              + (f"{lib} {lms:.4f} ms{ratio}" if lms else "no library call "
                 "computes it")
              + f", bound {bms:.4f} ms ({by})")
        rows[label] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                           library_ms=lms, bound_ms=bms, bound_by=by)

    for name, fn, m in (("dbb_gemm", dbb_gemm, 512),
                        ("dbb_gemm_skinny", dbb_gemm_skinny, 8)):
        for k_dim, n in ((2048, 1024), (2048, 4096), (1024, 2048),
                         (4096, 2048)):
            x = randn(m, k_dim)
            p = pack_dbb(torch.randn((k_dim, n), generator=gen, device=dev)
                         * k_dim ** -0.5, 8, 4)
            vals, bits = p.values, p.bitmask
            wd = decompress_bitmask(vals, bits, block=8).to(bf16)
            got, want = fn(x, vals, bits), dbb_gemm_ref(x, vals, bits)
            err, ok = _close(torch, got, want, 2e-2)
            ms = _time_ms(torch, lambda: fn(x, vals, bits), flush)
            pms = _time_ms(torch, lambda: dbb_gemm_ref(x, vals, bits), flush)
            lms = _time_ms(torch, lambda: torch.matmul(x, wd), flush)
            stored = vals.numel() * 4 + bits.numel() * 4
            live = int((wd != 0).sum().item())
            bms, by = _bound_ms(x.numel() * 2 + stored + m * n * 2,
                                2.0 * m * live, BF16_OPS_PER_S)
            record(f"{name} M{m} K{k_dim} N{n} bf16 f32 planes", err, ok,
                   ms, pms, lms, "torch.matmul on the decompressed weight",
                   bms, by)
            del x, p, vals, bits, wd, got, want
    x, w = randn(512, 2048), randn(2048, 4096, scale=2048 ** -0.5)
    err, ok = _close(torch, sta_gemm(x, w), sta_gemm_ref(x, w), 2e-2)
    record("sta_gemm M512 K2048 N4096 bf16", err, ok,
           _time_ms(torch, lambda: sta_gemm(x, w), flush),
           _time_ms(torch, lambda: sta_gemm_ref(x, w), flush),
           _time_ms(torch, lambda: torch.matmul(x, w), flush),
           "torch.matmul", *_bound_ms((x.numel() + w.numel() + 512 * 4096)
                                      * 2, 2.0 * 512 * 2048 * 4096,
                                      BF16_OPS_PER_S))
    x = randn(8, 2048, dtype=torch.float32)
    w = randn(2048, 25152, scale=2048 ** -0.5, dtype=torch.float32)
    err, ok = _close(torch, sta_gemm_skinny(x, w), sta_gemm_ref(x, w), 1e-4)
    record("sta_gemm_skinny M8 K2048 N25152 f32 (greedy head)", err, ok,
           _time_ms(torch, lambda: sta_gemm_skinny(x, w), flush),
           _time_ms(torch, lambda: sta_gemm_ref(x, w), flush),
           _time_ms(torch, lambda: torch.matmul(x, w), flush),
           "torch.matmul", *_bound_ms((x.numel() + w.numel() + 8 * 25152)
                                      * 4, 2.0 * 8 * 2048 * 25152,
                                      F32_OPS_PER_S))
    del x, w

    b, hkv, g, d, page, s = 8, 8, 1, 128, 64, 640
    scale = d ** -0.5
    n_log = s // page
    qd = randn(b, hkv, g, d)
    kc, vc = randn(b, s, hkv, d), randn(b, s, hkv, d)
    kp, vp = (a.view(b * n_log, page, hkv, d) for a in (kc, vc))
    table = (torch.arange(b, **i32)[:, None] * n_log
             + torch.arange(n_log, **i32)[None, :])
    lengths = torch.arange(256, 256 + 48 * b, 48, **i32)[:b]
    st = torch.zeros((b,), **i32)
    got = paged_decode_attention(qd, kp, vp, table, lengths, st)
    want = paged_decode_ref(qd, kp, vp, table, lengths, st, sm_scale=scale)
    err, ok = _close(torch, got, want, 2e-2)
    qs = qd.reshape(b, hkv * g, 1, d)
    ks, vs = (a.transpose(1, 2) for a in (kc, vc))
    am = (torch.arange(s, device=dev)[None, :]
          <= lengths[:, None])[:, None, None, :]
    valid = int((lengths + 1).sum().item())
    record(f"paged_decode B{b} Hkv{hkv} G{g} D{d} S{s} page{page} bf16",
           err, ok,
           _time_ms(torch, lambda: paged_decode_attention(
               qd, kp, vp, table, lengths, st), flush),
           _time_ms(torch, lambda: paged_decode_ref(
               qd, kp, vp, table, lengths, st, sm_scale=scale), flush),
           _time_ms(torch, lambda: F.scaled_dot_product_attention(
               qs, ks, vs, attn_mask=am), flush),
           "scaled_dot_product_attention",
           *_bound_ms(qd.numel() * 2 * 2 + valid * hkv * d * 2 * 2,
                      4.0 * valid * hkv * g * d, BF16_OPS_PER_S))
    del qd, kc, vc, kp, vp, qs, ks, vs

    hq = 8
    b, t = 8, 64
    q, k, v = (randn(b, t, hq, d, dtype=torch.float32) for _ in range(3))
    st = torch.zeros((b,), **i32)
    qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    err, ok = _close(torch, flash_attention(q, k, v, st), flash_prefill_ref(
        qh, kh, vh, st, st, sm_scale=scale).transpose(1, 2), 1e-4)
    pairs = b * t * (t + 1) // 2
    record(f"flash_prefill B{b} T=S={t} Hq{hq} Hkv{hq} D{d} f32", err, ok,
           _time_ms(torch, lambda: flash_attention(q, k, v, st), flush),
           _time_ms(torch, lambda: flash_prefill_ref(
               qh, kh, vh, st, st, sm_scale=scale), flush),
           _time_ms(torch, lambda: F.scaled_dot_product_attention(
               qh, kh, vh, is_causal=True), flush),
           "scaled_dot_product_attention",
           *_bound_ms(4 * 4 * b * t * hq * d, 4.0 * d * pairs * hq,
                      F32_OPS_PER_S))
    tt = sum(lens)
    q, k, v = randn(tt, hq, d), randn(tt, hq, d), randn(tt, hq, d)
    seg = torch.repeat_interleave(torch.arange(len(lens), **i32),
                                  torch.tensor(lens, device=dev))
    ii = torch.arange(tt, device=dev)
    mask = (ii[None, :] <= ii[:, None]) & (seg[None, :] == seg[:, None])
    qh, kh, vh = (a.transpose(0, 1).contiguous() for a in (q, k, v))
    err, ok = _close(torch, packed_flash_attention(q, k, v, seg),
                     packed_prefill_ref(qh, kh, vh, seg,
                                        sm_scale=scale).transpose(0, 1),
                     ATTN_RTOL, ATTN_ATOL)
    pairs = sum(n * (n + 1) // 2 for n in lens)
    record(f"flash_prefill_packed T{tt} over {len(lens)} segments Hq{hq} "
           f"Hkv{hq} D{d} bf16", err, ok,
           _time_ms(torch, lambda: packed_flash_attention(q, k, v, seg),
                    flush),
           _time_ms(torch, lambda: packed_prefill_ref(
               qh, kh, vh, seg, sm_scale=scale), flush),
           _time_ms(torch, lambda: F.scaled_dot_product_attention(
               qh[None], kh[None], vh[None], attn_mask=mask), flush),
           "scaled_dot_product_attention",
           *_bound_ms(4 * 2 * tt * hq * d, 4.0 * d * pairs * hq,
                      BF16_OPS_PER_S))
    del q, k, v, qh, kh, vh, mask

    # head_sample_fused on the second rank's 128-aligned column slice
    h, w, counts, knobs = _head_sample_inputs(torch, dev, 8, 2048, 50304, 32)
    lo, hi = 25088, 50176
    ws, cs = w[:, lo:hi].contiguous(), counts[:, lo:hi].contiguous()
    got_s, got_i = head_sample_fused(h, ws, cs, *knobs, base=lo)
    want_s, want_i = head_sample_fused_ref(h, ws, cs, *knobs, base=lo)
    torch.cuda.synchronize()
    # `_head_sample_case`'s rule: scores within 1e-5 of the largest, the
    # indices equal on every row whose top-2 score margin exceeds twice it
    tol = 1e-5 * max(want_s.abs().max().item(), 1.0)
    err = (got_s - want_s).abs().max().item()
    m, n = 8, hi - lo
    col = lo + torch.arange(n, device=dev)[None, :]
    top2 = sample_scores(h @ ws, cs, *(a[:, None] for a in knobs),
                         col).topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * tol
    ok = err <= tol and bool((got_i == want_i)[decided].all())
    record(f"head_sample_fused M8 K2048 N{n} f32 base {lo}", err, ok,
           _time_ms(torch, lambda: head_sample_fused(h, ws, cs, *knobs,
                                                     base=lo), flush),
           _time_ms(torch, lambda: head_sample_fused_ref(
               h, ws, cs, *knobs, base=lo), flush), None,
           "",
           *_bound_ms(4 * (2048 * n + m * n + m * 2048 + 8 * m),
                      2.0 * m * 2048 * n + SAMPLE_EPI_OPS * m * n,
                      F32_OPS_PER_S))
    if failures:
        raise SystemExit(_fail("a kernel disagrees with its plain version "
                               "at the TP shard shapes: "
                               + "; ".join(failures)))
    return rows


# ---------------------------------------------------------------------------
# phase 21: training on a mesh, gloo ranks sharing the card
# ---------------------------------------------------------------------------

TP_TRAIN_LAYERS = 2              # olmo-1b's depth here (16 published): the
                                 # 2 x 2 run moves its gradients through the
                                 # host (gloo on CUDA tensors), ~0.5 GB/layer
TP_TRAIN_SEQ, TP_TRAIN_BATCH = 256, 8   # the train phase's shape
TP_TRAIN_STEPS = 3
TP_TRAIN_RAMP = 2                # the bound anneals 8 -> 6 -> 4 over them
TP_TRAIN_MESHES = ((1, 2), (2, 2))      # data x model: TP + SP; DP x TP
# experts, layers, steps of arctic's EP run (SGD: two ranks' AdamW states
# at 1 layer, 9.4 GB of params, did not fit beside each other on the card)
TP_TRAIN_MOE = ("arctic-480b", 16, 1, 2)
# the CLI on the 2 x 2 mesh (in process on each rank, as under torchrun),
# and on one device: 2 steps, a checkpoint after each
TP_TRAIN_CLI_STEPS = 2
TP_TRAIN_ARGV = (f"--arch olmo-1b --full --steps {TP_TRAIN_CLI_STEPS} "
                 "--seq-len 256 --batch 8 --dbb-ramp 2 --checkpoint-every 1")
TP_TRAIN_LOSS_RTOL = 1e-4        # a mesh step's loss and grad norm (and
                                 # aux) vs one device's
# params after a mesh step vs one device's, max |diff|: the reference's
# bound (its own test holds a 2 x 4 step to 5e-4 at lr 1e-3). At AdamW's
# warm-up lr here (3e-5, 6e-5, 9e-5) 3 steps move a param by 2.6e-4 at
# most (measured), so this bound alone would pass a mesh that never
# updated:
TP_TRAIN_PARAM_TOL = 5e-4
# the update's relative error ||Δmesh - Δone|| / ||Δone|| (Δ from the
# initial tree), which a mesh left at its initial state reads as 1 and one
# without its gradient sum over "data" as 0.81-0.97 (olmo smoke, CPU).
# Measured on the H100: f32 (the step jobs) 3.9e-6 to 1.9e-5; the CLI's
# bf16 activations 2.8e-2 after 2 steps, 6.1e-2 after 1 (AdamW's first
# steps move each element by ~lr in the sign of its gradient, and bf16
# rounding flips the sign of the smallest: 163,348 of 237M elements
# after step 1; scripts/torch_mesh_train_probe.py cli)
TP_TRAIN_UPDATE_RTOL = 1e-3
TP_TRAIN_CLI_UPDATE_RTOL = 0.15
TP_TRAIN_LOGIT_TOL = 1e-3        # the two trained trees' f32 serve logits
TP_TRAIN_NEW = 16                # greedy tokens per prompt in the serve


def _tp_train_config(arch, layers, experts=0):
    """The phase's config of ``arch``: published widths (smoke widths in
    a CPU rehearsal) at ``layers`` layers, f32, ``experts`` experts."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch, smoke=TP_SMOKE).replace(num_layers=layers,
                                                   dtype="float32")
    if experts:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  num_experts=experts))
    return cfg


def _tp_train_cut_config(arch, smoke=False):
    """`get_config` for the CLI runs: the phase's olmo-1b depth."""
    from repro_torch.configs import get_config
    return get_config(arch, smoke=smoke or TP_SMOKE).replace(
        num_layers=TP_TRAIN_LAYERS)


def _tp_train_patch_cli(ttrain):
    """Point the training CLI (``ttrain``, its module) at the phase's depth
    (its `get_config`) and a metric line every step (its run config's
    ``log_every``: the CLI logs every 10th step, as the reference's, and
    has no flag for it). Returns the undo."""
    import dataclasses
    saved = ttrain.get_config, ttrain._run_cfg

    def every_step(args):
        rc = saved[1](args)
        return dataclasses.replace(rc, train=dataclasses.replace(
            rc.train, log_every=1))
    ttrain.get_config, ttrain._run_cfg = _tp_train_cut_config, every_step

    def undo():
        ttrain.get_config, ttrain._run_cfg = saved
    return undo


def _tp_train_runcfg(cfg):
    from repro_torch.config import RunConfig, TrainConfig
    return RunConfig(model=cfg, train=TrainConfig(
        steps=TP_TRAIN_STEPS, dbb_prune_ramp=TP_TRAIN_RAMP,
        optimizer="adamw" if cfg.family == "dense_lm" else "sgd"))


def _tp_train_job(arch, steps):
    """(config, run config, the pipeline, the bound per step) of a run."""
    from repro_torch.config import ShapeSpec
    from repro_torch.core.sparsity import dbb_schedule_nnz
    from repro_torch.data.pipeline import make_pipeline
    if arch == "olmo-1b":
        cfg = _tp_train_config(arch, TP_TRAIN_LAYERS)
    else:
        cfg = _tp_train_config(arch, TP_TRAIN_MOE[2], TP_TRAIN_MOE[1])
    rc = _tp_train_runcfg(cfg)
    pipe = make_pipeline(cfg, ShapeSpec("t", TP_TRAIN_SEQ, TP_TRAIN_BATCH,
                                        "train"), seed=0)
    nnz = [dbb_schedule_nnz(cfg.dbb, s, 0, TP_TRAIN_RAMP)
           for s in range(steps)]
    return cfg, rc, pipe, nnz


def _tp_train_steps(torch, dev, arch, steps, plan=None, state=None,
                    save=None):
    """``steps`` train steps of ``arch`` from seed 0's tree (one device, or
    this rank's shards under ``plan``): per step (loss, aux, grad_norm,
    ms, kernel launches); ``save(step, state)`` after each."""
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.train.loop import (init_train_state, make_train_step,
                                        rank_batch)
    cfg, rc, pipe, nnz = _tp_train_job(arch, steps)
    if state is None:
        state = init_train_state(rc, device=dev)
    fns, rows = {}, []
    for s in range(steps):
        if nnz[s] not in fns:
            fns[nnz[s]] = make_train_step(rc, nnz=nnz[s], plan=plan)
        host = pipe.batch_at(s)
        if plan is not None:
            host = rank_batch(host, plan)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in host.items()}
        _sync(torch, dev)
        reset_launches()
        t0 = time.perf_counter()
        state, m = fns[nnz[s]](state, batch)
        _sync(torch, dev)
        ms = (time.perf_counter() - t0) * 1e3
        rows.append(dict(step=s, nnz=nnz[s], loss=float(m["loss"]),
                         aux=float(m["aux"]), grad_norm=float(m["grad_norm"]),
                         ms=ms, launches=sum(LAUNCHES.values())))
        if save is not None:
            save(s, state)
    return state, rows


def _tp_train_split_bytes(torch, plan, params, opt_state):
    """(whole bytes, this rank's bytes) of the leaves the plan splits and
    their optimizer moments."""
    from repro_torch.train.tree import tree_map
    acc = [0, 0]

    def add(t, spec):
        axes = [a for e in tuple(spec)
                for a in ((e,) if isinstance(e, str) else (e or ()))]
        if axes:
            n = 1
            for a in axes:
                n *= plan.mesh.shape[a]
            acc[0] += t.numel() * t.element_size() * n
            acc[1] += t.numel() * t.element_size()
    tree_map(add, params, plan.specs)
    for moment in opt_state.values():
        tree_map(add, moment, plan.specs)
    return acc


def _tp_train_rank(rank, world, store, path, queue):
    """One rank of a mesh-training world (spawned by `_tp_start`): the
    world's jobs in turn, each after its gate file (if any) exists, each
    result dict (or the traceback) to ``queue`` tagged with the job's
    index. A ``steps`` job trains on the job's mesh under `train.loop`'s
    plan (a process group over a ``file://`` store) and holds each step's
    params against the single-device run's files; a ``cli`` job runs
    ``repro_torch.launch.train.main`` as one rank of a torchrun-style
    world (the env:// variables set, the CLI patched by
    `_tp_train_patch_cli`). A ``steps`` job makes its process group and
    mesh before its gate, and a ``warm`` one runs steps at the phase's
    shapes on them there (`_tp_train_warm`: the first step's cold cost),
    so the world can be spawned a phase early. One process runs several
    jobs, so only the first pays the cold start."""
    import gc
    import pickle
    import traceback
    i = -1
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with open(path, "rb") as f:
            world_job = pickle.load(f)
        global TP_SMOKE
        TP_SMOKE = world_job["smoke"]
        dev = torch.device(world_job["device"])
        if dev.type == "cuda":
            dev = torch.device("cuda", 0)
            torch.cuda.set_device(dev)
            torch.zeros(1, device=dev)
        from repro_torch.dist.mesh_ctx import make_mesh
        for i, job in enumerate(world_job["jobs"]):
            if job["kind"] == "steps":
                dist.init_process_group(
                    TP_BACKEND, init_method=f"file://{store}{i}",
                    rank=rank, world_size=world)
                mesh = make_mesh(*job["mesh"], backend=TP_BACKEND)
                if job.get("warm"):
                    _tp_train_warm(torch, mesh, dev, job["warm"])
            t0 = time.perf_counter()
            while job.get("gate") and not os.path.exists(job["gate"]):
                if time.perf_counter() - t0 > 8 * TP_TIMEOUT:
                    raise RuntimeError("the gate never opened")
                time.sleep(0.05)
            if job["kind"] == "cli":
                res = _tp_train_cli_rank(torch, rank, world, job, dev)
            else:
                res = _tp_train_steps_rank(torch, job, dev, mesh)
                dist.barrier()
                dist.destroy_process_group()
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            queue.put(dict(res, rank=rank, job=i))
    except Exception:                                   # noqa: BLE001
        queue.put({"rank": rank, "job": i, "error": traceback.format_exc()})


def _tp_train_collect(started, job):
    """The ranks' results of job ``job`` of a world started by `_tp_start`
    (results of later jobs that arrive first are kept for their turn) and
    the seconds since the world's clock (its spawn or its last collect);
    a rank's error, a rank gone or TP_TIMEOUT raises."""
    import queue as queue_mod
    world, procs, q, tmp, t0 = started
    kept = getattr(q, "_tp_kept", None)
    if kept is None:
        kept = q._tp_kept = []
    got = [r for r in kept if r["job"] == job]
    kept[:] = [r for r in kept if r["job"] != job]
    while len(got) < world:
        try:
            r = q.get(timeout=5)
        except queue_mod.Empty:
            dead = [p.exitcode for p in procs
                    if not p.is_alive() and p.exitcode != 0]
            if dead or time.perf_counter() - t0 > TP_TIMEOUT:
                raise RuntimeError(
                    f"a rank of the {world}-rank world: " + (
                        f"exit code {dead[0]}, no result" if dead else
                        f"no result for job {job} within {TP_TIMEOUT} s"))
            continue
        if "error" in r:
            raise RuntimeError(f"rank {r['rank']} of the {world}-rank "
                               f"world failed job {r['job']}:\n"
                               + r["error"])
        (got if r["job"] == job else kept).append(r)
    return sorted(got, key=lambda g: g["rank"]), time.perf_counter() - t0


def _tp_train_open(started, gate):
    """Open a job's gate; the world's clock starts now."""
    world, procs, q, tmp, _ = started
    open(gate, "w").close()
    return world, procs, q, tmp, time.perf_counter()


def _tp_train_warm(torch, mesh, dev, dtypes):
    """olmo-1b's steps at the phase's shapes on ``mesh`` (full width cut to
    1 layer, B8 S256, a step at each bound of the ramp), once with each of
    ``dtypes`` as its activations, discarded. A process's first full-width
    step costs ~8-13 s more than the next, on one device as on a mesh,
    most of it ``torch.utils.checkpoint``'s first call importing
    ``torch._dynamo`` (the layers are checkpointed from d_model 1024 on:
    a smoke-width step does not pay it; PERF.md §6)."""
    import gc

    from repro_torch.models import registry
    from repro_torch.train.loop import (init_train_state, make_train_step,
                                        plan_mesh, rank_batch)
    for dtype in dtypes:
        cfg, _, pipe, nnz = _tp_train_job("olmo-1b", TP_TRAIN_STEPS)
        cfg = cfg.replace(num_layers=1, dtype=dtype)
        rc = _tp_train_runcfg(cfg)
        params = registry.init_params(cfg, seed=1, device=dev)
        plan = plan_mesh(params, rc, mesh)
        state = init_train_state(rc, device=dev, params=params, plan=plan)
        del params
        for s in range(TP_TRAIN_STEPS):
            batch = rank_batch(pipe.batch_at(s), plan)
            state, _ = make_train_step(rc, nnz=nnz[s], plan=plan)(
                state, {k: torch.as_tensor(v).to(dev)
                        for k, v in batch.items()})
        del state
    _sync(torch, dev)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _tp_train_steps_rank(torch, job, dev, mesh):
    import torch.distributed as dist

    from repro_torch.core.sparsity import map_with_path
    from repro_torch.dist.collectives import reduce_max
    from repro_torch.dist.mesh_ctx import use_mesh
    from repro_torch.dist.sharding import shard_tree
    from repro_torch.models import registry
    from repro_torch.train.loop import init_train_state, plan_mesh
    cfg, rc, _, _ = _tp_train_job(job["arch"], job["steps"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = registry.init_params(cfg, seed=0, device=dev)
    plan = plan_mesh(params, rc, mesh)
    state = init_train_state(rc, device=dev, params=params, plan=plan)
    del params
    whole_b, mine_b = _tp_train_split_bytes(torch, plan, state.params,
                                            state.opt_state)
    # the initial shards, on the host: the peak device memory stays the
    # run's own
    p0, errs = {}, []
    if job["single"]:
        map_with_path(lambda p, t: p0.__setitem__(p, t.cpu()), state.params)

    def compare(s, st):
        """This rank's shards vs the single device's params after step s,
        over every rank: max |diff|, the single device's max |update|
        (what a mesh left at its initial state would read) and the
        update's relative error."""
        path = job["single"][s]
        t0 = time.perf_counter()
        while not os.path.exists(path):
            if time.perf_counter() - t0 > TP_TIMEOUT:
                raise RuntimeError(f"no single-device params at {path}")
            time.sleep(0.05)
        ref = torch.load(path, mmap=True)
        specs = {}
        map_with_path(lambda p, sp: specs.__setitem__(p, sp), plan.specs)
        # max |diff|, max |update|, sum diff^2, sum update^2
        acc = torch.zeros(4, dtype=torch.float64, device=dev)

        def one(p, t):
            want = shard_tree(ref[p], specs[p], mesh).to(dev)
            d, u = (t - want).double(), (want - p0[p].to(dev)).double()
            acc[0] = torch.maximum(acc[0], d.abs().max())
            acc[1] = torch.maximum(acc[1], u.abs().max())
            acc[2] += (d * d).sum()
            acc[3] += (u * u).sum()
        with torch.no_grad():
            map_with_path(one, st.params)
        with use_mesh(mesh):
            top = reduce_max(acc[:2], mesh.axis_names)
        sums = acc[2:].clone()
        dist.all_reduce(sums)
        errs.append((top[0].item(), top[1].item(),
                     (sums[0] / sums[1]).sqrt().item()))

    state, rows = _tp_train_steps(
        torch, dev, job["arch"], job["steps"], plan=plan, state=state,
        save=compare if job["single"] else None)
    for r, (e, move, rel) in zip(rows, errs):
        r.update(param_err=e, param_move=move, update_err=rel)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    zero = any(a in ("data", "pod") for sp in plan.gather.values()
               for e in sp for a in ((e,) if isinstance(e, str) else e or ()))
    return dict(rows=rows, peak=peak, split_bytes=(whole_b, mine_b),
                split=sorted(plan.layout.split), zero=zero)


def _tp_train_cli_rank(torch, rank, world, job, dev):
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.launch import train as ttrain
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(job["port"]))
    _tp_train_patch_cli(ttrain)
    lines, rep = [], {}
    reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ttrain.main(job["argv"], device=str(dev), log=lines.append, report=rep)
    return dict(lines=lines, history=rep["history"], backend=rep["backend"],
                wall=time.perf_counter() - t0,
                launches=sum(LAUNCHES.values()),
                peak=(torch.cuda.max_memory_allocated(dev)
                      if dev.type == "cuda" else 0))


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tp_train_spawn(torch, dev):
    """Start the mesh-training phase's two worlds (called a phase early:
    the ranks set up and warm up while the train phase runs): 2 ranks
    (olmo 1 x 2, then arctic's EP) and 4 (olmo 2 x 2, then the CLI, then
    its resume), every job gated: `_tp_train_phase` opens the gates. The
    handle holds the worlds and the phase's paths under ``build/``."""
    import tempfile
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=build_dir)
    root = tmp.name
    gates = {k: os.path.join(root, f"gate_{k}")
             for k in ("start", "ep", "resume")}
    single = [os.path.join(root, f"single_{s}.pt")
              for s in range(TP_TRAIN_STEPS)]
    ck = os.path.join(root, "cli_ckpt")
    argv = TP_TRAIN_ARGV.split() + ["--checkpoint-dir", ck, "--mesh", "2x2"]
    base = dict(device=str(dev), smoke=TP_SMOKE)
    olmo = dict(kind="steps", arch="olmo-1b", steps=TP_TRAIN_STEPS,
                single=single, gate=gates["start"], warm=("float32",))
    worlds = {
        2: _tp_start(torch, 2, dict(base, jobs=[
            dict(olmo, mesh=TP_TRAIN_MESHES[0]),
            dict(kind="steps", arch=TP_TRAIN_MOE[0], mesh=(1, 2),
                 steps=TP_TRAIN_MOE[3], single=None, gate=gates["ep"])]),
            target=_tp_train_rank),
        # the CLI's activations are the config's bf16
        4: _tp_start(torch, 4, dict(base, jobs=[
            dict(olmo, mesh=TP_TRAIN_MESHES[1],
                 warm=("float32", "bfloat16")),
            dict(kind="cli", argv=argv, port=_free_port()),
            dict(kind="cli", argv=argv, port=_free_port(),
                 gate=gates["resume"])]), target=_tp_train_rank)}
    return dict(worlds=worlds, gates=gates, single=single, ck=ck, tmp=tmp)


def _tp_train_stop(started):
    """Stop a spawn's worlds and remove its files."""
    for w in started["worlds"].values():
        if any(p.is_alive() for p in w[1]):
            _tp_stop(w)
    started["tmp"].cleanup()


def _tp_train_phase(torch, dev, report, started):
    """Training on a mesh (module doc, phase 21): olmo-1b at full width on
    1 x 2 and 2 x 2 meshes against one device step by step, arctic's
    expert-parallel training on 1 x 2, the training CLI on 2 x 2 with a
    bit-exact resume and a restore on one device, and the mesh-trained
    tree served through the kernels against the one-device-trained one,
    on the worlds `_tp_train_spawn` started, whose jobs run while this
    process runs the single-device references. (by_path, ok)."""
    import gc

    from repro_torch.launch import train as ttrain
    t_phase = time.perf_counter()
    rec = report["tp_train"] = {}
    card = report["card"]
    print(f"tp_train: backend {TP_BACKEND}, every rank on cuda:0 (the ranks "
          f"share one H100; steps are gloo- and host-bound: no speed "
          f"claim; the worlds were spawned before the train phase) "
          f"({card})")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    worlds, gates = started["worlds"], started["gates"]
    for w in (2, 4):
        worlds[w] = _tp_train_open(worlds[w], gates["start"])
    undo = _tp_train_patch_cli(ttrain)
    try:
        return _tp_train_run(torch, dev, rec, card, worlds, gates,
                             started["single"], started["ck"], t_phase)
    finally:
        undo()
        _tp_train_stop(started)


def _tp_train_save(torch, path):
    """``save(step, state)`` writing the params to ``path[step]`` (a flat
    ``{leaf path: CPU tensor}``; renamed into place once whole)."""
    from repro_torch.core.sparsity import map_with_path

    def save(s, st):
        flat = {}
        map_with_path(lambda p, t: flat.__setitem__(p, t.detach().cpu()),
                      st.params)
        torch.save(flat, path[s] + ".tmp")
        os.replace(path[s] + ".tmp", path[s])
    return save


def _peak(torch, dev):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _reset_peak(torch, dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _tp_train_run(torch, dev, rec, card, worlds, gates, single, ck,
                  t_phase):
    """`_tp_train_phase` past the spawns. (by_path, ok)."""
    import gc
    import shutil

    from repro_torch.launch import train as ttrain
    from repro_torch.train import checkpoint as ckpt
    ok = True
    # -- one device: olmo-1b (the meshes' reference), then the CLI ----------
    _reset_peak(torch, dev)
    st1, rows1 = _tp_train_steps(torch, dev, "olmo-1b", TP_TRAIN_STEPS,
                                 save=_tp_train_save(torch, single))
    peak1 = _peak(torch, dev)
    del st1
    gc.collect()
    print(f"tp_train: olmo-1b {TP_TRAIN_LAYERS} layers at full width, f32, "
          f"B{TP_TRAIN_BATCH} S{TP_TRAIN_SEQ}, AdamW, DBB 8 -> 4 over "
          f"{TP_TRAIN_STEPS} steps: one device "
          + "; ".join(f"step {r['step']} (k {r['nnz']}) loss {r['loss']:.6f} "
                      f"{r['ms']:.1f} ms" for r in rows1)
          + f"; peak device memory {peak1 / 1e9:.3f} GB ({card})")
    rec["single"] = dict(rows=rows1, peak_bytes=peak1)
    rep1, lines1 = {}, []
    ttrain.main(TP_TRAIN_ARGV.split() + ["--mesh", "none"],
                device=str(dev), log=lines1.append, report=rep1)
    for world, name in ((2, "1x2"), (4, "2x2")):
        ranks, wall = _tp_train_collect(worlds[world], 0)
        ok = _tp_train_mesh_check(name, ranks, wall, rows1, peak1, rec,
                                  card) and ok
    # -- the CLI on 2 x 2, then its resume ------------------------------------
    ranks, wall = _tp_train_collect(worlds[4], 1)
    r0 = ranks[0]
    straight = os.path.join(os.path.dirname(ck), "straight_final")
    steps_saved = ckpt.available_steps(ck)
    last = f"step_{TP_TRAIN_CLI_STEPS:09d}"
    shutil.move(os.path.join(ck, last), straight)
    worlds[4] = _tp_train_open(worlds[4], gates["resume"])
    first_ok = (r0["lines"][0] == "mesh 2x2 (data x model): torchrun world "
                f"of 4, backend {TP_BACKEND}" and r0["backend"] == TP_BACKEND)
    h_mesh, h_one = r0["history"], rep1["history"]
    rels = [max(abs(a[k] - b[k]) / abs(b[k]) for k in ("loss", "grad_norm"))
            for a, b in zip(h_mesh, h_one)]
    cli_loss_ok = ([h["step"] for h in h_mesh] == [h["step"] for h in h_one]
                   == list(range(TP_TRAIN_CLI_STEPS))
                   and max(rels) <= TP_TRAIN_LOSS_RTOL)
    cli_ok = (first_ok and cli_loss_ok
              and steps_saved == list(range(1, TP_TRAIN_CLI_STEPS + 1))
              and not any(r["launches"] for r in ranks))
    print(f"tp_train: cli: `python -m repro_torch.launch.train "
          f"{TP_TRAIN_ARGV} --checkpoint-dir <build/...> --mesh 2x2` on 4 "
          f"ranks (torchrun-style env://, in process, olmo-1b cut to "
          f"{TP_TRAIN_LAYERS} layers): first line {r0['lines'][0]!r}; "
          f"{r0['wall']:.1f} s; per step loss and grad norm vs --mesh none "
          + "; ".join(f"step {a['step']}: {a['loss']:.6f} vs {b['loss']:.6f}"
                      f", {a['grad_norm']:.6f} vs {b['grad_norm']:.6f} (rel "
                      f"{r:.2e}), dt {a['dt']} s vs {b['dt']} s"
                      for a, b, r in zip(h_mesh, h_one, rels))
          + f" (tol {TP_TRAIN_LOSS_RTOL:g}); checkpoints {steps_saved}; "
          f"rank peaks "
          f"{[round(r['peak'] / 1e9, 3) for r in ranks]} GB; kernel "
          f"launches while training {[r['launches'] for r in ranks]} "
          f"{'ok' if cli_ok else 'FAIL'}")
    ok = ok and cli_ok
    ranks, wall = _tp_train_collect(worlds[4], 2)
    resumed = os.path.join(ck, last)
    names = sorted(n for n in os.listdir(straight) if n.startswith("leaf_"))
    same = [n for n in names if open(os.path.join(straight, n), "rb").read()
            == open(os.path.join(resumed, n), "rb").read()]
    resume_ok = (ranks[0]["lines"][1]
                 == f"resumed from step {TP_TRAIN_CLI_STEPS - 1}"
                 and len(same) == len(names))
    ok = ok and resume_ok
    print(f"tp_train: cli resume: {ranks[0]['lines'][1]!r}; its step-"
          f"{TP_TRAIN_CLI_STEPS} checkpoint vs the straight run's: {len(same)} "
          f"of {len(names)} leaves bit-equal {'ok' if resume_ok else 'FAIL'}"
          f" ({ranks[0]['wall']:.1f} s)")
    # -- arctic: one device, then EP on 1 x 2 ---------------------------------
    arch, experts, layers, steps = TP_TRAIN_MOE
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    _reset_peak(torch, dev)
    st, rows_ep1 = _tp_train_steps(torch, dev, arch, steps)
    peak_ep1 = _peak(torch, dev)
    del st
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    worlds[2] = _tp_train_open(worlds[2], gates["ep"])
    ranks, wall = _tp_train_collect(worlds[2], 1)
    ok = _tp_train_ep_check(ranks, wall, rows_ep1, peak_ep1, rec, card) and ok
    # -- serve the mesh-trained tree on one device ---------------------------
    counts, serve_ok = _tp_train_serve(torch, dev, rec, ck, rep1["state"])
    ok = ok and serve_ok
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"tp_train: phase {rec['phase_s']:.1f} s ({card})")
    return {"tp_train_serve_f32": counts}, ok


def _tp_train_mesh_check(name, ranks, wall, rows1, peak1, rec, card):
    """A mesh's olmo-1b run against one device: per step the loss, the
    params' max |diff| and the ms; the ranks' peaks; the split leaves'
    bytes per rank. ok."""
    r0 = ranks[0]
    d, m = (int(x) for x in name.split("x"))
    ok = True
    for a, b in zip(r0["rows"], rows1):
        rel = {k: abs(a[k] - b[k]) / abs(b[k]) for k in ("loss", "grad_norm")}
        step_ok = (max(rel.values()) <= TP_TRAIN_LOSS_RTOL
                   and a["param_err"] <= TP_TRAIN_PARAM_TOL
                   and a["update_err"] <= TP_TRAIN_UPDATE_RTOL
                   and all(r["rows"][a["step"]]["loss"] == a["loss"]
                           for r in ranks) and a["launches"] == 0)
        ok = ok and step_ok
        print(f"tp_train: {name}: step {a['step']} (k {a['nnz']}): loss "
              f"{a['loss']:.6f} vs one device {b['loss']:.6f} (rel "
              f"{rel['loss']:.2e}), grad norm {a['grad_norm']:.6f} vs "
              f"{b['grad_norm']:.6f} (rel {rel['grad_norm']:.2e}; tol "
              f"{TP_TRAIN_LOSS_RTOL:g}); the update's relative error "
              f"{a['update_err']:.3e} (tol {TP_TRAIN_UPDATE_RTOL:g}; a mesh "
              f"left at its initial state reads 1); params max |diff| "
              f"{a['param_err']:.3e} (tol {TP_TRAIN_PARAM_TOL:g}; unchanged "
              f"reads {a['param_move']:.3e}); step {a['ms']:.1f} ms (one "
              f"device {b['ms']:.1f} ms); kernel launches {a['launches']} "
              f"{'ok' if step_ok else 'FAIL'}")
    whole, mine = r0["split_bytes"]
    peaks = [r["peak"] for r in ranks]
    want_split = {"vocab", "head", "attn", "mlp"}
    lay_ok = set(r0["split"]) == want_split and r0["zero"] == (d > 1)
    ok = ok and lay_ok
    print(f"tp_train: {name}: split {r0['split']}, ZeRO "
          f"{'on' if r0['zero'] else 'off'}, sequence-parallel residual; "
          f"the split leaves and their Adam moments {whole / 1e9:.3f} GB "
          f"whole, {mine / 1e9:.3f} GB on a rank (ratio "
          f"{whole / max(mine, 1):.2f}, tp x data = {d * m}); peak device "
          f"memory per rank {[round(p / 1e9, 3) for p in peaks]} GB vs one "
          f"device {peak1 / 1e9:.3f} GB (ratio "
          f"{peak1 / max(max(peaks), 1):.2f}); {wall:.1f} s "
          f"{'ok' if lay_ok else 'FAIL'} ({card})")
    rec[name] = dict(rows=r0["rows"], peaks=peaks, wall_s=wall,
                     split_bytes=[whole, mine], split=r0["split"],
                     zero=r0["zero"])
    return ok


def _tp_train_ep_check(ranks, wall, rows1, peak1, rec, card):
    """arctic's EP training on 1 x 2 against one device: loss and aux per
    step. ok."""
    arch, experts, layers, steps = TP_TRAIN_MOE
    r0 = ranks[0]
    ok = "experts" in r0["split"]
    for a, b in zip(r0["rows"], rows1):
        rel = {k: abs(a[k] - b[k]) / abs(b[k])
               for k in ("loss", "aux", "grad_norm")}
        step_ok = (max(rel.values()) <= TP_TRAIN_LOSS_RTOL
                   and a["launches"] == 0)
        ok = ok and step_ok
        print(f"tp_train: {arch} EP 1x2 ({experts} experts, {layers} layer, "
              f"f32, SGD): step {a['step']}: loss {a['loss']:.6f} vs one device "
              f"{b['loss']:.6f}, aux {a['aux']:.6f} vs {b['aux']:.6f}, grad "
              f"norm {a['grad_norm']:.6f} vs {b['grad_norm']:.6f} (rel "
              + ", ".join(f"{v:.2e}" for v in rel.values())
              + f"; tol {TP_TRAIN_LOSS_RTOL:g}); step {a['ms']:.1f} ms (one "
              f"device {b['ms']:.1f} ms) {'ok' if step_ok else 'FAIL'}")
    peaks = [r["peak"] for r in ranks]
    print(f"tp_train: {arch} EP: split {r0['split']}; peak device memory "
          f"per rank {[round(p / 1e9, 3) for p in peaks]} GB vs one device "
          f"{peak1 / 1e9:.3f} GB; {wall:.1f} s ({card})")
    rec["ep"] = dict(rows=r0["rows"], single=rows1, peaks=peaks,
                     single_peak=peak1, wall_s=wall)
    return ok


def _tp_train_serve(torch, dev, rec, ck, one_state):
    """The 2 x 2 CLI run's last checkpoint restored on one device, and the
    one-device run's state: each projected at k 4, packed as f32 planes
    and greedy-served through the kernel route; the mesh-trained tree's
    streams against the other's by the split rule. (counts, ok)."""
    import gc

    from repro_torch.core.dbb_linear import pack_tree
    from repro_torch.core.sparsity import apply_dbb_to_tree
    from repro_torch.kernels.common import reset_launches
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.loop import init_train_state
    from repro_torch.train.tree import tree_leaves
    from repro_torch.launch import train as ttrain
    cfg = _tp_train_config("olmo-1b", TP_TRAIN_LAYERS)
    # the CLI's initial tree (its own run config): the restore's template
    template = init_train_state(ttrain._run_cfg(
        ttrain.build_parser().parse_args(TP_TRAIN_ARGV.split())), device=dev)
    mesh_state, meta = ckpt.restore(ck, template)
    trio = list(zip(tree_leaves(mesh_state.params),
                    tree_leaves(one_state.params),
                    tree_leaves(template.params)))
    err = max((a - b).abs().max().item() for a, b, _ in trio)
    move = max((b - c).abs().max().item() for _, b, c in trio)
    rel = (sum(((a - b).double() ** 2).sum().item() for a, b, _ in trio)
           / sum(((b - c).double() ** 2).sum().item() for _, b, c in trio)
           ) ** 0.5
    del template, trio
    print(f"tp_train: the 2x2 CLI run's step-{meta['step']} checkpoint "
          f"restored on one device; its params vs the --mesh none run's "
          f"(bf16 activations): the update's relative error {rel:.3e} (tol "
          f"{TP_TRAIN_CLI_UPDATE_RTOL:g}; unchanged reads 1), max |diff| "
          f"{err:.3e} (tol {TP_TRAIN_PARAM_TOL:g}; unchanged reads "
          f"{move:.3e})")
    kcfg = cfg.replace(remat="none", gemm_impl="pallas")
    engines = {}
    for name, st in (("mesh", mesh_state), ("one", one_state)):
        tree = pack_tree(apply_dbb_to_tree(st.params, cfg.dbb,
                                           straight_through=False), cfg.dbb)
        engines[name] = ServeEngine(kcfg, tree, max_batch=8, device=dev)
    del mesh_state
    gc.collect()
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (48, 41, 34, 27, 20, 13, 9, 5)]
    outs, counts = {}, None
    for name in ("mesh", "one"):
        reset_launches()
        outs[name] = engines[name].generate(prompts,
                                            max_new_tokens=TP_TRAIN_NEW)
        _sync(torch, dev)
        from repro_torch.kernels.common import LAUNCHES
        if name == "mesh":
            counts = dict(LAUNCHES)
    last = {n: _logits_fn(torch, dev, e) for n, e in engines.items()}
    lg = {n: last[n](kcfg, prompts) for n in engines}
    scale = lg["one"].abs().max().item()
    tol = TP_TRAIN_LOGIT_TOL * scale
    diff = (lg["mesh"] - lg["one"]).abs().max().item()
    same, total, split = _split_rows(outs["mesh"], outs["one"])
    gaps = _split_gaps(torch, last["one"], kcfg, prompts, outs["mesh"],
                       outs["one"], split)
    kern = {k: v for k, v in counts.items() if v and not k.endswith(
        ("_tc", "_split", "_narrow", "_small"))}
    ok = (err <= TP_TRAIN_PARAM_TOL and rel <= TP_TRAIN_CLI_UPDATE_RTOL
          and diff <= tol
          and all(g <= 2 * tol for g in gaps)
          and kern.get("dbb_gemm_skinny", 0) > 0
          and kern.get("flash_prefill", 0) > 0)
    print(f"tp_train: serve: both trees projected (k {cfg.dbb.nnz}), packed "
          f"f32 and greedy-generated on the kernel route, 8 prompts x "
          f"{TP_TRAIN_NEW}: prefill logits max |diff| {diff:.3e} of max "
          f"{scale:.3e} (tol {TP_TRAIN_LOGIT_TOL:g} of max); tokens "
          f"{same}/{total} equal, splits (row, step, gap; bound "
          f"{2 * tol:.3e}) {[(i, j, g) for (i, j), g in zip(split, gaps)]};"
          f" the mesh-trained tree's launches {kern} "
          f"{'ok' if ok else 'FAIL'}")
    rec["serve"] = dict(param_err=err, update_err=rel, logit_diff=diff,
                        logit_scale=scale,
                        agreement=[same, total],
                        splits=[[i, j, g] for (i, j), g in zip(split, gaps)])
    return counts, ok


# ---------------------------------------------------------------------------
# phase 22: per-step costs — the roofline counter on meta against the card
# ---------------------------------------------------------------------------

# the dry-run cells run as subprocesses (python -m repro_torch.launch.dryrun)
DRYRUN_CELLS = (("olmo-1b", "decode_32k", ("--packed",)),
                ("qwen2.5-14b", "train_4k", ()))
DRYRUN_CELL_TIMEOUT_S = 600
# the dispatcher route -> the kernel launch counter it must move
ROUTE_KERNEL = {"skinny_dbb": "dbb_gemm_skinny", "dbb_packed": "dbb_gemm",
                "skinny_sta": "sta_gemm_skinny", "sta": "sta_gemm",
                "attn_flash": "flash_prefill",
                "attn_packed_flash": "flash_prefill_packed",
                "attn_decode_flash": "paged_decode",
                "head_sample_fused": "head_sample_fused"}
DRYRUN_SMAX = 1024               # slots a row of the paged pool holds
DRYRUN_PREFILL_LENS = (512, 384, 256, 200, 128, 64, 33, 16)
DRYRUN_STEP_REPS = 10
# the caching allocator rounds every block up to 512 bytes: the card's peak
# may exceed the counter's by that much for each allocation the step makes
ALLOC_ROUND = 512


def _dryrun_spawn(out_dir: str):
    """Start the DRYRUN_CELLS as subprocesses on the host (no card:
    CUDA_VISIBLE_DEVICES is empty), so they run beside the card's phases;
    the dryrun phase reads their records (in ``out_dir``/dryrun, or a
    temporary directory removed at exit). Killed at exit if still
    running."""
    import atexit
    import tempfile
    cells_dir = (os.path.join(out_dir, "dryrun") if out_dir
                 else tempfile.mkdtemp(prefix="dryrun_"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    started = []
    for arch, shape, extra in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", "pod", "--out", cells_dir,
               *extra]
        started.append((cmd, time.perf_counter(), subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))

    def stop():
        for _, _, p in started:
            if p.poll() is None:
                p.kill()
                p.wait()
        if not out_dir:
            shutil.rmtree(cells_dir, ignore_errors=True)
    atexit.register(stop)
    return cells_dir, started


def _paged_step_inputs(torch, cfg, eng, dev):
    """(decode args, packed-prefill args) of olmo-1b on the serve phase's
    paged pool (64-slot pages, DRYRUN_SMAX slots a row): B8 decode tokens
    at lengths 300-1000, and DRYRUN_PREFILL_LENS prompts packed into one
    call whose scatter addresses (rows, cols) stay on the host, as the
    engine passes them. On ``dev`` "meta" every tensor is a shape."""
    from repro_torch.serve.kv_cache import init_paged_cache
    page = cfg.kv_page_size
    n_log = DRYRUN_SMAX // page
    pool = 8 * n_log + 1
    cache = init_paged_cache(eng._lcfg, 8, pool, page, n_log, device=dev)
    table = (1 + torch.arange(8 * n_log, dtype=torch.int32)).reshape(8, n_log)
    gen = torch.Generator().manual_seed(5)
    lengths = torch.randint(300, DRYRUN_SMAX - 1, (8,), generator=gen,
                            dtype=torch.int32)
    if dev.type != "meta":
        cache["block_table"].copy_(table)
        cache["length"].copy_(lengths)
    tok = torch.randint(2, cfg.vocab_size, (8,), generator=gen,
                        dtype=torch.int32).to(dev)
    total = sum(DRYRUN_PREFILL_LENS)
    tp = 8
    while tp < total:
        tp *= 2
    toks = torch.zeros((1, tp), dtype=torch.int32)
    seg = torch.full((tp,), len(DRYRUN_PREFILL_LENS), dtype=torch.int32)
    pos = torch.zeros((1, tp), dtype=torch.int32)
    rows = torch.full((tp,), pool, dtype=torch.int32)
    cols = torch.zeros((tp,), dtype=torch.int32)
    gidx = torch.zeros((len(DRYRUN_PREFILL_LENS),), dtype=torch.int64)
    off = 0
    for i, n in enumerate(DRYRUN_PREFILL_LENS):
        p = torch.arange(n)
        toks[0, off:off + n] = torch.randint(2, cfg.vocab_size, (n,),
                                             generator=gen)
        seg[off:off + n] = i
        pos[0, off:off + n] = p
        rows[off:off + n] = table[i][p // page]
        cols[off:off + n] = p % page
        gidx[i] = off + n - 1
        off += n
    decode = (eng.params, eng.head, cache, tok)
    prefill = (eng.params, eng.head, cache, toks.to(dev), seg.to(dev),
               pos.to(dev), rows, cols, gidx.to(dev))
    return decode, prefill


def _step_ms(torch, step, args) -> float:
    """Median over DRYRUN_STEP_REPS of one whole step (host enqueue
    included) between CUDA events, after two warm-up steps."""
    for _ in range(2):
        step(*args)
    times = []
    for _ in range(DRYRUN_STEP_REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _step_peak(torch, step, args):
    """(the caching allocator's peak above the step's inputs, allocations
    the step made) of one uncounted step."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    n0 = torch.cuda.memory_stats()["allocation.all.allocated"]
    out = step(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - n0
    del out
    return peak, allocs


def _dryrun_phase(torch, dev, report, packed, spawned):
    """(launch counts, ok): (i) olmo-1b at full width and depth, packed f32
    planes, on the kernel routes: one B8 decode step on the serve phase's
    paged pool and one packed prefill, each counted by
    `roofline.counts.count_step` on the card and on the meta device from
    the same config and shapes (the card tree's meta twin); flops, bytes by
    route and collectives must be equal, each route's calls must equal its
    kernel's launches, each step's measured time is printed beside its
    roofline bound, and the allocator's peak beside the counter's; (ii)
    the dry-run cells' records (started at the run's beginning) must be
    "ok", their roofline dicts printed."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.launch import specs
    from repro_torch.launch.dryrun import step_terms
    from repro_torch.roofline.analysis import model_flops_per_step
    from repro_torch.roofline.counts import count_step
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("olmo-1b").replace(remat="none", gemm_impl="pallas",
                                        kv_page_size=64)
    meta = torch.device("meta")
    card = ServeEngine(cfg, packed, max_batch=8, device=dev, paged=True)
    twin = ServeEngine(cfg, specs.sds_tree(packed), max_batch=8,
                       device=meta, paged=True)
    steps = {"decode": ("_decode", 0), "prefill": ("_packed_prefill", 1)}
    card_in = _paged_step_inputs(torch, cfg, card, dev)
    meta_in = _paged_step_inputs(torch, cfg, twin, meta)
    n_tok = {"decode": 8, "prefill": sum(DRYRUN_PREFILL_LENS)}
    for name, (attr, i) in steps.items():       # warm-up: builds, cuBLAS
        getattr(card, attr)(*card_in[i])
    torch.cuda.synchronize()
    ok = True
    stats = {}
    reset_launches()
    for name, (attr, i) in steps.items():
        _, stats[name] = count_step(getattr(card, attr), *card_in[i],
                                    peak_device="cuda")
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    report["dryrun"] = {}
    calls = collections.Counter()
    for name, (attr, i) in steps.items():
        out, mst = count_step(getattr(twin, attr), *meta_in[i],
                              peak_device="meta")
        cst = stats[name]
        for k, v in cst.routes.items():
            calls[k] += v[0]
        same = (cst.flops == mst.flops and cst.routes == mst.routes
                and cst.collective_bytes == mst.collective_bytes)
        aten_same = cst.ops == mst.ops
        ms = _step_ms(torch, getattr(card, attr), card_in[i])
        peak, allocs = _step_peak(torch, getattr(card, attr), card_in[i])
        mem_ok = abs(peak - mst.peak_bytes) <= ALLOC_ROUND * allocs
        mf = model_flops_per_step(cfg.active_param_count(), n_tok[name],
                                  False)
        seq = DRYRUN_SMAX if name == "decode" else n_tok[name]
        mem, terms = step_terms(mst, meta_in[i], out, kind=name,
                                seq_len=seq, model_flops=mf)
        lb_ms = terms.step_time_lb * 1e3
        ok = ok and same and mem_ok
        print(f"dryrun: olmo-1b {name} ({n_tok[name]} tokens): card "
              f"{'==' if same else '!='} meta StepStats: flops "
              f"{cst.flops:.6g} / {mst.flops:.6g}, hbm bytes "
              f"{cst.hbm_bytes:.6g} / {mst.hbm_bytes:.6g} (aten ops "
              f"{'equal' if aten_same else 'differ'}), routes "
              f"{ {k: v[0] for k, v in mst.routes.items()} }; measured "
              f"{ms:.3f} ms a step (median of {DRYRUN_STEP_REPS}, CUDA "
              f"events) against step_time_lb {lb_ms:.4f} ms "
              f"({terms.bottleneck}; the bound is "
              f"{terms.step_time_lb * 1e3 / ms:.2%} of the step), "
              f"roofline_fraction {terms.roofline_fraction:.4f}; allocator "
              f"peak {peak} B over {allocs} allocations vs counter peak "
              f"{mst.peak_bytes:.0f} B (card {cst.peak_bytes:.0f} B; within "
              f"{ALLOC_ROUND} B an allocation: {'yes' if mem_ok else 'NO'})"
              + ("" if same else "; FAIL: the counts differ"))
        report["dryrun"][name] = dict(
            step_ms=ms, memory=mem, roofline=terms.as_dict(),
            allocator_peak=peak, allocations=allocs,
            counter_peak=mst.peak_bytes, card_equal_meta=same,
            aten_equal=aten_same,
            routes=mst.routes)
    for route, n in calls.items():
        kernel = ROUTE_KERNEL.get(route)
        if kernel is None or counts[kernel] != n:
            ok = False
            print(f"dryrun: FAIL: route {route} counted {n} calls, kernel "
                  f"{kernel} launched {counts.get(kernel)} times")
    print(f"dryrun: launches of the counted card steps {counts}")
    cells_dir, started = spawned
    for cmd, t0, p in started:
        try:
            _, err = p.communicate(timeout=max(
                1.0, DRYRUN_CELL_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        cell = f"{cmd[4]}__{cmd[6]}__pod" + ("__dbb" if "--packed" in cmd
                                             else "")
        path = os.path.join(cells_dir, cell + ".json")
        rec = {}
        if os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
        good = p.returncode == 0 and rec.get("status") == "ok"
        ok = ok and good
        print(f"dryrun: {' '.join(cmd[1:])}: rc {p.returncode}, status "
              f"{rec.get('status')}, {time.perf_counter() - t0:.1f} s since "
              f"its start; roofline {json.dumps(rec.get('roofline'))}; "
              f"memory {json.dumps(rec.get('memory'))}"
              + ("" if good else f"; FAIL: {err[-2000:]}"))
        report["dryrun"][cell] = rec
    return counts, ok


if __name__ == "__main__":
    sys.exit(main())
