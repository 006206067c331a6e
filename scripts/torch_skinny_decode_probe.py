#!/usr/bin/env python3
"""Per-call times of sta_gemm_skinny's float branch, of head_sample_fused
and of paged_decode on one CUDA card, at the serving path's shapes, for the
kernels of a given source tree:

    python scripts/torch_skinny_decode_probe.py TREE [LABEL]

TREE is a checkout of this repository (its kernels build into
TREE/build/kernels). To compare two trees on one card, run the script on
each in turns in one session (parent, change, change, parent), from a
checkout unpacked with ``git archive`` into ``build/``.

Shapes: the tied head x[M, 2048] . w[2048, 50304] f32 at M 1, 8, 24 and
32, greedy (sta_gemm_skinny) and sampled (head_sample_fused: counts in
{0, 1}, temperature 0.8, repetition penalty 1.1, per-row seeds and
steps); the dense decode layers at M8 bf16 (K2048 N2048, K2048 N8192, K8192
N2048); decode attention at B8 Hkv16 G1 D128 page 64 bf16 through the
contiguous cache's identity table at S 128 (lengths 100, ragged starts)
and through a shuffled pool at S 640 (lengths 256-639) and S 576 with
every row 575 long (serve's longest contexts). Each time is the median of
20 single calls between CUDA events, the L2 flushed and the stream held in
a spin kernel before each (as chip_smoke.py times its kernel phase).
Prints one line a shape and the card's name and power limit.
"""
import statistics
import subprocess
import sys

REPS = 20


def main(tree: str, label: str) -> None:
    sys.path.insert(0, tree + "/src")
    import torch
    from repro_torch.kernels.attn import paged_decode_attention
    from repro_torch.kernels.sample import head_sample_fused
    from repro_torch.kernels.skinny import sta_gemm_skinny

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(f"{label}: {smi[0] if smi else torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)

    def time_ms(fn):
        for _ in range(3):
            fn()
        times = []
        for _ in range(REPS):
            flush.zero_()
            torch.cuda._sleep(10_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    w = randn(2048, 50304) * 0.02
    for m in (1, 8, 24, 32):
        x = randn(m, 2048)
        print(f"{label}: sta_gemm_skinny head M{m} K2048 N50304 f32: "
              f"{time_ms(lambda: sta_gemm_skinny(x, w)):.4f} ms")
    for m in (1, 8, 24, 32):
        x = randn(m, 2048)
        counts = torch.randint(0, 2, (m, 50304), generator=gen, device=dev,
                               dtype=torch.int32)
        ar = torch.arange(m, device=dev)
        rows = (torch.full((m,), 0.8, device=dev),
                torch.full((m,), 1.1, device=dev), torch.zeros(m, device=dev),
                torch.zeros(m, device=dev), (ar * 7919 - 3).int(),
                (ar * 3).int())
        ms = time_ms(lambda: head_sample_fused(x, w, counts, *rows))
        print(f"{label}: head_sample_fused M{m} K2048 N50304 f32: "
              f"{ms:.4f} ms")
    del w
    for k, n in ((2048, 2048), (2048, 8192), (8192, 2048)):
        x, w = randn(8, k, dtype=torch.bfloat16), randn(
            k, n, dtype=torch.bfloat16)
        print(f"{label}: sta_gemm_skinny dense M8 K{k} N{n} bf16: "
              f"{time_ms(lambda: sta_gemm_skinny(x, w)):.4f} ms")

    b, hkv, d, page = 8, 16, 128, 64
    i32 = dict(dtype=torch.int32, device=dev)
    for case, s in (("S128 identity", 128), ("S640 pool", 640),
                    ("S576 pool, all 575", 576)):
        n_log = s // page
        q = randn(b, hkv, 1, d, dtype=torch.bfloat16)
        kp = randn(b * n_log, page, hkv, d, dtype=torch.bfloat16)
        vp = randn(b * n_log, page, hkv, d, dtype=torch.bfloat16)
        if case.startswith("S128"):
            table = (torch.arange(b, **i32)[:, None] * n_log
                     + torch.arange(n_log, **i32)[None, :])
            lengths = torch.full((b,), 100, **i32)
            start = torch.tensor([0, 7, 14, 21, 28, 35, 42, 49], **i32)
        else:
            perm = torch.randperm(b * n_log, generator=gen, device=dev)
            table = perm.view(b, n_log).int().contiguous()
            lengths = (torch.full((b,), s - 1, **i32) if "all" in case
                       else torch.randint(256, s, (b,), generator=gen,
                                          device=dev, dtype=torch.int32))
            start = torch.zeros((b,), **i32)
        ms = time_ms(lambda: paged_decode_attention(q, kp, vp, table,
                                                    lengths, start))
        print(f"{label}: paged_decode B{b} Hkv{hkv} G1 D{d} page{page} "
              f"{case} bf16: {ms:.4f} ms")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else sys.argv[1])
