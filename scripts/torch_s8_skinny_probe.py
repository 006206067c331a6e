#!/usr/bin/env python3
"""Per-call times of the int8 (INT8 x INT8 -> INT32) branches of
dbb_gemm_skinny and sta_gemm_skinny on one CUDA card, at the int8 decode
path's shapes, for the kernels of a given source tree:

    python scripts/torch_s8_skinny_probe.py TREE [LABEL]

TREE is a checkout of this repository (its kernels build into
TREE/build/kernels). To compare two trees on one card, run the script on
each in turns in one command (parent, change, change, parent), the other
tree unpacked with ``git archive`` into ``build/``.

Shapes: olmo-1b's layer GEMMs (K, N) = (2048, 2048), (2048, 8192) and
(8192, 2048) at M 8 and 24, int8 x from a seeded normal quantized per
tensor, the weight quantize_weight's int8 (dense) or its INT8 DBB values
plane at k = 4; the f32 epilogue (x_s·w_s, bias, silu at N 8192), as
chip_smoke.py times the int8 kernel phase. Each time is the median of 20
single calls between CUDA events, the L2 flushed and the stream held in a
spin kernel before each. Beside each: bf16 ``torch.matmul`` at the shape
and ``torch._int_mm`` where it takes the operands. Prints one line a shape
and the card's name and power limit.
"""
import statistics
import subprocess
import sys

REPS = 20
SHAPES = ((2048, 2048), (2048, 8192), (8192, 2048))


def main(tree: str, label: str) -> None:
    sys.path.insert(0, tree + "/src")
    import torch
    from repro_torch.core.dbb import pack_dbb
    from repro_torch.core.quant import act_scale, quantize_weight
    from repro_torch.kernels.skinny import dbb_gemm_skinny, sta_gemm_skinny

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

    def int_mm(x, w):
        try:
            torch._int_mm(x, w)
            torch.cuda.synchronize()
        except RuntimeError:
            return "refuses"
        return f"{time_ms(lambda: torch._int_mm(x, w)):.4f} ms"

    for m in (8, 24):
        for k, n in SHAPES:
            xf = torch.randn(m, k, generator=gen, device=dev)
            xs = act_scale(xf)
            x = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
            qw = quantize_weight(torch.randn(k, n, generator=gen,
                                             device=dev))
            bias = torch.randn(n, generator=gen, device=dev)
            ep = dict(bias=bias, scale=xs * qw.scale,
                      act="silu" if n == 8192 else "none")
            p = pack_dbb(qw.q, 8, 4)
            xb, wb = x.bfloat16(), qw.q.bfloat16()
            mm = time_ms(lambda: torch.matmul(xb, wb))
            lib = int_mm(x, qw.q)
            for name, run in (
                    ("dbb_gemm_skinny_s8", lambda: dbb_gemm_skinny(
                        x, p.values, p.bitmask, **ep)),
                    ("sta_gemm_skinny_s8", lambda: sta_gemm_skinny(
                        x, qw.q, **ep))):
                print(f"{label}: {name} M{m} K{k} N{n}: "
                      f"{time_ms(run):.4f} ms; bf16 torch.matmul "
                      f"{mm:.4f} ms; torch._int_mm {lib}")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else sys.argv[1])
