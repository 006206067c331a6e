#!/usr/bin/env python3
"""Per-call times of conv_gemm_dbb's and conv_gemm's f32 and int8 branches
on one CUDA card, at convnet's and lenet's convolutions, for the kernels of
a given source tree:

    python scripts/torch_conv_probe.py TREE [LABEL]

TREE is a checkout of this repository (its kernels build into
TREE/build/kernels). To compare two trees on one card, run the script on
each in turns in one command (parent, change, change, parent), the other
tree unpacked with ``git archive`` into ``build/``.

Shapes: B256 16x16x64 -> 128 (conv1) and 8x8x128 -> 256 (conv2), 3x3
SAME, DBB B8 k2 (pack_dbb of a seeded normal weight). f32: a standard
normal image, bias and relu. int8: the image quantized per tensor, the
weight quantize_weight's INT8 plane, the f32 epilogue (x_s·w_s, bias,
relu), as chip_smoke.py times its int8 kernel phase. Beside each: cuDNN's
F.conv2d on the decompressed weight (f32 with TF32 off; for the int8 lines
bf16, which has tensor cores and no int8 path). Each time is the median
of 20 single calls between CUDA events, the L2 flushed and the stream held
in a spin kernel before each.

Where TREE's library has the tensor-core body's phase launcher
(``conv_gemm_dbb_tc_phase_launch``), each shape also prints the body's
phase split: producers only (TMA and the DBB expansion, the consumers
waiting and releasing), MMA only (fragment loads and wgmma on whatever
shared memory holds), both, and neither (launch, set-up and the
epilogue's stores), f32 output; two diagnoses (garbage outputs): neither
without the stores, and both with no barrier between producers and
consumers (each runs as fast as it can beside the other); and the full
body at each ring depth from 2 to 6 stages (past what fits: as deep as
fits).

conv_gemm (the dense weight): convnet's conv0 (B256 32x32x3 -> 64, 3x3
SAME) and lenet's conv1 (B256 14x14x6 -> 16, 5x5 SAME), the shapes of its
small-C body, and convnet's conv1 and conv2 under matmul="sta" (dense
weights), the shapes of its tensor-core body; f32 with bias and relu, int8
with the f32 epilogue as above, beside cuDNN (f32, TF32 off; bf16 for the
int8 lines). At the dense f32 shapes also conv_gemm_dbb on the same weight
as a DBB plane of nnz 8 with an all-ones bitmask (the same product on the
DBB producer). Where TREE's library has the small-C body's phase launcher
(``conv_gemm_small_phase_launch``), the small shapes also print its phase
split (the staging alone, + the math, + the epilogue and the copy out,
both). Prints one line a measurement and the card's name and power limit.
"""
import ctypes
import statistics
import subprocess
import sys

REPS = 20
LAYERS = (("conv1", 16, 64, 128), ("conv2", 8, 128, 256))


def main(tree: str, label: str) -> None:
    sys.path.insert(0, tree + "/src")
    import torch
    import torch.nn.functional as F
    from repro_torch.core.dbb import decompress_bitmask, pack_dbb
    from repro_torch.core.quant import act_scale, quantize_weight
    from repro_torch.kernels import build
    from repro_torch.kernels.conv_gemm import conv_gemm_dbb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(f"{label}: {smi[0] if smi else torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    from repro_torch.kernels.conv_gemm import conv_gemm
    lib = build.load("conv_gemm_dbb")
    phase_fn = getattr(lib, "conv_gemm_dbb_tc_phase_launch", None)
    small_fn = getattr(build.load("conv_gemm"),
                       "conv_gemm_small_phase_launch", None)
    if small_fn is not None:
        small_fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 15
                             + [ctypes.c_void_p])
        small_fn.restype = ctypes.c_int
    if phase_fn is not None:
        phase_fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 17
                             + [ctypes.c_void_p])
        phase_fn.restype = ctypes.c_int

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

    def cudnn(x, wd, bias, c, n, dtype, k=3):
        wt = wd.reshape(k, k, c, n).permute(3, 2, 0, 1).to(dtype).contiguous(
            memory_format=torch.channels_last)
        xc = x.to(dtype).permute(0, 3, 1, 2)
        b = bias.to(dtype)
        return lambda: F.conv2d(xc, wt, b, padding=(k - 1) // 2)

    def phases(x, p, scale, bias, hw, c, n, dtype):
        out = torch.empty((256, hw, hw, n), device=dev)
        code = build.dtype_code(dtype)

        def run(phase, stages=0):
            def go():
                rc = phase_fn(x.data_ptr(), p.values.data_ptr(),
                              p.bitmask.data_ptr(), build.ptr(scale),
                              build.ptr(bias), out.data_ptr(), 256, hw, hw,
                              c, hw, hw, 3, 3, 1, 1, 1, n, 2, 1, code, phase,
                              stages, build.stream_handle(dev))
                if rc:
                    raise RuntimeError(f"phase launch: cudaError {rc}")
            return go
        split = {name: time_ms(run(ph)) for name, ph in
                 (("producers", 1), ("mma", 2), ("both", 3),
                  ("neither", 0), ("neither without stores", 8),
                  ("both unsynchronised", 19))}
        depth = {st: time_ms(run(3, st)) for st in range(2, 7)}
        return split, depth

    for name, hw, c, n in LAYERS:
        k_dim = 9 * c
        # f32
        x = torch.randn(256, hw, hw, c, generator=gen, device=dev)
        w = torch.randn(k_dim, n, generator=gen, device=dev) / k_dim ** 0.5
        bias = torch.randn(n, generator=gen, device=dev)
        p = pack_dbb(w, 8, 2)
        wd = decompress_bitmask(p.values, p.bitmask, block=8)
        ms = time_ms(lambda: conv_gemm_dbb(x, p.values, p.bitmask, bias,
                                           kh=3, kw=3, act="relu", nnz=2))
        lib_ms = time_ms(cudnn(x, wd, bias, c, n, torch.float32))
        print(f"{label}: conv_gemm_dbb f32 {name} B256 {hw}x{hw}x{c} -> {n}: "
              f"{ms:.4f} ms; cuDNN f32 (TF32 off) {lib_ms:.4f} ms")
        if phase_fn is not None:
            split, depth = phases(x, p, None, bias, hw, c, n, torch.float32)
            print(f"{label}: conv_gemm_dbb f32 {name} phases: "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
                  + "; stages " + ", ".join(
                      f"{k}: {v:.4f} ms" for k, v in depth.items()))
        # int8
        xf = torch.randn(256, hw, hw, c, generator=gen, device=dev)
        xs = act_scale(xf)
        xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
        qw = quantize_weight(torch.randn(k_dim, n, generator=gen,
                                         device=dev))
        pq = pack_dbb(qw.q, 8, 2)
        scale = xs * qw.scale
        ms = time_ms(lambda: conv_gemm_dbb(xq, pq.values, pq.bitmask, bias,
                                           scale, kh=3, kw=3, act="relu",
                                           nnz=2))
        raw = time_ms(lambda: conv_gemm_dbb(xq, pq.values, pq.bitmask,
                                            kh=3, kw=3, nnz=2))
        wq = decompress_bitmask(pq.values, pq.bitmask, block=8).float()
        lib_ms = time_ms(cudnn(xq.float(), wq, bias, c, n, torch.bfloat16))
        print(f"{label}: conv_gemm_dbb_s8 {name} B256 {hw}x{hw}x{c} -> {n}: "
              f"{ms:.4f} ms (f32 epilogue); int32 output {raw:.4f} ms; "
              f"cuDNN bf16 {lib_ms:.4f} ms")
        if phase_fn is not None:
            split, depth = phases(xq, pq, scale, bias, hw, c, n, torch.int8)
            print(f"{label}: conv_gemm_dbb_s8 {name} phases: "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
                  + "; stages " + ", ".join(
                      f"{k}: {v:.4f} ms" for k, v in depth.items()))

    # conv_gemm: the small-C shapes, then the dense tensor-core shapes
    for name, hw, c, n, k in (("convnet conv0", 32, 3, 64, 3),
                              ("lenet conv1", 14, 6, 16, 5),
                              ("convnet conv1 (sta)", 16, 64, 128, 3),
                              ("convnet conv2 (sta)", 8, 128, 256, 3)):
        k_dim = k * k * c
        x = torch.randn(256, hw, hw, c, generator=gen, device=dev)
        w = torch.randn(k_dim, n, generator=gen, device=dev) / k_dim ** 0.5
        bias = torch.randn(n, generator=gen, device=dev)
        ms = time_ms(lambda: conv_gemm(x, w, bias, kh=k, kw=k, act="relu"))
        lib_ms = time_ms(cudnn(x, w, bias, c, n, torch.float32, k))
        line = (f"{label}: conv_gemm f32 {name} B256 {hw}x{hw}x{c} -> {n} "
                f"{k}x{k}: {ms:.4f} ms; cuDNN f32 (TF32 off) {lib_ms:.4f} ms")
        if c % 16 == 0:
            ones = torch.full((k_dim // 8, n), 0xFF, dtype=torch.int32,
                              device=dev)
            plane = time_ms(lambda: conv_gemm_dbb(x, w, ones, bias, kh=k,
                                                  kw=k, act="relu", nnz=8))
            line += f"; as an all-ones DBB plane of nnz 8 {plane:.4f} ms"
        print(line)
        xf = torch.randn(256, hw, hw, c, generator=gen, device=dev)
        xs = act_scale(xf)
        xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
        qw = quantize_weight(torch.randn(k_dim, n, generator=gen,
                                         device=dev))
        scale = xs * qw.scale
        ms = time_ms(lambda: conv_gemm(xq, qw.q, bias, scale, kh=k, kw=k,
                                       act="relu"))
        raw = time_ms(lambda: conv_gemm(xq, qw.q, kh=k, kw=k))
        lib_ms = time_ms(cudnn(xq.float(), qw.q.float(), bias, c, n,
                               torch.bfloat16, k))
        print(f"{label}: conv_gemm_s8 {name} B256 {hw}x{hw}x{c} -> {n} "
              f"{k}x{k}: {ms:.4f} ms (f32 epilogue); int32 output "
              f"{raw:.4f} ms; cuDNN bf16 {lib_ms:.4f} ms")
        if small_fn is None or k_dim > 160:
            continue
        out = torch.empty((256, hw, hw, n), device=dev)
        for dname, xx, ww, sc in (("f32", x, w, None),
                                  ("int8", xq, qw.q, scale)):
            def run(phase):
                def go():
                    rc = small_fn(xx.data_ptr(), ww.data_ptr(),
                                  build.ptr(sc), bias.data_ptr(),
                                  out.data_ptr(), 256, hw, hw, c, hw, hw, k,
                                  k, 1, (k - 1) // 2, (k - 1) // 2, n, 1,
                                  build.dtype_code(xx.dtype), phase,
                                  build.stream_handle(dev))
                    if rc:
                        raise RuntimeError(f"small phase: cudaError {rc}")
                return go
            split = {pname: time_ms(run(ph)) for pname, ph in
                     (("staging", 0), ("staging + math", 1),
                      ("staging + stores", 2), ("all", 3))}
            print(f"{label}: conv_gemm small-C body {dname} {name} phases: "
                  + ", ".join(f"{kk} {v:.4f} ms" for kk, v in split.items()))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else sys.argv[1])
