#!/usr/bin/env python3
"""The float branches of the port's GEMM-family kernels and of
head_sample_fused, and the DBB kernels' int8 branches, on seeded inputs,
for a bit-for-bit comparison of two source trees (a commit and its
parent) on one CUDA card:

    python scripts/torch_float_bits.py TREE OUT.pt     # TREE's kernels
    python scripts/torch_float_bits.py --compare A.pt B.pt [PREFIX ...]

TREE is a checkout of this repository; its kernels build into
TREE/build/kernels. The calls: sta_gemm (M8 f32, M24 and M300 bf16),
sta_gemm_skinny (M8, M24; f32 M24 N4099, bf16 M32 K8192 N2048 and M5
N999), paged_decode (f32 and bf16, B4 Hkv4 G2 D128, page 64, 10 pages),
dbb_gemm and dbb_gemm_skinny on the f32,
int8 and w4 values planes, conv_gemm, conv_gemm_dbb, a sampled
head_sample_fused (M8 K2048 N8192, penalties, temperature-0 rows),
flash_prefill and flash_prefill_packed in f32 at D 128 and in bf16 at D
72 (the plain-FMA body's calls), two shapes each, and convnet's classifier
(f32 x, K4096 N10, DBB k2, bias) on each values plane through dbb_gemm at
B256 (the narrow split-K body) and dbb_gemm_skinny at B1 and B7; and the
int8-activation branches of dbb_gemm and dbb_gemm_skinny (M8, M24, M300),
of sta_gemm (M300, M512; K1024 N1008), of sta_gemm_skinny (M8, M24,
M32; the same K and N), of conv_gemm (C 24) and of conv_gemm_dbb (C 64
and 72), each with int32, f32 after scale + bias + gelu and int8
requantized after relu; conv_gemm_dbb's f32 branch at C 64 N 48 and at
convnet conv1's geometry (B2). The "conv_gemm" and "conv_gemm_dbb" keys
(f32, C 24) run the FMA bodies.

``--compare`` holds every output of A bit-equal to B's, except those whose
key starts with one of the PREFIXes: a redesign names the outputs it may
change. The split-K redesign of dbb_gemm_skinny's float branches and of
dbb_gemm's f32-x narrow-N branch changed the sums' order, so it was
compared with

    --compare A.pt B.pt "dbb_gemm_skinny f32" "dbb_gemm_skinny i8" \
        "dbb_gemm_skinny w4" "classifier"

(the M8 f32 dbb_gemm calls have N 1000, off the narrow body); every other
output, the int8-activation branches' included, stays bit-equal.

The int8 tensor-core body of sta_gemm's and dbb_gemm's int8 branches
(s8 wgmma: dbb_gemm_s8 at M300 and sta_gemm_s8 at M300 / M512 run on it)
may change no output: integer sums are exact in any order and the
epilogue is the IMAD body's, so it is compared with an empty list,

    --compare A.pt B.pt

The redesign of sta_gemm_skinny's float body (all M <= 32 rows in one
block, the same K order) and of paged_decode (a row's pages split across
blocks, merged in a second launch) keeps every sta_gemm_skinny and
head_sample_fused output bit for bit; only the decode outputs (f32 and
bf16, identity table and shuffled pool, with and without a window and a
softcap) may change:

    --compare A.pt B.pt "paged_decode"

The int8 split-K body of the skinny kernels' int8 branches
(csrc/split_k_s8.cuh, replacing their row-chunk bodies) may change no
output either: its sums are integers and its epilogue the same, so every
``dbb_gemm_skinny_s8`` and ``sta_gemm_skinny_s8`` key is held bit-equal,

    --compare A.pt B.pt

The tensor-core body of conv_gemm_dbb (csrc/conv_tc.cuh: 3xTF32 for f32
images, s8 wgmma for int8 ones) changes the f32 sums' order and no integer
sum, so only its f32 keys at C 64 may differ:

    --compare A.pt B.pt "conv_gemm_dbb f32"

(the int8 keys, ``conv_gemm_dbb_s8 C64`` on the new body included, and the
FMA body's ``conv_gemm_dbb`` at C 24 are held bit-equal).

The redesign of head_sample_fused (on sta_gemm_skinny's float body, the
same K order and epilogue arithmetic) and of conv_gemm (a small-C body, one
ascending-k fmaf chain an output as the FMA body's; the tensor-core body of
conv_gemm_dbb on dense images, 3xTF32) may change only the dense f32
outputs on the tensor-core body; the sampling head at M 1 / 8 / 24 / 32,
the small-C body's f32 and int8 outputs and the dense int8 outputs are
held bit-equal:

    --compare A.pt B.pt "conv_gemm tc f32"
"""
import sys


def run(tree: str, out_path: str) -> None:
    sys.path.insert(0, tree + "/src")
    import torch
    from repro_torch.core.dbb import pack_dbb
    from repro_torch.core.quant import quantize_weight
    from repro_torch.kernels.conv_gemm import conv_gemm, conv_gemm_dbb
    from repro_torch.kernels.dbb_gemm import dbb_gemm
    from repro_torch.kernels.sample.ops import head_sample_fused
    from repro_torch.kernels.skinny import dbb_gemm_skinny, sta_gemm_skinny
    from repro_torch.kernels.sta_gemm import sta_gemm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    out = {}
    bias = rn(1000)
    for m, dt in ((8, torch.float32), (24, torch.bfloat16),
                  (300, torch.bfloat16)):
        x, w = rn(m, 1024).to(dt), rn(1024, 1000)
        if m <= 32:
            out[f"sta_gemm_skinny M{m}"] = sta_gemm_skinny(
                x, w.to(dt), bias, act="silu")
        out[f"sta_gemm M{m}"] = sta_gemm(x, w.to(dt), bias, act="gelu")
        qw = quantize_weight(w)
        planes = (("f32", pack_dbb(w, 8, 3), {}, None),
                  ("i8", pack_dbb(qw.q, 8, 3), {}, qw.scale),
                  ("w4", pack_dbb(w, 8, 4, bits=4, group=128), None, None))
        for plane, p, extra, sc in planes:
            nnz = 4 if plane == "w4" else 3
            if extra is None:
                extra = dict(bits=4, group=128, gscale=p.scale)
            out[f"dbb_gemm {plane} M{m}"] = dbb_gemm(
                x, p.values, p.bitmask, bias, sc, act="silu", nnz=nnz,
                **extra)
            if m <= 32:
                out[f"dbb_gemm_skinny {plane} M{m}"] = dbb_gemm_skinny(
                    x, p.values, p.bitmask, bias, sc, act="silu", nnz=nnz,
                    **extra)
    x, xc = rn(256, 4096), rn(4096, 10) * 0.02
    qc = quantize_weight(xc)
    for plane, p, sc, extra in (
            ("f32", pack_dbb(xc, 8, 2), None, {}),
            ("i8", pack_dbb(qc.q, 8, 2), qc.scale, {}),
            ("w4", pack_dbb(xc, 8, 2, bits=4, group=128), None, None)):
        if extra is None:
            extra = dict(bits=4, group=128, gscale=p.scale)
        out[f"classifier dbb_gemm {plane} B256"] = dbb_gemm(
            x, p.values, p.bitmask, bias[:10], sc, nnz=2, **extra)
        for b in (1, 7):
            out[f"classifier dbb_gemm_skinny {plane} B{b}"] = dbb_gemm_skinny(
                x[:b].contiguous(), p.values, p.bitmask, bias[:10], sc, nnz=2,
                **extra)
    img, wc = rn(4, 16, 16, 24), rn(9 * 24, 64)
    out["conv_gemm"] = conv_gemm(img, wc, bias[:64], act="relu", kh=3, kw=3)
    p = pack_dbb(wc, 8, 2)
    out["conv_gemm_dbb"] = conv_gemm_dbb(img, p.values, p.bitmask,
                                         bias[:64], act="relu", kh=3, kw=3,
                                         nnz=2)
    m, k, n = 8, 2048, 8192
    h, w = rn(m, k) / k ** 0.5, rn(k, n)
    counts = torch.randint(0, 3, (m, n), generator=g, device=dev,
                           dtype=torch.int32)
    r = torch.arange(m, device=dev)
    ones = torch.ones(m, device=dev)
    score, tok = head_sample_fused(
        h, w, counts, temp=torch.where(r % 4 == 0, 0.0, 0.7).float(),
        rep=ones * 1.2, pres=ones * 0.1, freq=ones * 0.1,
        seed=(r * 7919).to(torch.int32), step=(r * 3).to(torch.int32))
    out["head_sample_fused score"], out["head_sample_fused token"] = (score,
                                                                     tok)
    from repro_torch.kernels.attn import (flash_attention,
                                          packed_flash_attention)
    i32 = dict(dtype=torch.int32, device=dev)
    for dt, d in ((torch.float32, 128), (torch.bfloat16, 72)):
        tag = f"{str(dt)[6:]} D{d}"
        for b, t, s, hq, hkv, st, qo, win in (
                (2, 77, 77, 4, 2, (0, 13), (0, 0), 0),
                (1, 130, 300, 2, 2, (5,), (170,), 50)):
            q = rn(b, t, hq, d).to(dt)
            k, v = rn(b, s, hkv, d).to(dt), rn(b, s, hkv, d).to(dt)
            out[f"flash_prefill {tag} T{t} S{s}"] = flash_attention(
                q, k, v, torch.tensor(st, **i32),
                q_offset=torch.tensor(qo, **i32), window=win)
        for lens, win in (((70, 90, 7, 150), 0), ((100, 7, 150, 40), 50)):
            t = sum(lens)
            q, k, v = (rn(t, 4, d).to(dt) for _ in range(3))
            seg = torch.repeat_interleave(torch.arange(len(lens), **i32),
                                          torch.tensor(lens, device=dev))
            out[f"flash_prefill_packed {tag} T{t}"] = packed_flash_attention(
                q, k, v, seg, window=win, softcap=30.0 if win else 0.0)
    # sta_gemm_skinny's float body on its other paths: the 4-byte copies
    # (f32, N 4099), the cluster split (bf16 K8192 N2048), the 2-byte
    # copies (bf16, N 999)
    for m, k, n, dt in ((24, 2048, 4099, torch.float32),
                        (32, 8192, 2048, torch.bfloat16),
                        (5, 136, 999, torch.bfloat16)):
        out[f"sta_gemm_skinny {str(dt)[6:]} M{m} K{k} N{n}"] = (
            sta_gemm_skinny(rn(m, k).to(dt), (rn(k, n) * 0.05).to(dt),
                            rn(n), act="gelu"))
    from repro_torch.kernels.attn import (identity_block_table,
                                          paged_decode_attention)
    for dt in (torch.float32, torch.bfloat16):
        b, hkv, gq, d, page, n_log = 4, 4, 2, 128, 64, 10
        q = rn(b, hkv, gq, d).to(dt)
        kc, vc = (rn(b, n_log * page, hkv, d).to(dt) for _ in range(2))
        lengths = torch.tensor([639, 300, 64, 450], **i32)
        start = torch.tensor([0, 17, 64, 200], **i32)
        kp = kc.view(b * n_log, page, hkv, d)
        vp = vc.view(b * n_log, page, hkv, d)
        perm = torch.randperm(b * n_log, generator=g, device=dev)
        pool_k, pool_v = torch.empty_like(kp), torch.empty_like(vp)
        pool_k[perm], pool_v[perm] = kp, vp
        tables = (("identity", kp, vp, identity_block_table(b, n_log, dev)),
                  ("shuffled", pool_k, pool_v,
                   perm.view(b, n_log).int().contiguous()))
        for layout, kk, vv, tab in tables:
            for win, cap in ((0, 0.0), (200, 30.0)):
                out[f"paged_decode {str(dt)[6:]} {layout} window {win} "
                    f"softcap {cap:g}"] = paged_decode_attention(
                        q, kk, vv, tab, lengths, start, window=win,
                        softcap=cap)
    xi = torch.randint(-127, 128, (300, 1024), generator=g, device=dev,
                       dtype=torch.int8)
    pi = pack_dbb(torch.randint(-127, 128, (1024, 1000), generator=g,
                                device=dev, dtype=torch.int8), 8, 3)
    ws = torch.rand(1000, generator=g, device=dev) * 1e-3
    for m in (8, 24, 300):
        xm = xi[:m].contiguous()
        fn = dbb_gemm_skinny if m <= 32 else dbb_gemm
        name = "dbb_gemm_skinny_s8" if m <= 32 else "dbb_gemm_s8"
        out[f"{name} M{m} i32"] = fn(xm, pi.values, pi.bitmask, nnz=3)
        out[f"{name} M{m} f32"] = fn(xm, pi.values, pi.bitmask, bias, ws,
                                     act="gelu", nnz=3)
        out[f"{name} M{m} i8"] = fn(xm, pi.values, pi.bitmask, None, ws,
                                    act="relu", nnz=3, out_dtype=torch.int8)
    xd = torch.randint(-127, 128, (512, 1024), generator=g, device=dev,
                       dtype=torch.int8)
    wd = torch.randint(-127, 128, (1024, 1008), generator=g, device=dev,
                       dtype=torch.int8)
    bd, sd = rn(1008), torch.rand(1008, generator=g, device=dev) * 1e-3
    for m in (300, 512):
        xm = xd[:m].contiguous()
        out[f"sta_gemm_s8 M{m} i32"] = sta_gemm(xm, wd)
        out[f"sta_gemm_s8 M{m} f32"] = sta_gemm(xm, wd, bd, sd, act="gelu")
        out[f"sta_gemm_s8 M{m} i8"] = sta_gemm(xm, wd, None, sd, act="relu",
                                              out_dtype=torch.int8)
    for m in (8, 24, 32):
        xm = xd[:m].contiguous()
        out[f"sta_gemm_skinny_s8 M{m} i32"] = sta_gemm_skinny(xm, wd)
        out[f"sta_gemm_skinny_s8 M{m} f32"] = sta_gemm_skinny(
            xm, wd, bd, sd, act="gelu")
        out[f"sta_gemm_skinny_s8 M{m} i8"] = sta_gemm_skinny(
            xm, wd, None, sd, act="relu", out_dtype=torch.int8)
    # the convs' int8 branches (conv_gemm_s8 at C 24; conv_gemm_dbb_s8 at C
    # 64, the tensor-core body, and C 72, the IMAD body), each with int32,
    # f32 after scale + bias + gelu and int8 requantized after relu; and
    # conv_gemm_dbb's f32 branch at C 64, N 48 and at convnet conv1's
    # geometry (B2), both on the tensor-core body
    xc = torch.randint(-127, 128, (2, 9, 7, 72), generator=g, device=dev,
                       dtype=torch.int8)
    wc8 = torch.randint(-127, 128, (9 * 72, 48), generator=g, device=dev,
                        dtype=torch.int8)
    bc, sc = rn(48), torch.rand(48, generator=g, device=dev) * 1e-3
    for name, c in (("conv_gemm_s8", 24), ("conv_gemm_dbb_s8 C64", 64),
                    ("conv_gemm_dbb_s8 C72", 72)):
        xm = xc[..., :c].contiguous()
        wm = wc8[:9 * c].contiguous()
        if name == "conv_gemm_s8":
            def fn(*a, **kw):
                return conv_gemm(xm, wm, *a, kh=3, kw=3, **kw)
        else:
            pc = pack_dbb(wm, 8, 2)

            def fn(*a, _p=pc, **kw):
                return conv_gemm_dbb(xm, _p.values, _p.bitmask, *a, kh=3,
                                     kw=3, nnz=2, **kw)
        out[f"{name} i32"] = fn()
        out[f"{name} f32"] = fn(bc, sc, act="gelu")
        out[f"{name} i8"] = fn(None, sc, act="relu", out_dtype=torch.int8)
    for label, shape, n in (("C64 N48", (2, 9, 7, 64), 48),
                            ("conv1 B2", (2, 16, 16, 64), 128)):
        xf = rn(*shape)
        pf = pack_dbb(rn(9 * shape[-1], n) * 0.05, 8, 2)
        out[f"conv_gemm_dbb f32 {label}"] = conv_gemm_dbb(
            xf, pf.values, pf.bitmask, rn(n), act="relu", kh=3, kw=3, nnz=2)
    # the sampling head at M 1, 24 and 32 at olmo-1b's head width (sampled
    # and temperature-0 rows); conv_gemm at the small-C body's shapes
    # (convnet conv0, lenet conv1; f32 and int8) and at the dense
    # tensor-core body's (convnet conv1's geometry at B2; f32 and int8)
    wh = rn(2048, 50304) * 0.02
    for m in (1, 24, 32):
        hm = rn(m, 2048)
        cm = torch.randint(0, 3, (m, 50304), generator=g, device=dev,
                           dtype=torch.int32)
        r = torch.arange(m, device=dev)
        ones = torch.ones(m, device=dev)
        score, tok = head_sample_fused(
            hm, wh, cm, temp=torch.where(r % 4 == 0, 0.0, 0.7).float(),
            rep=ones * 1.2, pres=ones * 0.1, freq=ones * 0.1,
            seed=(r * 7919).to(torch.int32), step=(r * 3).to(torch.int32))
        out[f"head_sample_fused M{m} score"] = score
        out[f"head_sample_fused M{m} token"] = tok
    for label, b, hw, c, n, k, body in (
            ("conv0", 4, 32, 3, 64, 3, "small"),
            ("lenet conv1", 4, 14, 6, 16, 5, "small"),
            ("conv1 B2", 2, 16, 64, 128, 3, "tc")):
        xf = rn(b, hw, hw, c)
        wf = rn(k * k * c, n) / (k * k * c) ** 0.5
        out[f"conv_gemm {body} f32 {label}"] = conv_gemm(
            xf, wf, rn(n), act="relu", kh=k, kw=k)
        xq = torch.randint(-127, 128, (b, hw, hw, c), generator=g,
                           device=dev, dtype=torch.int8)
        wq = torch.randint(-127, 128, (k * k * c, n), generator=g,
                           device=dev, dtype=torch.int8)
        sq = torch.rand(n, generator=g, device=dev) * 1e-3
        out[f"conv_gemm {body} s8 {label} i32"] = conv_gemm(xq, wq, kh=k,
                                                            kw=k)
        out[f"conv_gemm {body} s8 {label} f32"] = conv_gemm(
            xq, wq, rn(n), sq, act="gelu", kh=k, kw=k)
        out[f"conv_gemm {body} s8 {label} i8"] = conv_gemm(
            xq, wq, None, sq, act="relu", kh=k, kw=k, out_dtype=torch.int8)
    torch.cuda.synchronize()
    torch.save({k: v.cpu() for k, v in out.items()}, out_path)
    print(f"{tree}: {len(out)} outputs saved to {out_path}")


def compare(a_path: str, b_path: str, may_differ=()) -> int:
    import torch
    a, b = torch.load(a_path), torch.load(b_path)
    differ = [k for k in a if k not in b or not torch.equal(a[k], b[k])]
    free = [k for k in differ if k.startswith(tuple(may_differ))]
    held = [k for k in differ if k not in free]
    print(f"kernel outputs: {len(a)}, {len(a) - len(differ)} "
          f"bit-equal; " + (f"DIFFER: {held}" if held else "no other differs")
          + (f"; allowed to differ and differ: {free}" if free else ""))
    return 1 if held or set(a) != set(b) else 0


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2], sys.argv[3], sys.argv[4:]))
    run(sys.argv[1], sys.argv[2])
