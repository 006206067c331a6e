#!/usr/bin/env python3
"""olmo-1b trained longer than chip_smoke's train phase, then evaluated as
that phase evaluates it (one CUDA card):

    python scripts/torch_train_eval_probe.py STEPS [LR]

Trains olmo-1b at full width through ``repro_torch.launch.train.main``
(B8 S256, AdamW, the bound ramped 8 -> 4 over 50 steps, STEPS steps, lr
LR or the CLI's 3e-4; no checkpoints), prints its logged loss curve, then
runs chip_smoke.py's `_train_olmo_kernels` on the k 4 projection of the
trained masters: held-out CE on the kernel route for f32, INT8 and w4
planes beside the plain route, greedy generate against the plain route,
and ``draft_k=2`` at temperature 0 and 1 with the acceptance rate. It
builds the kernels first (about 80 s). Prints the card's name and power
limit.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.config import ShapeSpec
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import apply_dbb_to_tree
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.kernels import build
    from repro_torch.launch import train as train_cli
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    build.build()
    steps = int(argv[0])
    lr = argv[1] if len(argv) > 1 else "3e-4"
    rep = {}
    t0 = time.perf_counter()
    train_cli.main(["--arch", "olmo-1b", "--full", "--steps", str(steps),
                    "--seq-len", "256", "--batch", "8", "--lr", lr,
                    "--dbb-ramp", "50"], log=lambda *_: None, report=rep)
    torch.cuda.synchronize()
    hist = rep["history"]
    print(f"trained {steps} steps (lr {lr}) in "
          f"{time.perf_counter() - t0:.1f} s; logged losses " + ", ".join(
              f"{h['step']}: {h['loss']:.4f}" for h in hist[::max(
                  1, len(hist) // 20)] + hist[-1:]))
    cfg = get_config("olmo-1b")
    proj = apply_dbb_to_tree(rep["state"].params, cfg.dbb,
                             straight_through=False)
    del rep
    pipe = make_pipeline(cfg, ShapeSpec("cli", 256, 8, "train"), seed=0)
    report = {"card": card, "train": {"olmo": {}}}
    ok = chip_smoke._train_olmo_kernels(torch, dev, report, {}, cfg, proj,
                                        pipe)
    print(f"evaluation gates {'ok' if ok else 'FAIL'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
