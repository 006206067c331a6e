#!/usr/bin/env python3
"""Where an olmo-1b train step's time goes on one CUDA card:

    python scripts/torch_train_step_probe.py

Full width (16 layers, d 2048, vocab 50304), batch 8 × 256 tokens of the
synthetic LM stream, AdamW, the DBB bound at k 4 (the end of a ramp). For
remat "auto" (the config's) and "none" it prints the median of 3 host-clock
intervals, each closed by a device synchronise, of: the whole
`make_train_step` step; its parts — `apply_dbb_to_tree` (the projection),
`loss_and_grads` (forward and backward), the forward alone without
gradients, `clip_by_global_norm` and the AdamW update; and the peak device
memory. Then `dbb_mask` at olmo-1b's three layer-matrix shapes beside the
sort it replaced (`core.dbb._top_slots`, which `pack_dbb` still uses), the
two masks checked equal. Prints the card's name and power limit first.
Builds no kernel: training launches none.
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def _ms(torch, fn, n=3) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _sort_mask(torch, w, block, nnz):
    """The keep-mask by a stable sort (the selection `pack_dbb` makes)."""
    from repro_torch.core.dbb import _top_slots
    k_dim, n = w.shape
    blocks = w.abs().reshape(k_dim // block, block, n).transpose(1, 2)
    keep = torch.zeros(blocks.shape, dtype=torch.bool, device=w.device)
    keep.scatter_(-1, _top_slots(blocks, nnz), True)
    return keep.transpose(1, 2).reshape(k_dim, n)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.config import RunConfig, ShapeSpec, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core.dbb import dbb_mask
    from repro_torch.core.sparsity import apply_dbb_to_tree
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.loop import (init_train_state, loss_and_grads,
                                        make_loss_fn, make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    base = get_config("olmo-1b")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_pipeline(
        base, ShapeSpec("t", 256, 8, "train"), seed=0).batch_at(0).items()}
    for remat in ("auto", "none"):
        cfg = base.replace(remat=remat)
        rc = RunConfig(model=cfg, train=TrainConfig(steps=200))
        st = init_train_state(rc, seed=0, device=dev)
        step = make_train_step(rc, nnz=4)
        for _ in range(2):
            st, _ = step(st, batch)
        torch.cuda.reset_peak_memory_stats()
        t_step = _ms(torch, lambda: step(st, batch))
        peak = torch.cuda.max_memory_allocated()
        proj = apply_dbb_to_tree(st.params, cfg.dbb, nnz=4,
                                 straight_through=False)
        loss_fn = make_loss_fn(cfg, project_dbb=False)
        grads, _ = loss_and_grads(loss_fn, proj, batch)
        _, update = opt_mod.make_optimizer(rc.train)
        parts = {
            "project": lambda: apply_dbb_to_tree(
                st.params, cfg.dbb, nnz=4, straight_through=False),
            "loss+grads": lambda: loss_and_grads(loss_fn, proj, batch),
            "forward only": lambda: torch.no_grad()(loss_fn)(proj, batch),
            "clip": lambda: opt_mod.clip_by_global_norm(grads, 1.0),
            "adamw update": lambda: update(grads, st.opt_state, st.params,
                                           5)}
        print(f"remat={remat}: step {t_step:.1f} ms, peak "
              f"{peak / 1e9:.3f} GB; " + ", ".join(
                  f"{k} {_ms(torch, f):.1f} ms" for k, f in parts.items()))
        del st, proj, grads, parts
        torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(0)
    for shape in ((2048, 2048), (2048, 8192), (8192, 2048)):
        w = torch.randn(shape, generator=g, device=dev)
        same = torch.equal(dbb_mask(w, 8, 4), _sort_mask(torch, w, 8, 4))
        t_new = _ms(torch, lambda: dbb_mask(w, 8, 4), 10)
        t_sort = _ms(torch, lambda: _sort_mask(torch, w, 8, 4), 10)
        print(f"mask {shape}: dbb_mask {t_new:.3f} ms, sort {t_sort:.3f} "
              f"ms, equal {same}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
