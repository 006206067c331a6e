"""PyTorch / CUDA port of the STA-DBB serving stack for NVIDIA Hopper.

Serves a dense LM greedily from DBB-packed weights through hand-written
CUDA kernels (`repro_torch.csrc`), with a plain PyTorch version of every
kernel beside it. Entry points take an explicit ``device`` and default to
``"cuda"``; pass ``device="cpu"`` to run the plain versions.
"""
