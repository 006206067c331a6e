"""Build and load the CUDA kernels (nvcc → one shared library per source,
bound with ctypes).

Each ``csrc/<name>.cu`` holds one kernel and a plain C launcher; it
compiles for ``sm_90a`` into ``build/kernels/lib<name>-<hash>.so`` at the
repository root (listed in ``.gitignore``), where ``<hash>`` covers the
sources and flags, so an edited source rebuilds. `build` starts one nvcc
per missing library, all at once, and waits for them; `load` builds at
first use. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

__all__ = ["KERNEL_SOURCES", "DTYPE_CODES", "BUILD_DIR", "build", "load",
           "dtype_code", "stream_handle"]

_SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

KERNEL_SOURCES = {
    "dbb_gemm": "dbb_gemm.cu",
    "dbb_gemm_skinny": "dbb_gemm_skinny.cu",
    "sta_gemm_skinny": "sta_gemm_skinny.cu",
    "paged_decode": "paged_decode.cu",
    "flash_prefill": "flash_prefill.cu",
    "flash_prefill_packed": "flash_prefill_packed.cu",
    "sta_gemm": "sta_gemm.cu",
    "conv_gemm": "conv_gemm.cu",
    "conv_gemm_dbb": "conv_gemm_dbb.cu",
    "head_sample_fused": "head_sample_fused.cu",
}
_HEADERS = ("common.cuh", "conv_tc.cuh", "flash_tc.cuh", "flash_tile.cuh",
            "gemm_tile.cuh", "hopper.cuh", "skinny_float.cuh", "split_k.cuh",
            "split_k_s8.cuh", "tc_gemm.cuh", "tc_gemm_s8.cuh")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the C launchers (csrc/common.cuh, enum DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.int32: 3}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin)")
    return str(path)


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in (KERNEL_SOURCES[name],) + _HEADERS:
        h.update((_SRC_DIR / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (all by default) that are not built yet,
    one nvcc process each, in parallel. Returns seconds per compiled
    kernel; raises with nvcc's output if any fails. The ``-Xptxas -v``
    report (registers, shared memory, spills) lands in ``<lib>.log``."""
    names = list(KERNEL_SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc, *_FLAGS, "-I", str(_SRC_DIR), "-o", str(tmp),
               str(_SRC_DIR / KERNEL_SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       log, tmp, out, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, log, tmp, out, t0) in procs.items():
        rc = proc.wait()
        seconds[name] = time.perf_counter() - t0
        log.close()
        if rc != 0:
            failed.append(f"{name} (rc {rc}):\n"
                          + out.with_suffix(".log").read_text()[-4000:])
        else:
            os.replace(tmp, out)      # atomic: readers never see a partial .so
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def dtype_code(dtype: torch.dtype) -> int:
    if dtype not in DTYPE_CODES:
        raise TypeError(f"dtype {dtype} not taken by the kernels "
                        f"({sorted(map(str, DTYPE_CODES))})")
    return DTYPE_CODES[dtype]


def stream_handle(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as a raw handle for ctypes."""
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()
