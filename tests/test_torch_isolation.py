"""The port stands alone: importing every `repro_torch` module pulls in
neither JAX nor the JAX package, and nothing builds at import time."""
import os
import pkgutil
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def _modules():
    sys.path.insert(0, SRC)
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_module_is_listed():
    mods = _modules()
    assert len(mods) >= 31
    for name in ("repro_torch.config", "repro_torch.configs.olmo_1b",
                 "repro_torch.core.dbb", "repro_torch.core.sparsity",
                 "repro_torch.core.dbb_linear", "repro_torch.kernels.epilogue",
                 "repro_torch.kernels.common", "repro_torch.kernels.dispatch",
                 "repro_torch.kernels.dbb_gemm.ops",
                 "repro_torch.kernels.skinny.ops",
                 "repro_torch.kernels.attn.ops",
                 "repro_torch.models.common", "repro_torch.models.attention",
                 "repro_torch.models.mlp", "repro_torch.models.transformer",
                 "repro_torch.models.registry", "repro_torch.serve.engine",
                 "repro_torch.serve.kv_cache", "repro_torch.kernels.attn.ref",
                 "repro_torch.interop", "repro_torch.kernels.sta_gemm.ops",
                 "repro_torch.kernels.sta_gemm.ref",
                 "repro_torch.kernels.conv_gemm.ops",
                 "repro_torch.kernels.conv_gemm.ref",
                 "repro_torch.models.cnn", "repro_torch.configs.convnet_dbb",
                 "repro_torch.configs.lenet5_dbb",
                 "repro_torch.kernels.sample.ops",
                 "repro_torch.kernels.sample.ref",
                 "repro_torch.serve.sampling",
                 "repro_torch.serve.sampling.params",
                 "repro_torch.serve.sampling.ops",
                 "repro_torch.models.rwkv6", "repro_torch.models.mamba2",
                 "repro_torch.configs.rwkv6_1b6",
                 "repro_torch.configs.paligemma_3b",
                 "repro_torch.configs.musicgen_medium",
                 "repro_torch.analysis", "repro_torch.analysis.contracts",
                 "repro_torch.analysis.materialize",
                 "repro_torch.analysis.smem",
                 "repro_torch.analysis.layering",
                 "repro_torch.analysis.dispatch_check",
                 "repro_torch.analysis.lint",
                 "repro_torch.analysis.tp_smem",
                 "repro_torch.dist.mesh_ctx", "repro_torch.dist.sharding",
                 "repro_torch.dist.collectives"):
        assert name in mods


@pytest.mark.parametrize("jax_blocked", [False, True])
def test_imports_pull_in_no_jax_and_no_repro(jax_blocked):
    """In a fresh interpreter: import every module, then check sys.modules.
    The second case also makes ``import jax`` fail outright."""
    code = f"""
import importlib, sys
sys.path.insert(0, {SRC!r})
if {jax_blocked!r}:
    sys.modules['jax'] = None
for name in {_modules()!r}:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')
             or m == 'repro' or m.startswith('repro.'))
bad = [m for m in bad if sys.modules[m] is not None]
assert not bad, bad
from repro_torch.kernels import build
assert not build._LIBS, 'a kernel library was loaded at import'
print('ok')
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py exits non-zero and prints no result line here."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    out = subprocess.run([sys.executable, os.path.join(root, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_imports_no_jax_and_no_repro():
    """Every import statement of chip_smoke.py, its functions' included,
    names neither JAX nor the JAX package; importing it with both blocked
    works."""
    import ast
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    path = os.path.join(root, "chip_smoke.py")
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    tops = {n.split(".")[0] for n in names}
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "repro"}, tops
    code = f"""
import sys
sys.modules['jax'] = None
sys.modules['repro'] = None
sys.path.insert(0, {root!r})
import chip_smoke
print('ok')
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
