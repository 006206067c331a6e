"""Shared set-up of the port-vs-reference model tests: smoke-width weights
of a dense_lm config (olmo-1b unless ``arch`` names another) from the
reference's `init_params`, DBB-projected and packed by the reference, then
carried into the port with `params_from_numpy`.

The embedding is scaled by 0.1 and the layer weights by 3 before packing:
with random tied weights the residual stream is otherwise dominated by the
token's own embedding and greedy decoding just echoes the last token,
which would leave the layers untested. The init's norm scales (ones),
norm biases and QKV biases (zeros) would leave those parameters untested
too, so configs that have them get seeded random values in their place.
"""
import jax
import numpy as np

from repro.configs import get_config
from repro.core.dbb_linear import pack_tree
from repro.core.sparsity import apply_dbb_to_tree
from repro.models import registry
from repro_torch.configs import get_config as tget
from repro_torch.interop import params_from_numpy

PIN = (("attention", "attn_naive"),)
# the dense_lm family's configs (olmo-1b is the slice's own)
FAMILY = ("olmo-1b", "qwen2.5-14b", "yi-34b", "starcoder2-15b")


def configs(gemm_impl: str = "pallas", pin: bool = False,
            arch: str = "olmo-1b", **kw):
    """(reference config, port config) of ``arch`` at smoke width, f32.
    Unpinned, prefill attention takes the flash kernels under
    ``gemm_impl="pallas"`` in both packages; ``pin`` keeps it on the naive
    route."""
    kw = dict(kw, remat="none", gemm_impl=gemm_impl)
    kw.setdefault("kernel_routes", PIN if pin else ())
    return (get_config(arch, smoke=True).replace(**kw),
            tget(arch, smoke=True).replace(**kw))


def _seeded_norms_and_biases(p, seed: int):
    """Norm scales ``1 + 0.2 N(0, 1)``, norm biases and linear biases
    ``0.2 N(0, 1)``, from numpy seeded with ``seed``."""
    rng = np.random.default_rng(seed + 1000)

    def visit(path, a):
        keys = [str(getattr(k, "key", k)) for k in path]
        normed = any(k.startswith("ln_") or k == "final_norm" for k in keys)
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if normed and keys[-1] == "scale":
            return np.float32(1.0) + np.float32(0.2) * noise
        if (normed and keys[-1] == "bias") or keys[-1] == "b":
            return np.float32(0.2) * noise
        return a
    return jax.tree_util.tree_map_with_path(visit, p)


def dense_params(seed: int = 0, arch: str = "olmo-1b"):
    """(reference dense tree, the same tree in the port): the weights
    `packed_params` packs, left unpacked."""
    cfg, _ = configs(arch=arch)
    p = jax.tree_util.tree_map(
        np.asarray, registry.init_params(jax.random.PRNGKey(seed), cfg))
    p["embed"]["table"] = p["embed"]["table"] * np.float32(0.1)
    p["layers"] = jax.tree_util.tree_map(lambda a: a * np.float32(3.0),
                                         p["layers"])
    if arch != "olmo-1b":
        p = _seeded_norms_and_biases(p, seed)
    return p, params_from_numpy(p)


def packed_params(seed: int = 0, arch: str = "olmo-1b"):
    """(reference packed tree, the same tree in the port)."""
    cfg, _ = configs(arch=arch)
    p, _ = dense_params(seed, arch)
    jpacked = pack_tree(apply_dbb_to_tree(p, cfg.dbb,
                                          straight_through=False), cfg.dbb)
    return jpacked, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jpacked))


def prompts(lengths, seed: int = 0, vocab: int = 512):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(2, vocab, n))) for n in lengths]


def test_fixture_weights_make_the_layers_matter():
    """With these weights greedy decoding does not echo the prompt's last
    token: most rows produce several distinct tokens."""
    import torch

    from repro_torch.serve.engine import ServeEngine
    torch.set_num_threads(1)
    _, tcfg = configs()
    _, tp = packed_params()
    out = ServeEngine(tcfg, tp, max_batch=8, device="cpu").generate(
        prompts([6] * 8), max_new_tokens=8)
    assert sum(len(set(row)) > 2 for row in out) >= 6
