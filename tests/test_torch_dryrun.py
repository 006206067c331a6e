"""The port's dry run on the CPU: `configs.ASSIGNED`, `config.SHAPES` and
`shape_applicable`, `launch.specs` against the reference's for every
assigned arch × shape × production mesh split, the reference's own
dry-run cell run in both packages, and a full-size cell of the CLI.

Fake-world cells run in subprocesses, so that no default process group
leaks into other tests on the same worker.

The reference's cell (tests/test_dist_multidevice.py's
``test_dryrun_cell_on_virtual_devices``: qwen2.5-14b smoke, a train step
of B8 S64 on data 2 × model 4, ZeRO from 4096 elements): the port counts
150,994,944 flops a rank, exactly its Megatron layout's (6 · 256 tokens ·
90,112 per-rank matmul parameters, and the attention's 4 · t · s · d a
head, three times); the reference's HLO counts 176,160,768. The gap,
14.3%, is the reference's vocab-parallel cross-entropy, whose head GEMMs
(forward and two backward) run on the tokens of both data shards
(512, not 256) on every device: 3 · 2 · 256 · d 128 · V/tp 128 =
25,165,824 flops. So the per-device flops are held within REF_FLOPS_RTOL
(0.15), and the gap to exactly that head term.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import jax.numpy as jnp
import pytest
import torch

from repro.config import SHAPES as J_SHAPES
from repro.config import shape_applicable as j_applicable
from repro.configs import ASSIGNED as J_ASSIGNED
from repro.configs import get_config as jget
from repro.launch import specs as jsp
from repro_torch.config import SHAPES, shape_applicable
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.dist import sharding as shd
from repro_torch.launch import specs as sp
from repro_torch.train.tree import tree_leaves

REF_FLOPS_RTOL = 0.15
_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# (pod, multipod) data shards of the production meshes, model axis 16
SPLITS = [(16, 16), (32, 16)]
CELLS = [(a, s) for a in ASSIGNED for s in SHAPES]
APPLICABLE = [(a, s) for a, s in CELLS
              if shape_applicable(get_config(a), SHAPES[s])[0]]


def test_shapes_and_assigned_match_reference():
    assert ASSIGNED == J_ASSIGNED
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in J_SHAPES.items()}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_shape_applicable_matches_reference(arch, shape):
    assert shape_applicable(get_config(arch), SHAPES[shape]) == \
        j_applicable(jget(arch), J_SHAPES[shape])


def _heads(c):
    return (c.num_heads, c.num_kv_heads, c.resolved_head_dim, c.head_dim)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_run_config_matches_reference(arch, shape):
    cfg, jcfg = get_config(arch), jget(arch)
    sh, jsh = SHAPES[shape], J_SHAPES[shape]
    for tp in (4, 8, 16):
        assert _heads(sp.pad_attention_heads(cfg, tp)) == \
            _heads(jsp.pad_attention_heads(jcfg, tp))
    for data, model in SPLITS:
        assert sp.microbatches_for(sh, data) == jsp.microbatches_for(jsh,
                                                                     data)
        assert sp.microbatches_for(sh, data, cfg=cfg, tp=model) == \
            jsp.microbatches_for(jsh, data, cfg=jcfg, tp=model)
        rc = sp.run_config_for(cfg, sh, data_shards=data, model_shards=model)
        jrc = jsp.run_config_for(jcfg, jsh, data_shards=data,
                                 model_shards=model)
        for f in ("name", "param_dtype", "parallel", "dtype"):
            assert getattr(rc.model, f) == getattr(jrc.model, f), f
        assert dataclasses.asdict(rc.train) == dataclasses.asdict(jrc.train)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    dt = (str(tree.dtype).replace("torch.", "")
          if isinstance(tree, torch.Tensor) else str(jnp.dtype(tree.dtype)))
    return tuple(tree.shape), dt


@pytest.mark.parametrize("arch,shape", APPLICABLE)
def test_input_specs_match_reference(arch, shape):
    cfg, sh = get_config(arch), SHAPES[shape]
    jcfg, jsh = jget(arch), J_SHAPES[shape]
    if sh.kind == "train":
        got = sp.train_input_specs(cfg, sh)
        want = jsp.train_input_specs(jcfg, jsh)
    else:
        got = dict(zip(("tokens", "cache"), sp.serve_input_specs(cfg, sh)))
        want = dict(zip(("tokens", "cache"),
                        jsp.serve_input_specs(jcfg, jsh)))
    assert all(t.device.type == "meta" for t in tree_leaves(got))
    assert _shapes(got) == _shapes(want)


# ---------------------------------------------------------------------------
# cells in subprocesses
# ---------------------------------------------------------------------------

_REF_CELL = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
sys.path.insert(0, sys.argv[1])
import jax
from jax.sharding import PartitionSpec as P
from repro.config import ShapeSpec
from repro.configs import get_config
from repro.dist import sharding as shd
from repro.dist.mesh_ctx import use_mesh
from repro.launch import specs as sp
from repro.launch.mesh import make_smoke_mesh
from repro.roofline.hlo import analyze_hlo_text
from repro.train.loop import make_train_step
mesh = make_smoke_mesh(data=2, model=4)
cfg = get_config("qwen2.5-14b", smoke=True)
shape = ShapeSpec("t", 64, 8, "train")
with use_mesh(mesh):
    rc = sp.run_config_for(cfg, shape)
    state_sds, state_spec = sp.train_state_specs(rc, mesh, fsdp=1 << 12)
    state_sh = shd.named_sharding_tree(state_spec, mesh)
    batch_sds = sp.train_input_specs(rc.model, shape)
    bspecs = shd.batch_specs(rc.model, mesh, 8, 64)
    batch_sh = shd.named_sharding_tree(
        {k: bspecs.get(k, P()) for k in batch_sds}, mesh)
    compiled = jax.jit(make_train_step(rc), in_shardings=(state_sh, batch_sh),
                       out_shardings=(state_sh, None),
                       donate_argnums=(0,)).lower(state_sds,
                                                  batch_sds).compile()
st = analyze_hlo_text(compiled.as_text())
print("JSON::" + json.dumps({"flops": st.flops,
                             "coll": sum(st.collective_bytes.values())}))
"""

_PORT_CELL = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.config import ShapeSpec
from repro_torch.configs import get_config
from repro_torch.dist.mesh_ctx import make_smoke_mesh, use_mesh
from repro_torch.launch import specs as sp
from repro_torch.roofline.counts import count_step
from repro_torch.train.loop import (make_train_step, plan_mesh, rank_batch,
                                    shard_state)
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = make_smoke_mesh(data=2, model=4, backend="fake")
cfg = get_config("qwen2.5-14b", smoke=True)
shape = ShapeSpec("t", 64, 8, "train")
with use_mesh(mesh):
    rc = sp.run_config_for(cfg, shape)
    whole, spec = sp.train_state_specs(rc, mesh, fsdp=1 << 12)
    plan = plan_mesh(whole.params, rc, mesh, fsdp_min_shard_elems=1 << 12)
    plan.opt_specs = spec.opt_state
    state = shard_state(whole, plan, sp.META)
    batch = rank_batch(sp.train_input_specs(rc.model, shape), plan,
                       rc.train.microbatches)
    _, st = count_step(make_train_step(rc, plan=plan), state, batch)
print("JSON::" + json.dumps({"flops": st.flops,
                             "coll": st.total_collective_bytes}))
dist.destroy_process_group()
"""


def _start(argv):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, *argv], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _json(p, timeout=300):
    out, err = p.communicate(timeout=timeout)
    assert p.returncode == 0, err[-3000:]
    line = next(x for x in out.splitlines() if x.startswith("JSON::"))
    return json.loads(line[len("JSON::"):])


@pytest.fixture(scope="module")
def cells():
    """The three subprocesses, started together: the reference's cell, the
    port's, and the CLI's full-size olmo-1b decode_32k pod --packed."""
    tmp = tempfile.TemporaryDirectory()
    procs = {
        "ref": _start(["-c", _REF_CELL, _SRC]),
        "port": _start(["-c", _PORT_CELL, _SRC]),
        "cli": _start(["-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                       "from repro_torch.launch.dryrun import main; "
                       "sys.exit(main(sys.argv[2:]))", _SRC,
                       "--arch", "olmo-1b", "--shape", "decode_32k",
                       "--mesh", "pod", "--packed", "--out", tmp.name])}
    try:
        out = {"ref": _json(procs["ref"]), "port": _json(procs["port"])}
        _, err = procs["cli"].communicate(timeout=300)
        assert procs["cli"].returncode == 0, err[-3000:]
        with open(os.path.join(tmp.name,
                               "olmo-1b__decode_32k__pod__dbb.json")) as f:
            out["cli"] = json.load(f)
        yield out
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        tmp.cleanup()


def test_reference_cell_flops_agree(cells):
    ref, port = cells["ref"], cells["port"]
    assert abs(port["flops"] - ref["flops"]) <= REF_FLOPS_RTOL * ref["flops"]
    cfg = get_config("qwen2.5-14b", smoke=True)
    data, tp, tokens = 2, 4, 8 * 64
    head = 3 * 2 * (data - 1) * (tokens // data) * cfg.d_model \
        * (cfg.vocab_size // tp)
    assert ref["flops"] - port["flops"] == head
    assert ref["coll"] > 0 and port["coll"] > 0


@dataclasses.dataclass
class _Mesh:
    """What the spec functions read of a mesh: its axis sizes and names."""
    shape: dict
    axis_names: tuple


def _shard_bytes(tree, specs, mesh) -> int:
    """Bytes of one rank's shard of ``tree`` under the spec tree: each leaf
    over the product of its spec's axis sizes."""
    spec_of = dict(shd._flatten(specs))
    total = 0
    for names, t in shd._flatten(tree):
        spec = spec_of[names]
        n = 1
        for e in tuple(spec):
            for a in (e,) if isinstance(e, str) else tuple(e or ()):
                n *= mesh.shape[a]
        total += t.numel() * t.element_size() // n
    return total


def test_full_size_cell_argument_bytes(cells):
    rec = cells["cli"]
    assert rec["status"] == "ok" and rec["tp_wrap"] == "on"
    mesh = _Mesh({"data": 16, "model": 16}, ("data", "model"))
    cfg = get_config("olmo-1b").replace(gemm_impl="pallas")
    shape = SHAPES["decode_32k"]
    params = sp.serve_params(cfg, packed=True)
    pspec = shd.param_specs(params, mesh, cfg, fsdp_min_shard_elems=None)
    # the engine's contiguous f32 head: the tied table's vocab slice
    head = cfg.d_model * (cfg.vocab_size // 16) * 4
    cell = sp.input_specs(cfg, shape, mesh)
    # every cache leaf's rows over data (16), the K / V heads over model
    # (16) too
    assert cell["specs"]["cache"]["k"] == shd.Spec(None, "data", None, None,
                                                   None)
    assert shd.serve_cache_specs(cell["cache"], mesh)["k"] == shd.Spec(
        None, None, None, "model", None)
    nbytes = {k: t.numel() * t.element_size()
              for k, t in cell["cache"].items()}
    kv = nbytes["k"] + nbytes["v"]
    cache = kv // 256 + sum(b // 16 for k, b in nbytes.items()
                            if k not in ("k", "v"))
    tokens = shape.global_batch // 16 * 4
    want = _shard_bytes(params, pspec, mesh) + head + cache + tokens
    assert rec["memory"]["argument_size_in_bytes"] == want
    assert rec["memory"]["alias_size_in_bytes"] == kv // 256
    rf = rec["roofline"]
    assert rf["bottleneck"] == "memory" and rf["step_time_lb"] > 0
    assert rec["hlo_stats"]["collective_bytes"]["all-reduce"] > 0
