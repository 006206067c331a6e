"""The port's serve CLI (`repro_torch.launch.serve`) against the
reference's (`repro.launch.serve`) on the smoke configs, on the CPU: its
flags and defaults, its prompts, the routes its tables choose, its streams
against direct `ServeEngine` calls on the same tree, its two SystemExits,
and the layer-by-layer tree builder it serves from
(`registry.init_params_by_layer`)."""
import argparse
import dataclasses
import re

import pytest
import torch

import repro.launch.serve as jserve
from repro_torch.configs import get_config as tget
from repro_torch.core.dbb import DbbWeight
from repro_torch.core.dbb_linear import iter_leaves, pack_tree
from repro_torch.core.sparsity import apply_dbb_to_tree
from repro_torch.launch import serve as tserve
from repro_torch.models.registry import init_params_by_layer
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.sampling import SamplingParams


class _Captured(Exception):
    pass


def _reference_parser(monkeypatch) -> argparse.ArgumentParser:
    """The parser the reference's ``main`` builds, caught at parse time."""
    seen = {}

    def catch(self, argv=None, namespace=None):
        seen["parser"] = self
        raise _Captured
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Captured):
        jserve.main(["--arch", "olmo-1b"])
    monkeypatch.undo()
    return seen["parser"]


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices,
                     a.required, a.nargs, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


def test_parser_takes_the_reference_flags_and_defaults(monkeypatch):
    want = _options(_reference_parser(monkeypatch))
    got = _options(tserve.build_parser())
    extra = got.pop("gemm_impl")
    assert got == want
    assert extra[:4] == (("--gemm-impl",), None, None, ["xla", "pallas"])
    args = tserve.build_parser().parse_args(["--arch", "yi-34b", "--full"])
    assert not args.smoke and args.batch == 4 and args.prompt_len == 16


class _FakeEngine:
    """Stands in for the reference's engine: records the prompts."""
    seen = {}

    def __init__(self, cfg, params, **kw):
        _FakeEngine.seen["kw"] = kw

    def _run(self, prompts, max_new_tokens=16, sampling=None):
        _FakeEngine.seen["prompts"] = [[int(t) for t in p] for p in prompts]
        return [[0] for _ in prompts]
    generate = serve = _run


def _reference_run(monkeypatch, capsys, argv):
    """The reference CLI on ``argv`` with its engine faked and its config
    on the kernel route family (what the port's --gemm-impl pallas sets):
    (its prompts, its stdout)."""
    real = jserve.get_config
    monkeypatch.setattr(jserve, "ServeEngine", _FakeEngine)
    monkeypatch.setattr(jserve, "get_config", lambda arch, smoke: real(
        arch, smoke=smoke).replace(gemm_impl="pallas"))
    capsys.readouterr()
    assert jserve.main(argv) == 0
    return _FakeEngine.seen["prompts"], capsys.readouterr().out


def _port_run(capsys, argv):
    rep = {}
    capsys.readouterr()
    assert tserve.main(argv + ["--gemm-impl", "pallas"], device="cpu",
                       report=rep) == 0
    return rep, capsys.readouterr().out


def _chosen(out: str):
    """{table title: chosen route} of a route-table log."""
    chosen, title = {}, None
    for line in out.splitlines():
        m = re.match(r"- decode attention \(.*\): (\S+)$", line)
        if m:
            chosen["decode attention"] = m.group(1)
        elif line.startswith("- "):
            title = re.match(r"- ([A-Za-z ]+[A-Za-z])", line).group(1)
        elif title and line.split()[1:2] in (["y*"], ["yf"]):
            chosen[title] = line.split()[0]
    return chosen


RUNS = {
    "generate": ["--batch", "4", "--prompt-len", "8", "--max-new", "6"],
    "serve": ["--batch", "4", "--requests", "7", "--prompt-len", "8",
              "--max-new", "6"],
    "paged": ["--batch", "4", "--requests", "7", "--prompt-len", "8",
              "--max-new", "6", "--kv-page-size", "8"],
    "sampled": ["--batch", "4", "--requests", "7", "--prompt-len", "8",
                "--max-new", "6", "--temperature", "0.8", "--seed", "3"],
    "top_k": ["--batch", "4", "--prompt-len", "8", "--max-new", "6",
              "--temperature", "0.8", "--top-k", "5"],
    "draft": ["--batch", "4", "--prompt-len", "8", "--max-new", "6",
              "--temperature", "0.8", "--draft-k", "2"],
}


@pytest.mark.parametrize("run", sorted(RUNS))
@pytest.mark.parametrize("arch", ["olmo-1b", "yi-34b"])
def test_prompts_and_routes_match_reference(monkeypatch, capsys, arch, run):
    """With ``--packed --weight-bits 4``: the prompts are the reference's
    draws, list for list, and every printed table chooses the reference's
    route. A ``generate`` run's prefill table is the padded one (its
    prefill is padded), held against the reference's padded table."""
    argv = ["--arch", arch, "--packed", "--weight-bits", "4"] + RUNS[run]
    jprompts, jout = _reference_run(monkeypatch, capsys, argv)
    rep, tout = _port_run(capsys, argv)
    assert rep["prompts"] == jprompts
    got, want = _chosen(tout), _chosen(jout)
    if "--requests" not in argv:
        assert "prefill attention" in want
        cfg = jserve.get_config(arch, smoke=True)
        cfg = cfg.replace(dbb=dataclasses.replace(cfg.dbb, weight_bits=4))
        jserve._log_routes(cfg, 4, 14, packed=True,
                           sampling_on="--temperature" in argv,
                           use_tt="--top-k" in argv)
        want["prefill attention"] = _chosen(
            capsys.readouterr().out)["prefill attention"]
    assert got == want
    assert got["decode layer GEMM"] == "skinny_dbb_w4"
    assert rep["routes"]["matmul"] == "skinny_dbb_w4"


def _direct(cfg, run, prompts, seed, packed):
    """The streams of the ServeEngine call a CLI run makes, made directly on
    the tree the builder gives for ``seed``."""
    tree = init_params_by_layer(cfg, seed=seed, device="cpu", pack=packed)
    kw = dict(max_batch=4, device="cpu",
              draft_k=2 if run == "draft" else 0)
    sampling = None
    if run in ("sampled", "draft", "top_k"):
        sampling = [SamplingParams(temperature=0.8,
                                   top_k=5 if run == "top_k" else 0,
                                   seed=seed + i)
                    for i in range(len(prompts))]
    eng = ServeEngine(cfg, tree, **kw)
    if len(prompts) > 4:
        return eng.serve(prompts, max_new_tokens=6, sampling=sampling)
    return eng.generate(prompts, max_new_tokens=6, sampling=sampling)


@pytest.mark.parametrize("run", sorted(RUNS))
@pytest.mark.parametrize("arch,packed", [("olmo-1b", True),
                                         ("olmo-1b", False),
                                         ("yi-34b", True)])
def test_streams_equal_direct_engine_calls(capsys, arch, packed, run):
    argv = ["--arch", arch] + (["--packed"] if packed else []) + RUNS[run]
    rep, out = _port_run(capsys, argv)
    cfg = tget(arch, smoke=True).replace(gemm_impl="pallas")
    if run == "paged":
        cfg = cfg.replace(kv_page_size=8)
    seed = 3 if run == "sampled" else 0
    want = _direct(cfg, run, rep["prompts"], seed, packed)
    assert rep["outs"] == want
    printed = [line for line in out.splitlines() if line.startswith("req")]
    assert printed == [f"req{i}: {o}" for i, o in enumerate(want)]
    assert rep["cfg"] == cfg and rep["tree_bytes"] > 0


def test_system_exits():
    with pytest.raises(SystemExit, match="kv-pool-pages"):
        tserve.main(["--arch", "olmo-1b", "--kv-pool-pages", "4"],
                    device="cpu")
    with pytest.raises(SystemExit, match="token-decoder serving only"):
        tserve.main(["--arch", "convnet-dbb"], device="cpu")


def test_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--arch", "olmo-1b"])


def _leaves_equal(a, b):
    la, lb = list(iter_leaves(a)), list(iter_leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert type(x) is type(y)
        if isinstance(x, DbbWeight):
            for f in dataclasses.fields(x):
                u, v = getattr(x, f.name), getattr(y, f.name)
                if isinstance(u, torch.Tensor):
                    assert u.dtype == v.dtype and torch.equal(u, v), f.name
                else:
                    assert u == v, f.name
        else:
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("arch", ["olmo-1b", "starcoder2-15b", "qwen2.5-14b",
                                  "yi-34b"])
def test_layer_builder_packs_as_pack_tree(arch, bits):
    """``pack=True`` is bit-equal to ``pack_tree(apply_dbb_to_tree(...))``
    of the ``pack=False`` tree of the same seed, f32 and w4 planes."""
    cfg = tget(arch, smoke=True)
    cfg = cfg.replace(dbb=dataclasses.replace(cfg.dbb, weight_bits=bits,
                                              quant_group=32))
    dense = init_params_by_layer(cfg, seed=5, device="cpu")
    packed = init_params_by_layer(cfg, seed=5, device="cpu", pack=True)
    _leaves_equal(packed, pack_tree(apply_dbb_to_tree(dense, cfg.dbb),
                                    cfg.dbb))
    w = packed["layers"]["mlp"]["wi"]["w"]
    assert isinstance(w, DbbWeight) and w.bits == bits
    assert ("lm_head" in packed) == (not cfg.tie_embeddings)


def test_layer_builder_hook_and_outer():
    """The hook sees each layer and the final norm with the generator that
    drew them; ``outer`` is taken as given; each layer has its own seed."""
    cfg = tget("qwen2.5-14b", smoke=True)
    seen = []

    def hook(tree, gen):
        seen.append(sorted(tree))
        return {k: v if k != "scale" else v + 1.0 for k, v in tree.items()}
    a = init_params_by_layer(cfg, seed=1, device="cpu", layer_hook=hook)
    assert seen == [["attn", "ln_attn", "ln_mlp", "mlp"]] * cfg.num_layers \
        + [["scale"]]
    assert torch.equal(a["final_norm"]["scale"],
                       torch.full((cfg.d_model,), 2.0))
    outer = {k: v for k, v in a.items() if k != "layers"}
    b = init_params_by_layer(cfg.replace(num_layers=1), seed=1,
                             device="cpu", outer=outer)
    assert b["embed"] is a["embed"]
    assert torch.equal(b["layers"]["mlp"]["wi"]["w"][0],
                       init_params_by_layer(cfg, seed=1, device="cpu")[
                           "layers"]["mlp"]["wi"]["w"][0])
    w = a["layers"]["mlp"]["wi"]["w"]
    assert not torch.equal(w[0], w[1])
