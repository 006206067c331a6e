"""Repo-wide import-layering pass: the reference's two rules
(``repro.analysis.layering.DEFAULT_RULES``) mapped ``repro`` →
``repro_torch``, over all of ``src/repro_torch``.

  * **kernels stay at the bottom**: ``repro_torch.kernels.*`` must not
    import the upper layers (``models`` / ``serve`` / ``train`` /
    ``launch`` / ``data``). One documented exception, the reference's:
    ``kernels/dispatch.py``'s attention front doors delegate the plain
    implementations back to ``models.attention``.
  * **kernel internals go through the front doors**: outside ``kernels/``
    (and this analysis package), the kernel subsystem packages
    (``sta_gemm`` / ``dbb_gemm`` / ``skinny`` / ``conv_gemm`` / ``attn`` /
    ``epilogue``) are private; the model and serving layers import the
    ``repro_torch.kernels`` root, ``dispatch``, ``common``, ``build`` or
    ``sample``. The reference's named exceptions carry over: the
    attention and conv model layers and the serving engine and CLI reach
    named ``attn`` / ``conv_gemm.ref`` helpers (wrappers and plain
    versions, not kernels).

The banned list is the reference's, so ``kernels.sample`` stays allowed as
it is there; the port's extra edges into it (``serve/engine.py`` and
``serve/sampling/ops.py`` → ``kernels.sample.ref``, the sampling math the
plain head shares with the fused one) need no entry. Only genuine
``import`` / ``from`` statements count.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Sequence, Tuple

from repro_torch.analysis.contracts import Violation

__all__ = ["check", "LayerRule", "DEFAULT_RULES"]

_IMPORT_RE = re.compile(
    r"^\s*(?:from\s+(?P<from>[\w.]+)\s+import|import\s+(?P<mod>[\w.]+))")


class LayerRule:
    """One layering rule: files under ``scope`` must not import modules
    matching ``banned`` (regex on the dotted module path), except the
    (file-suffix → allowed-module-prefixes) pairs in ``allow``."""

    def __init__(self, name: str, scope: str, banned: str,
                 allow: Dict[str, Sequence[str]] = (), describe: str = ""):
        self.name = name
        self.scope = scope
        self.banned = re.compile(banned)
        self.allow = dict(allow or {})
        self.describe = describe

    def allowed(self, rel: str, module: str) -> bool:
        for pat, prefixes in self.allow.items():
            # trailing-separator patterns match whole directories,
            # otherwise match the file path suffix
            hit = (rel.startswith(pat) if pat.endswith(os.sep)
                   else rel.endswith(pat))
            if hit and any(module == p or module.startswith(p + ".")
                           for p in prefixes):
                return True
        return False


DEFAULT_RULES = (
    LayerRule(
        name="kernels-no-upper-layers",
        scope=os.path.join("repro_torch", "kernels"),
        banned=r"^repro_torch\.(models|serve|train|launch|data)(\.|$)",
        allow={
            # dispatch front doors delegate attention impls to the model
            # layer — the one sanctioned upward edge
            os.path.join("kernels", "dispatch.py"): ("repro_torch.models",),
        },
        describe="kernels/ never imports models/ serve/ train/ launch/ "
                 "data/"),
    LayerRule(
        name="kernel-internals-private",
        scope="repro_torch",
        banned=r"^repro_torch\.kernels\.(sta_gemm|dbb_gemm|skinny|conv_gemm"
               r"|attn|epilogue)(\.|$)",
        allow={
            # kernels may use their own internals, and the analysis
            # package reads the wrappers' pure functions by design
            os.path.join("repro_torch", "kernels") + os.sep:
                ("repro_torch.kernels",),
            os.path.join("repro_torch", "analysis") + os.sep:
                ("repro_torch.kernels",),
            # sanctioned named helpers (wrappers / plain versions)
            os.path.join("models", "attention.py"):
                ("repro_torch.kernels.attn",),
            os.path.join("models", "transformer.py"):
                ("repro_torch.kernels.attn.ref",),
            os.path.join("models", "cnn.py"):
                ("repro_torch.kernels.conv_gemm.ref",),
            # the engine sizes its page pool by the decode kernel's guard
            # (attn.ops.PAGE_MIN, paged_decode_ok)
            os.path.join("serve", "engine.py"): ("repro_torch.kernels.attn",),
            # the CLI reads the default KV page (attn.ops.DEFAULT_PAGE)
            os.path.join("launch", "serve.py"): ("repro_torch.kernels.attn",),
        },
        describe="kernel subsystem packages are private — go through "
                 "repro_torch.kernels / dispatch / common"),
)


def _scan_imports(path: str) -> List[Tuple[int, str]]:
    """(lineno, dotted module) for every import statement in the file."""
    out = []
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            m = _IMPORT_RE.match(line)
            if m:
                out.append((lineno, m.group("from") or m.group("mod")))
    return out


def check(src_root: str, rules: Sequence[LayerRule] = DEFAULT_RULES
          ) -> Tuple[int, List[Violation]]:
    """Scan ``src_root`` (the directory containing ``repro_torch/``)."""
    out: List[Violation] = []
    checked = 0
    for dirpath, _, files in os.walk(os.path.join(src_root, "repro_torch")):
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, src_root)
            checked += 1
            imports = None
            for rule in rules:
                if rule.scope and not rel.startswith(rule.scope + os.sep):
                    continue
                if imports is None:
                    imports = _scan_imports(path)
                for lineno, module in imports:
                    if not rule.banned.match(module):
                        continue
                    if rule.allowed(rel, module):
                        continue
                    out.append(Violation(
                        pass_name="layering", code=rule.name,
                        subject=f"{rel}:{lineno}",
                        message=f"imports {module} ({rule.describe})"))
    return checked, out
