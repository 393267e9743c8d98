"""The port's public surface against the JAX package's.

Both packages are read with ``ast``; neither is imported (importing the
reference starts XLA).  For every public module-level function and
class, and every public method (``__init__`` included) of a public
class, in ``src/repro``, the module at the same path in
``src/repro_torch`` must define the name or import it (the import is
followed to the defining module); the counterpart must accept every
parameter name the reference's takes, or take ``**kwargs``; and every
default it shares with the reference must equal the reference's.  The
deliberate differences are the table below, one entry each, and every
entry must excuse at least one difference.
"""

from __future__ import annotations

import ast
import fnmatch
import functools
import pathlib
from typing import NamedTuple, Optional

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
REF, PORT = "repro", "repro_torch"


class Deliberate(NamedTuple):
    """One deliberate difference.  ``module`` and ``name`` are fnmatch
    patterns, split by spaces, over the reference's module path and
    (dotted) name; ``kind`` (split by spaces too) is "missing" (no
    counterpart), "param" (the counterpart lacks a parameter of
    ``param``, names split by spaces), "default" (the default of
    ``param`` differs) or "moved" (the counterpart is defined in
    ``where``)."""
    module: str
    name: str
    kind: str
    param: Optional[str]
    reason: str
    where: Optional[str] = None


DELIBERATE = (
    Deliberate("models/model.py train/compression.py", "init_* "
               "quantize_stochastic compressed_psum_leaf", "param", "key",
               "JAX's PRNG key is a torch.Generator, named generator"),
    Deliberate("train/compression.py", "compressed_psum_leaf", "param",
               "g axis", "it runs outside shard_map, so it takes the stacked "
               "gs in place of g and the mesh axis"),
    Deliberate("kernels/*.py", "*_pallas", "missing", None,
               "the port names each kernel entry after its op; there is "
               "no Pallas"),
    Deliberate("roofline/hlo_parse.py", "*", "missing", None,
               "PyTorch emits no HLO: roofline/graph_parse.py and "
               "roofline/trace.py read the traced FX graph"),
    Deliberate("*", "*", "default", "backend",
               "the port's backends are 'kernel' and 'ref'; 'pallas' and "
               "'jit' are refused"),
    Deliberate("store/reader.py", "*_store_uri", "moved", None,
               "the URI helpers import no torch; reader.py re-exports "
               "them, as in the reference", where="store/uri.py"),
    Deliberate("kernels/segment_pipeline.py", "process_segments",
               "param default", "use_pallas", "refused with TypeError "
               "naming use_kernels: the port has no Pallas"),
)


def _modules() -> list[str]:
    return sorted(str(p.relative_to(SRC / REF))
                  for p in (SRC / REF).rglob("*.py"))


@functools.lru_cache(maxsize=None)
def _tree(pkg: str, module: str) -> Optional[ast.Module]:
    path = SRC / pkg / module
    return ast.parse(path.read_text()) if path.exists() else None


def _public(tree: ast.Module) -> dict:
    """Dotted public name -> FunctionDef or ClassDef."""
    out = {}
    funcs = (ast.FunctionDef, ast.AsyncFunctionDef)
    for node in tree.body:
        if not isinstance(node, funcs + (ast.ClassDef,)) \
                or node.name.startswith("_"):
            continue
        out[node.name] = node
        if isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, funcs) and (not m.name.startswith("_")
                                             or m.name == "__init__"):
                    out[f"{node.name}.{m.name}"] = m
    return out


def _imports(tree: ast.Module) -> dict:
    """Name bound by ``from repro_torch... import`` -> (module path,
    name there)."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module and node.module.split(".")[0] == PORT:
            path = "/".join(node.module.split(".")[1:]) + ".py"
            for a in node.names:
                out[a.asname or a.name] = (path, a.name)
    return out


def _resolve(module: str, name: str, depth: int = 0):
    """(defining module path, node) of ``name`` as the port's
    ``module`` binds it, or (None, None)."""
    tree = _tree(PORT, module)
    if tree is None or depth > 4:
        return None, None
    public = _public(tree)
    if name in public:
        return module, public[name]
    top, _, rest = name.partition(".")
    imported = _imports(tree).get(top)
    if imported is None:
        return None, None
    there, orig = imported
    return _resolve(there, orig + ("." + rest if rest else ""), depth + 1)


def _signature(fn) -> tuple[list, dict, bool]:
    """(parameter names, name -> default source, takes **kwargs)."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = {arg.arg: ast.unparse(d) for arg, d in
                zip(pos[len(pos) - len(a.defaults):], a.defaults)}
    defaults.update({arg.arg: ast.unparse(d) for arg, d in
                     zip(a.kwonlyargs, a.kw_defaults) if d is not None})
    return ([x.arg for x in pos + a.kwonlyargs], defaults,
            a.kwarg is not None)


def _differences(module: str) -> list[tuple]:
    """Every difference of the port's ``module`` from the reference's:
    (module, name, kind, param, detail)."""
    ref = _public(_tree(REF, module))
    out = []
    for name, node in ref.items():
        where, got = _resolve(module, name)
        if got is None:
            out.append((module, name, "missing", None, "no counterpart"))
            continue
        if where != module and "." not in name:
            out.append((module, name, "moved", None, f"defined in {where}"))
        if isinstance(node, ast.ClassDef):
            continue
        want_names, want_defaults, _ = _signature(node)
        got_names, got_defaults, kwargs = _signature(got)
        for p in want_names:
            if p not in got_names and not kwargs:
                out.append((module, name, "param", p,
                            f"takes no {p}= (the reference does)"))
        for p, want in want_defaults.items():
            if p in got_names and got_defaults.get(p) != want:
                out.append((module, name, "default", p,
                            f"{p}={got_defaults.get(p)} where the "
                            f"reference has {p}={want}"))
    return out


def _matches(value: str, patterns: str) -> bool:
    return any(fnmatch.fnmatch(value, p) for p in patterns.split())


def _excused(diff: tuple) -> Optional[Deliberate]:
    module, name, kind, param, detail = diff
    for d in DELIBERATE:
        if (kind in d.kind.split() and _matches(module, d.module)
                and _matches(name, d.name)
                and (d.param is None or param in d.param.split())
                and (d.where is None or detail == f"defined in {d.where}")):
            return d
    return None


@pytest.mark.parametrize("module", _modules())
def test_port_module_offers_the_reference_surface(module):
    """The port's module takes every call the reference's takes, but for
    the deliberate differences."""
    faults = [f"{m}:{name}: {detail}"
              for m, name, kind, param, detail in _differences(module)
              if _excused((m, name, kind, param, detail)) is None]
    assert not faults, "\n".join(faults)


def test_every_deliberate_difference_is_used():
    """The table holds no stale entry: each excuses a difference that
    exists, and each gives its reason."""
    used = {_excused(d) for m in _modules() for d in _differences(m)}
    assert all(d.reason for d in DELIBERATE)
    assert not [d for d in DELIBERATE if d not in used]
