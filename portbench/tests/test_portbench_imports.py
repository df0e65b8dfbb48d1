"""Nothing the benchmark runs imports JAX, a JAX library or the JAX
package (top-level names compared whole: `jen1_tpu_torch` is the port),
and the plain reference imports nothing of the program."""

from __future__ import annotations

import ast
from pathlib import Path

from portbench.harness import core
from portbench.harness.registry import ROOT


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _closure(start: Path):
    """The benchmark's files reachable by import from `start`, with every
    module name they import."""
    seen, todo, names = set(), [start], set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in _imports(path):
            names.add(name)
            if name.split(".")[0] == "portbench":
                base = ROOT.parent.joinpath(*name.split("."))
                for cand in (base.with_suffix(".py"), base / "__init__.py"):
                    if cand.is_file():
                        todo.append(cand)
    return seen, names


def test_nothing_the_benchmark_runs_imports_jax():
    files = [ROOT / "run.py", *ROOT.glob("drivers/*.py"), *ROOT.glob("metrics/*.py"),
             *ROOT.glob("checks/*.py")]
    for start in files:
        _, names = _closure(start)
        assert not core.forbidden_modules(names), (start, names)


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "reference").glob("*.py"):
        names = set(_imports(path))
        tops = {n.split(".")[0] for n in names}
        assert not core.forbidden_modules(names)
        assert not tops & {"jen1_tpu_torch", "portbench"}, (path, tops)


def test_forbidden_names_are_compared_whole():
    assert core.forbidden_modules(["jen1_tpu_torch.api", "jaxtyping", "numpy"]) == []
    assert core.forbidden_modules(["jen1_tpu.models", "jax.numpy", "flax"]) == [
        "flax", "jax", "jen1_tpu"]
