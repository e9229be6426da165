"""What the harness may import and read: nothing of JAX or the JAX package
(top-level names compared whole, since the port's name begins with the JAX
package's), the reference nothing of the program, and no file of the older
TPU benchmarks."""

from __future__ import annotations

import ast
import os

import pytest

from portbench.tests.conftest import ROOT

PB = os.path.join(ROOT, "portbench")
SOURCES = sorted(os.path.join(d, f) for d, _, fs in os.walk(PB) for f in fs
                 if f.endswith(".py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "ark_tpu"}


def imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=[os.path.relpath(p, PB) for p in SOURCES])
def test_no_jax(path):
    assert not imported_roots(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES if os.sep + "reference" + os.sep in p],
                         ids=lambda p: os.path.basename(p))
def test_reference_imports_nothing_of_the_program(path):
    assert "ark_tpu_torch" not in imported_roots(path)


def strings(path):
    """String constants of a module other than docstrings."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    docs = {id(n.value) for n in ast.walk(tree) if isinstance(n, ast.Expr)
            and isinstance(n.value, ast.Constant)}
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


@pytest.mark.parametrize("path", [p for p in SOURCES if "tests" not in p],
                         ids=lambda p: os.path.relpath(p, PB))
def test_reads_no_older_benchmark(path):
    assert not imported_roots(path) & {"chip_smoke", "bench", "benchmarks"}
    for text in strings(path):
        for name in ("chip_smoke", "bench.py", "benchmarks", "BENCH_r"):
            assert name not in text


def test_the_check_compares_whole_names():
    import sys
    import types

    from portbench import run

    fake = types.ModuleType("fake")
    names = ["ark_tpu_torch_lookalike", "jaxlike.sub", "flaxen"]
    for n in names:
        sys.modules[n] = fake
    try:
        assert not set(run.forbidden_modules()) & {"ark_tpu", "jax", "flax"} or \
            {m.split(".")[0] for m in sys.modules if m not in names} & FORBIDDEN
        sys.modules["jax.numpy_lookalike"] = fake
        assert "jax" in run.forbidden_modules()
    finally:
        for n in names + ["jax.numpy_lookalike"]:
            sys.modules.pop(n, None)
