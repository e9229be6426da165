"""Package rules of the PyTorch port (ark_tpu_torch).

The port never imports jax; its sources pass the repo's style gate; and a
BMU search on CPU tensors never builds or loads the CUDA library, while a
tensor on any other device never falls back to the plain version.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

from ark_tpu_torch.ops import _kernels, som
from tests.test_code_style import MAX_LEN

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ark_tpu_torch")


def _files(suffixes):
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(suffixes):
                yield os.path.join(root, f)


def _modules():
    for path in _files((".py",)):
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        yield rel[:-len(".__init__")] if rel.endswith(".__init__") else rel


def test_importing_every_module_leaves_jax_out():
    code = ("import importlib, sys\n"
            f"for m in {sorted(_modules())!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, sorted(\n"
            "    m for m in sys.modules if m.split('.')[0] == 'jax')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_jax_import_in_sources():
    offenders = []
    for path in _files((".py",)):
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                          for n in names if n.split(".")[0] == "jax"]
    assert not offenders, offenders


@pytest.mark.parametrize("suffixes", [(".py",), (".cu", ".cuh")])
def test_style_gate(suffixes):
    """tests/test_code_style.py's contract: lines of at most 99 columns, no
    tabs or trailing whitespace, exactly one final newline."""
    paths = list(_files(suffixes))
    assert paths
    problems = []
    for path in paths:
        rel = os.path.relpath(path, REPO)
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        if not text.endswith("\n") or text.endswith("\n\n"):
            problems.append(f"{rel}: must end with exactly one newline")
        for i, line in enumerate(text.splitlines(), 1):
            if len(line) > MAX_LEN:
                problems.append(f"{rel}:{i}: line length {len(line)}")
            if "\t" in line or line != line.rstrip():
                problems.append(f"{rel}:{i}: tab or trailing whitespace")
    assert not problems, "\n".join(problems)


def test_cpu_bmu_never_touches_the_cuda_library(monkeypatch):
    def refuse():
        raise AssertionError("bmu on CPU tensors asked for the CUDA library")

    monkeypatch.setattr(_kernels, "bmu_lib", refuse)
    monkeypatch.setattr(_kernels, "build_bmu", refuse)
    before = som.bmu.launches
    w = torch.rand(7, 5)
    x = torch.rand(33, 5)
    idx, dist = som.bmu(w, x)
    ref_idx, ref_dist = som.bmu_plain(w, x)
    assert torch.equal(idx, ref_idx) and torch.equal(dist, ref_dist)
    assert som.bmu.launches == before


def test_non_cpu_tensor_never_falls_back(monkeypatch):
    """A tensor off the CPU goes to the kernel or raises; on a device other
    than CUDA it raises before any library is built."""
    def refuse():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(_kernels, "bmu_lib", refuse)
    w = torch.empty(7, 5, device="meta")
    x = torch.empty(33, 5, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        som.bmu(w, x)
    with pytest.raises(ValueError, match="CUDA"):
        som.bmu(torch.rand(7, 5), x)
