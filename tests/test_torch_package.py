"""Package rules of the PyTorch port (ark_tpu_torch).

The port never imports jax, nor anything of the JAX package ``ark_tpu``
(whose ``__init__`` sets up jax's compilation cache); its sources pass the
repo's style gate; a kernel's wrapper on CPU tensors never builds or loads
the CUDA library, while a tensor on any other device never falls back to
the plain version; and the modules that run on the card import without the
host packages the card's machine may lack (imageio, sklearn, tqdm, h5py,
matplotlib, seaborn).
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
# host packages the card's machine may lack
CARD_MISSING = ("imageio", "sklearn", "tqdm", "h5py", "matplotlib", "seaborn")


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


def _imported_names(path):
    """(line, module) of every import in `path`, at any depth (inside
    functions too)."""
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.lineno, node.module or ""


def test_no_ark_tpu_import_in_sources():
    """No ``import ark_tpu`` or ``from ark_tpu[...] import`` anywhere in the
    port or in chip_smoke.py, inside functions included."""
    paths = list(_files((".py",))) + [os.path.join(REPO, "chip_smoke.py")]
    offenders = [f"{os.path.relpath(path, REPO)}:{line} {name}"
                 for path in paths for line, name in _imported_names(path)
                 if name.split(".")[0] == "ark_tpu"]
    assert not offenders, offenders


def test_port_and_smoke_load_nothing_of_ark_tpu():
    """Importing every port module and chip_smoke, with the host packages the
    card's machine may lack blocked, loads no ``ark_tpu`` module and leaves
    jax's compilation-cache variable unset (``ark_tpu/__init__.py`` sets
    it)."""
    code = ("import importlib, os, sys\n"
            f"for blocked in {CARD_MISSING!r}:\n"
            "    sys.modules[blocked] = None\n"
            f"for m in {sorted(_modules()) + ['chip_smoke']!r}:\n"
            "    importlib.import_module(m)\n"
            "loaded = [m for m in sys.modules\n"
            "          if m == 'ark_tpu' or m.startswith('ark_tpu.')]\n"
            "assert not loaded, loaded\n"
            "assert 'JAX_COMPILATION_CACHE_DIR' not in os.environ\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


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


SEGMENTATION_MODULES = {"ark_tpu_torch.ops.cc", "ark_tpu_torch.ops.morphology",
                        "ark_tpu_torch.ops.watershed", "ark_tpu_torch.models.unet",
                        "ark_tpu_torch.segmentation.mesmer",
                        "ark_tpu_torch.segmentation.synthetic",
                        "ark_tpu_torch.utils.deepcell_service_utils"}


def test_segmentation_modules_are_under_the_package_rules():
    """The no-jax import check and the style gate walk every module; the
    segmentation slice's modules are among them."""
    assert SEGMENTATION_MODULES <= set(_modules())


def test_ops_import_only_torch_numpy_and_the_stdlib():
    """Top-level imports of ark_tpu_torch.ops.*: torch, numpy, the stdlib
    and the port itself (host helpers import the port's native C++ kernels
    inside the function that calls them)."""
    allowed = {"torch", "numpy", "ark_tpu_torch", "__future__"}
    offenders = []
    for path in _files((".py",)):
        if os.sep + "ops" + os.sep not in path:
            continue
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), path)
        for node in tree.body:
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                          for n in names if n.split(".")[0] not in allowed
                          and n.split(".")[0] not in sys.stdlib_module_names]
    assert not offenders, offenders


def test_every_kernel_has_its_source():
    sources = {f[:-3] for f in os.listdir(os.path.join(PKG, "csrc"))
               if f.endswith(".cu")}
    assert set(_kernels.KERNELS) == sources == {"bmu", "watershed_claim",
                                                "segment_sum"}
    assert all(os.path.exists(_kernels.source(k)) for k in _kernels.KERNELS)


def test_cpu_claim_round_never_touches_the_cuda_library(monkeypatch):
    from ark_tpu_torch.ops import watershed

    def refuse(*_):
        raise AssertionError("claim_round on CPU tensors asked for the library")

    monkeypatch.setattr(_kernels, "lib", refuse)
    monkeypatch.setattr(_kernels, "build", refuse)
    before = watershed.claim_round.launches
    lab = torch.tensor([[[0, 3, -1], [0, 0, 2]]], dtype=torch.int32)
    q = torch.zeros_like(lab)
    new, changed = watershed.claim_round(lab, q, 0)
    assert new.tolist() == [[[3, 3, -1], [0, 2, 2]]] and int(changed) == 2
    assert watershed.claim_round.launches == before


SPATIAL_MODULES = [
    "ark_tpu_torch.utils.netcdf3", "ark_tpu_torch.ops.distances",
    "ark_tpu_torch.ops.kmeans", "ark_tpu_torch.analysis.spatial_analysis_utils",
    "ark_tpu_torch.analysis.spatial_enrichment",
    "ark_tpu_torch.analysis.neighborhood_analysis",
    "ark_tpu_torch.analysis.cell_neighborhood_stats",
]
QUANT_AND_CELL_MODULES = [
    "ark_tpu_torch.ops.segment_reduce", "ark_tpu_torch.ops.convex",
    "ark_tpu_torch.ops.relabel", "ark_tpu_torch.ops.morphology",
    "ark_tpu_torch.segmentation.signal_extraction",
    "ark_tpu_torch.segmentation.regionprops_extraction",
    "ark_tpu_torch.segmentation.segmentation_utils",
    "ark_tpu_torch.segmentation.marker_quantification",
    "ark_tpu_torch.phenotyping.cluster_helpers",
    "ark_tpu_torch.phenotyping.cell_cluster_utils",
    "ark_tpu_torch.phenotyping.cell_som_clustering",
    "ark_tpu_torch.phenotyping.cell_meta_clustering",
    "ark_tpu_torch.phenotyping.weighted_channel_comp",
]


def test_card_modules_import_without_imageio_and_sklearn():
    """The card's machine may lack imageio, sklearn, tqdm, h5py, matplotlib
    and seaborn; the quantification, cell-clustering and spatial modules
    import there, and the in-memory cell table and a spatial run (distance
    matrices to netCDF, neighbor counts, k-means, enrichment) work, with
    all six blocked."""
    code = ("import importlib, os, sys, tempfile\n"
            f"for blocked in {CARD_MISSING!r}:\n"
            "    sys.modules[blocked] = None\n"
            f"for m in {QUANT_AND_CELL_MODULES + SPATIAL_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "import numpy as np\n"
            "import pandas as pd\n"
            "from ark_tpu_torch.utils.labeled_array import DataArray\n"
            "from ark_tpu_torch.segmentation import marker_quantification as q\n"
            "from ark_tpu_torch.analysis import neighborhood_analysis as na\n"
            "from ark_tpu_torch.analysis import spatial_analysis_utils as sa\n"
            "from ark_tpu_torch.analysis import spatial_enrichment as se\n"
            "lab = np.zeros((1, 16, 16, 2), np.int32)\n"
            "lab[0, 2:9, 3:10] = 4\n"
            "lab[0, 4:7, 4:7, 1] = 2\n"
            "img = np.ones((1, 16, 16, 2), np.float32)\n"
            "c = {'fovs': ['f'], 'rows': np.arange(16), 'cols': np.arange(16)}\n"
            "norm, _ = q.create_marker_count_matrices(\n"
            "    DataArray(lab, coords={**c, 'compartments': ['whole_cell', 'nuclear']}),\n"
            "    DataArray(img, coords={**c, 'channels': ['a', 'b']}),\n"
            "    nuclear_counts=True, split_large_nuclei=True, device='cpu')\n"
            "assert norm['cell_size'].tolist() == [49.0], norm\n"
            "rng = np.random.default_rng(0)\n"
            "t = pd.DataFrame({'fov': 'f', 'label': np.arange(1, 41),\n"
            "                  'centroid-0': rng.uniform(0, 60, 40),\n"
            "                  'centroid-1': rng.uniform(0, 60, 40),\n"
            "                  'cell_meta_cluster': ['A', 'B'] * 20})\n"
            "with tempfile.TemporaryDirectory() as d:\n"
            "    sa.calc_dist_matrix(t, d, device='cpu')\n"
            "    counts, _ = na.create_neighborhood_matrix(t, d, distlim=30, device='cpu')\n"
            "    dm = sa.load_dist_matrix(d, 'f')\n"
            "labels = sa.generate_cluster_labels(counts[['A', 'B']], 2, device='cpu')\n"
            "names, res = se.calculate_cluster_spatial_enrichment(\n"
            "    'f', t, dm, dist_lim=30, bootstrap_num=5, device='cpu')\n"
            "assert set(labels) == {1, 2} and res['close_num'].shape == (2, 2)\n"
            "assert 'jax' not in sys.modules\n"
            "assert not [m for m in sys.modules if m.startswith('ark_tpu.')]\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert set(QUANT_AND_CELL_MODULES + SPATIAL_MODULES) <= set(_modules())


def test_cpu_segment_sum_never_touches_the_cuda_library(monkeypatch):
    from ark_tpu_torch.ops import segment_reduce

    def refuse(*_):
        raise AssertionError("segment_sum on CPU tensors asked for the library")

    monkeypatch.setattr(_kernels, "lib", refuse)
    monkeypatch.setattr(_kernels, "build", refuse)
    before = segment_reduce.segment_sum.launches
    labels = torch.tensor([0, 2, 1, 2, 2], dtype=torch.int32)
    values = torch.tensor([[9.0], [1.0], [2.0], [3.0], [4.0]])
    got = segment_reduce.segment_sum(values, labels, 4)
    assert got[:, 0].tolist() == [0.0, 2.0, 8.0, 0.0]
    assert segment_reduce.segment_sum.launches == before


def test_non_cpu_segment_sum_never_falls_back(monkeypatch):
    """A tensor off the CPU goes to the kernel or raises: the plain version
    is never called for it, and a device other than CUDA raises before any
    library is built."""
    from ark_tpu_torch.ops import segment_reduce

    def refuse(*_):
        raise AssertionError("fell back or asked for the library")

    monkeypatch.setattr(_kernels, "lib", refuse)
    monkeypatch.setattr(segment_reduce, "segment_sum_plain", refuse)
    labels = torch.zeros(5, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        segment_reduce.segment_sum(torch.empty(5, 2, device="meta"), labels, 3)
    with pytest.raises(ValueError, match="CUDA"):
        segment_reduce.segment_sum(torch.ones(5, 2), labels, 3)
    with pytest.raises(ValueError, match="CUDA"):
        segment_reduce.cell_sizes(torch.zeros(4, 4, dtype=torch.int32,
                                              device="meta"), 3)
