"""Package rules of the PyTorch port (ark_tpu_torch).

The port never imports jax, nor anything of the JAX package ``ark_tpu``
(whose ``__init__`` sets up jax's compilation cache); its sources pass the
repo's style gate; a kernel's wrapper on CPU tensors never builds or loads
the CUDA library, while a tensor on any other device never falls back to
the plain version; the modules that run on the card import without the
host packages the card's machine lacks (imageio, sklearn, h5py, matplotlib,
seaborn) and without tqdm; no module imports imageio or sklearn at all; and
the file entry points of the templates run with those five blocked.
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
# host packages the card's machine lacks (the smoke's first lines list them)
CARD_MISSING = ("imageio", "sklearn", "h5py", "matplotlib", "seaborn")
# blocked while every module is imported: tqdm is on the card's machine, but
# the port imports it only inside the loops that draw a bar
IMPORT_BLOCKED = CARD_MISSING + ("tqdm",)
# the packages the port's modules never import (the port has its own TIFF
# codec and Ward clustering)
NEVER_IMPORTED = ("imageio", "sklearn")


def run_blocked(code, timeout=120):
    """Run `code` in a fresh interpreter at the repo root with every package
    of CARD_MISSING blocked (importing one raises ImportError); fails the
    calling test on a non-zero exit, and returns the process's stdout."""
    prelude = ("import sys\n"
               f"for blocked in {CARD_MISSING!r}:\n"
               "    sys.modules[blocked] = None\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", prelude + code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


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


# the one package of the port that needs matplotlib where it is imported:
# the metacluster remap GUI's normalizer subclasses matplotlib's Normalize.
# It is host code, run in the CPU tests only, never on the card's machine.
NEEDS_MATPLOTLIB = "ark_tpu_torch.utils.metacluster_remap_gui"


def _needs_matplotlib(module):
    return module == NEEDS_MATPLOTLIB or module.startswith(NEEDS_MATPLOTLIB + ".")


def test_port_and_smoke_load_nothing_of_ark_tpu():
    """Importing every port module and chip_smoke, with the host packages the
    card's machine lacks and tqdm blocked, loads no ``ark_tpu`` module and
    leaves jax's compilation-cache variable unset (``ark_tpu/__init__.py``
    sets it). The metacluster GUI, which needs matplotlib, fails to import
    while it is blocked and imports once it is not."""
    card_modules = [m for m in sorted(_modules()) if not _needs_matplotlib(m)]
    gui_modules = [m for m in sorted(_modules()) if _needs_matplotlib(m)]
    assert len(gui_modules) == 7
    code = ("import importlib, os, sys\n"
            f"for blocked in {IMPORT_BLOCKED!r}:\n"
            "    sys.modules[blocked] = None\n"
            f"for m in {card_modules + ['chip_smoke']!r}:\n"
            "    importlib.import_module(m)\n"
            "try:\n"
            f"    importlib.import_module({NEEDS_MATPLOTLIB!r})\n"
            "    raise AssertionError('the GUI imported without matplotlib')\n"
            "except ImportError:\n"
            "    pass\n"
            "for m in [n for n in sys.modules if n.split('.')[0] == 'matplotlib']:\n"
            "    del sys.modules[m]\n"
            f"for m in {gui_modules!r}:\n"
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
                                                "minimax_relabel", "minimax_relax",
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


def test_cpu_claim_levels_never_touches_the_cuda_library(monkeypatch):
    from ark_tpu_torch.ops import watershed

    def refuse(*_):
        raise AssertionError("claim_levels on CPU tensors asked for the library")

    monkeypatch.setattr(_kernels, "lib", refuse)
    monkeypatch.setattr(_kernels, "build", refuse)
    before = watershed.claim_levels.launches
    lab = torch.tensor([[[0, 3, -1], [0, 0, 2]]], dtype=torch.int32)
    q = torch.tensor([[[0, 0, 0], [0, 0, 1]]], dtype=torch.int32)
    new, stop, rounds = watershed.claim_levels(lab, q, 0, 2, 4)
    # level 0: 3 claims two pixels, then 3 the last one, then a fixpoint;
    # level 1: 2 becomes a source, but nothing is left to claim
    assert new.tolist() == [[[3, 3, -1], [3, 3, 2]]] and (stop, rounds) == (2, 4)
    assert watershed.claim_levels.launches == before


SPATIAL_MODULES = [
    "ark_tpu_torch.utils.netcdf3", "ark_tpu_torch.ops.distances",
    "ark_tpu_torch.ops.kmeans", "ark_tpu_torch.analysis.spatial_analysis_utils",
    "ark_tpu_torch.analysis.spatial_enrichment",
    "ark_tpu_torch.analysis.neighborhood_analysis",
    "ark_tpu_torch.analysis.cell_neighborhood_stats",
]
CLASSICAL_MODULES = [
    "ark_tpu_torch.ops.edt", "ark_tpu_torch.ops.classical",
    "ark_tpu_torch.ops.image_filters", "ark_tpu_torch.ops.morphology",
    "ark_tpu_torch.segmentation.fiber_segmentation",
    "ark_tpu_torch.segmentation.ez_seg",
    "ark_tpu_torch.segmentation.ez_seg.composites",
    "ark_tpu_torch.segmentation.ez_seg.ez_object_segmentation",
    "ark_tpu_torch.segmentation.ez_seg.ez_seg_display",
    "ark_tpu_torch.segmentation.ez_seg.ez_seg_utils",
    "ark_tpu_torch.segmentation.ez_seg.merge_masks",
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
            f"for blocked in {IMPORT_BLOCKED!r}:\n"
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
    assert got[:, 0].tolist() == [9.0, 2.0, 8.0, 0.0]
    cells = segment_reduce.segment_sum(values, labels, 4, background=False)
    assert cells[:, 0].tolist() == [0.0, 2.0, 8.0, 0.0]
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


def test_fiber_and_ez_seg_run_without_the_cards_missing_packages():
    """The classical ops, fiber segmentation and ez_seg import with imageio,
    sklearn, tqdm, h5py, matplotlib and seaborn blocked, and their in-memory
    entry points (the ones the smoke run drives on the card) work there; the
    modules fall under the AST scans and the style gate, which walk every
    file of the package."""
    code = ("import importlib, sys\n"
            f"for blocked in {IMPORT_BLOCKED!r}:\n"
            "    sys.modules[blocked] = None\n"
            f"for m in {CLASSICAL_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "import numpy as np\n"
            "from ark_tpu_torch import settings\n"
            "from ark_tpu_torch.segmentation import fiber_segmentation as fs\n"
            "from ark_tpu_torch.segmentation.ez_seg import ez_object_segmentation as ez\n"
            "from chip_smoke import FIBER_DEFAULTS, fiber_image\n"
            "img = fiber_image(np.random.default_rng(0), size=128, n_fibers=4)\n"
            "args = dict(FIBER_DEFAULTS, contrast_scaling_divisor=16)\n"
            "steps = fs._fiber_steps(img, 128, *args.values(), keep_intermediates=False,\n"
            "                        device='cpu')\n"
            "table = fs._fiber_regionprops_table(steps['labeled_filtered'],\n"
            "                                    settings.FIBER_OBJECT_PROPS, device='cpu')\n"
            "table.insert(0, 'fov', 'f')\n"
            "table = fs.calculate_fiber_alignment(table, device='cpu')\n"
            "assert len(table) >= 1 and 'alignment_score' in table.columns, table\n"
            "for shape in ('blob', 'projection'):\n"
            "    mask = ez._create_object_mask(img, shape, thresh='auto', hole_size='auto',\n"
            "                                  fov_dim=400, device='cpu')\n"
            "    assert mask.shape == img.shape and mask.max() > 0\n"
            "assert 'jax' not in sys.modules\n"
            "assert not [m for m in sys.modules if m.startswith('ark_tpu.')]\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert set(CLASSICAL_MODULES) <= set(_modules())


def test_entry_points_of_the_classical_slice_take_a_device():
    """Every public function of the slice that does device work takes
    `device`, and none defaults to the CPU."""
    import inspect

    from ark_tpu_torch.ops import classical, edt, morphology
    from ark_tpu_torch.segmentation import fiber_segmentation as fs
    from ark_tpu_torch.segmentation.ez_seg import ez_object_segmentation as ez
    from ark_tpu_torch.segmentation.ez_seg import ez_seg_display as disp

    takers = [edt.distance_transform_edt, classical.equalize_adapthist, classical.frangi,
              classical.meijering, classical.local_adaptive_threshold, morphology.erode_mask,
              fs._fiber_steps, fs._fiber_regionprops_table, fs.segment_fibers,
              fs.run_fiber_segmentation, fs.plot_fiber_segmentation_steps,
              fs.calculate_fiber_alignment, ez.create_object_masks, ez._create_object_mask,
              disp.overlay_mask_outlines, disp.multiple_mask_display,
              disp.create_overlap_and_merge_visual]
    for fn in takers:
        param = inspect.signature(fn).parameters.get("device")
        assert param is not None and param.kind is param.KEYWORD_ONLY, fn.__name__
        assert param.default == "cuda", fn.__name__


EMBEDDING_MODULES = [
    "ark_tpu_torch.utils.data_utils", "ark_tpu_torch.utils.plot_utils",
    "ark_tpu_torch.utils.masking_utils", "ark_tpu_torch.phenotyping.post_cluster_utils",
    "ark_tpu_torch.ops.umap", "ark_tpu_torch.ops.tsne",
    "ark_tpu_torch.analysis.dimensionality_reduction",
]


def test_mask_and_embedding_modules_run_without_the_cards_missing_packages():
    """Cluster masks, overlays, masking and the embeddings import with
    imageio, sklearn, tqdm, h5py, matplotlib and seaborn blocked, and their
    in-memory entry points (the ones the smoke run drives on the card) work
    there; the modules fall under the AST scans and the style gate, which
    walk every file of the package."""
    code = ("import importlib, sys\n"
            f"for blocked in {IMPORT_BLOCKED!r}:\n"
            "    sys.modules[blocked] = None\n"
            f"for m in {EMBEDDING_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "import numpy as np\n"
            "import pandas as pd\n"
            "from ark_tpu_torch.analysis import dimensionality_reduction as dr\n"
            "from ark_tpu_torch.utils import data_utils, masking_utils, plot_utils\n"
            "rng = np.random.default_rng(0)\n"
            "lab = np.zeros((32, 32), np.int32)\n"
            "lab[2:12, 3:13], lab[15:30, 10:28] = 1, 2\n"
            "table = pd.DataFrame({'fov': 'f', 'label': [1, 2],\n"
            "                      'cell_meta_cluster': ['a', 'b']})\n"
            "cmd = data_utils.ClusterMaskData(table, 'fov', 'label', 'cell_meta_cluster')\n"
            "mask = data_utils.cluster_mask_from_labels('f', lab, cmd, device='cpu')\n"
            "assert mask.dtype == np.int16 and set(np.unique(mask)) == {0, 1, 2}\n"
            "px = data_utils.scatter_pixel_clusters((32, 32), [5, 70], [3, 4], device='cpu')\n"
            "assert px[0, 5] == 3 and px[2, 6] == 4 and px.sum() == 7\n"
            "colors = rng.integers(0, 255, (3, 4)).astype(np.uint8)\n"
            "assert plot_utils.gather_colors(mask, colors, device='cpu').shape == (32, 32, 4)\n"
            "over = plot_utils.overlay_from_arrays(\n"
            "    rng.random((32, 32, 2)).astype(np.float32), lab, device='cpu')\n"
            "assert over.shape == (32, 32, 3) and over.max() == 255\n"
            "cells = masking_utils.create_cell_mask(lab, table, 'f', ['a'], sigma=1,\n"
            "                                       max_hole_area=10, device='cpu')\n"
            "assert cells[5, 5] == 1 and cells[20, 20] == 0\n"
            "x = np.concatenate([rng.normal(c, 0.3, (40, 5)) for c in (0, 6)])\n"
            "for algorithm in ('UMAP', 'PCA', 'tSNE'):\n"
            "    emb = dr.reduce_dimensions(x, algorithm, device='cpu')\n"
            "    assert emb.shape == (80, 2) and np.isfinite(emb).all(), algorithm\n"
            "assert 'jax' not in sys.modules\n"
            "assert not [m for m in sys.modules if m.startswith('ark_tpu.')]\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    assert set(EMBEDDING_MODULES) <= set(_modules())


def test_entry_points_of_the_mask_and_embedding_slice_take_a_device():
    """Every public function of the slice that does device work takes
    `device`, keyword-only, and none defaults to the CPU."""
    import inspect

    from ark_tpu_torch.analysis import dimensionality_reduction as dr
    from ark_tpu_torch.ops import tsne, umap
    from ark_tpu_torch.phenotyping import post_cluster_utils
    from ark_tpu_torch.segmentation import segmentation_utils
    from ark_tpu_torch.utils import data_utils, masking_utils, plot_utils

    takers = [data_utils.erode_mask, data_utils.label_cells_by_cluster,
              data_utils.map_segmentation_labels, data_utils.cluster_mask_from_labels,
              data_utils.generate_cluster_mask, data_utils.scatter_pixel_clusters,
              data_utils.generate_pixel_cluster_mask,
              data_utils.generate_and_save_cell_cluster_masks,
              data_utils.generate_and_save_pixel_cluster_masks,
              data_utils.generate_and_save_neighborhood_cluster_masks,
              plot_utils.overlay_from_arrays, plot_utils.create_overlay,
              plot_utils.gather_colors, plot_utils.save_colored_mask,
              plot_utils.save_colored_masks, plot_utils.cohort_cluster_plot,
              plot_utils.color_segmentation_by_stat, plot_utils.plot_pixel_cell_cluster,
              post_cluster_utils.create_mantis_project, masking_utils.create_cell_mask,
              masking_utils.generate_cell_masks, masking_utils.generate_signal_masks,
              umap.UMAP.__init__, umap.pca_transform, tsne.tsne, tsne.TSNE.__init__,
              dr.reduce_dimensions, dr.visualize_dimensionality_reduction]
    for fn in takers:
        param = inspect.signature(fn).parameters.get("device")
        assert param is not None and param.kind is param.KEYWORD_ONLY, fn.__qualname__
        assert param.default == "cuda", fn.__qualname__
    # no default at all: the caller names the device
    param = inspect.signature(segmentation_utils.save_segmentation_labels).parameters["device"]
    assert param.kind is param.KEYWORD_ONLY and param.default is param.empty


LDA_MODULES = [
    "ark_tpu_torch.config", "ark_tpu_torch.spLDA", "ark_tpu_torch.spLDA.featurization",
    "ark_tpu_torch.spLDA.processing", "ark_tpu_torch.spLDA.model",
    "ark_tpu_torch.utils.spatial_lda_utils", "ark_tpu_torch.analysis.visualize",
]


def test_lda_modules_run_without_the_cards_missing_packages():
    """Spatial LDA, the config and the plots import with imageio, sklearn,
    tqdm, h5py, matplotlib and seaborn blocked, and the steps the smoke run
    drives on the card work there (featurization, difference matrices,
    within-cluster sums, the gap statistic, train, infer, the files);
    the modules fall under the AST scans and the style gate, which walk
    every file of the package."""
    code = ("import importlib, sys, tempfile\n"
            f"for blocked in {IMPORT_BLOCKED!r}:\n"
            "    sys.modules[blocked] = None\n"
            f"for m in {LDA_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "import numpy as np\n"
            "import pandas as pd\n"
            "from ark_tpu_torch.spLDA import model, processing\n"
            "from ark_tpu_torch.utils import spatial_lda_utils as spu\n"
            "rng = np.random.default_rng(0)\n"
            "t = pd.DataFrame({'fov': np.repeat(['f0', 'f1'], 60), 'label': np.tile(\n"
            "    np.arange(1, 61), 2), 'cell_size': 100.0,\n"
            "    'centroid-0': rng.uniform(0, 300, 120), 'centroid-1': rng.uniform(0, 300, 120),\n"
            "    'cell_meta_cluster': rng.choice(['A', 'B', 'C'], 120)})\n"
            "fmt = processing.format_cell_table(t, clusters=['A', 'B', 'C'])\n"
            "feats = processing.featurize_cell_table(fmt, radius=100, device='cpu')\n"
            "diff = processing.create_difference_matrices(fmt, feats)\n"
            "train = feats['train_features']\n"
            "labels = np.arange(len(train)) % 3\n"
            "pooled = spu.within_cluster_sums(train.values, labels, device='cpu')\n"
            "gap, sd = processing.gap_stat(train, 3, pooled, num_boots=25, device='cpu')\n"
            "m = model.train(train, diff['train_diff_mat'], n_topics=3, n_iters=3,\n"
            "                device='cpu')\n"
            "w = model.infer(m, feats['featurized_fovs'], diff['inference_diff_mat'],\n"
            "                n_iters=3, device='cpu')\n"
            "assert w.shape == (120, 3) and np.isfinite(gap) and np.isfinite(sd)\n"
            "with tempfile.TemporaryDirectory() as d:\n"
            "    spu.save_spatial_lda_file(m, d, 'lda_model')\n"
            "    spu.save_spatial_lda_file(w, d, 'topic_weights', format='csv')\n"
            "assert 'jax' not in sys.modules\n"
            "assert not [m for m in sys.modules if m.startswith('ark_tpu.')]\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    assert set(LDA_MODULES) <= set(_modules())


def test_entry_points_of_the_lda_slice_take_a_device():
    """Every public function of the slice that does device work takes
    `device`, keyword-only, defaulting to "cuda"."""
    import inspect

    from ark_tpu_torch.spLDA import featurization, model, processing
    from ark_tpu_torch.utils import spatial_lda_utils

    takers = [featurization.neighborhood_to_cluster, featurization.neighborhood_to_marker,
              featurization.neighborhood_to_avg_marker, featurization.neighborhood_to_count,
              processing.featurize_cell_table, processing.gap_stat,
              processing.compute_topic_eda, model.laplacian_blocks, model.train, model.infer,
              spatial_lda_utils.within_cluster_sums]
    for fn in takers:
        param = inspect.signature(fn).parameters.get("device")
        assert param is not None and param.kind is param.KEYWORD_ONLY, fn.__qualname__
        assert param.default == "cuda", fn.__qualname__


TRAIN_MODULES = [
    "ark_tpu_torch.segmentation.train", "ark_tpu_torch.segmentation.synthetic",
    "ark_tpu_torch.models.convert_deepcell", "ark_tpu_torch.utils.deepcell_service_utils",
    "ark_tpu_torch.graft_entry",
]


def test_training_and_conversion_run_without_the_cards_missing_packages():
    """Training, conversion, the DeepCell-service helpers and the entry
    import with h5py, imageio, PIL, sklearn (and the rest of the card's
    missing packages) blocked, and their device work runs there: the
    targets, a fit, train_on_synthetic without a checkpoint file, the
    converter on a manifest-shaped layer dict, the entry's forward."""
    code = ("import importlib, sys\n"
            f"for blocked in {IMPORT_BLOCKED + ('PIL',)!r}:\n"
            "    sys.modules[blocked] = None\n"
            f"for m in {TRAIN_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "import numpy as np\n"
            "from ark_tpu_torch import graft_entry\n"
            "from ark_tpu_torch.models import convert_deepcell, unet\n"
            "from ark_tpu_torch.segmentation import synthetic, train\n"
            "from chip_smoke import manifest_layers\n"
            "imgs, cells, _ = synthetic.synthetic_cells(np.random.default_rng(0), 4, hw=32)\n"
            "t = synthetic.targets_from_labels(cells, device='cpu')\n"
            "targets = {'whole_cell_inner_distance': t['inner_distance'],\n"
            "           'whole_cell_pixelwise': t['pixelwise']}\n"
            "model = unet.init_mesmer_mini(device='cpu')\n"
            "_, losses = train.fit(model, imgs, targets, steps=2, batch_size=2, device='cpu')\n"
            "app, more = train.train_on_synthetic(steps=1, n_images=2, hw=32, device='cpu')\n"
            "assert np.isfinite(losses).all() and np.isfinite(more).all()\n"
            "tree = convert_deepcell.convert(manifest_layers(np.random.default_rng(0)),\n"
            "                                convert_deepcell.template_variables())\n"
            "assert tree['params']['FPN_0']['P7']['kernel'].shape == (3, 3, 256, 256)\n"
            "forward, args = graft_entry.entry(device='cpu')\n"
            "assert forward(*args)[1].shape == (1, 128, 128, 3)\n"
            "assert 'jax' not in sys.modules\n"
            "assert not [m for m in sys.modules if m.startswith('ark_tpu.')]\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    assert set(TRAIN_MODULES) <= set(_modules())


def test_entry_points_of_the_training_slice_take_a_device():
    """Training, targets and the entry take `device`, keyword-only,
    defaulting to "cuda"; run_deepcell_direct takes it with no default, as
    create_deepcell_output beside it does."""
    import inspect

    from ark_tpu_torch import graft_entry
    from ark_tpu_torch.segmentation import synthetic, train
    from ark_tpu_torch.utils import deepcell_service_utils

    for fn in (synthetic.targets_from_labels, train.fit, train.train_on_synthetic,
               graft_entry.entry):
        param = inspect.signature(fn).parameters.get("device")
        assert param is not None and param.kind is param.KEYWORD_ONLY, fn.__qualname__
        assert param.default == "cuda", fn.__qualname__
    for fn in (deepcell_service_utils.run_deepcell_direct,
               deepcell_service_utils.create_deepcell_output):
        param = inspect.signature(fn).parameters["device"]
        assert param.kind is param.KEYWORD_ONLY and param.default is param.empty


SLICE_10_MODULES = [
    "ark_tpu_torch.ops.cc", "ark_tpu_torch.ops.quantiles", "ark_tpu_torch.io.ome_utils",
    "ark_tpu_torch.io.load_utils", "ark_tpu_torch.utils.profiling",
    "ark_tpu_torch.parallel", "ark_tpu_torch.parallel.prefetch",
    "ark_tpu_torch.phenotyping.cluster_helpers", "ark_tpu_torch.models.unet",
    "ark_tpu_torch.settings",
]


def test_last_single_card_modules_run_without_the_cards_missing_packages():
    """The single-image labeling, the bisection quantiles, profiling and the
    prefetch loader import and run with the card's missing packages
    blocked; the OME module imports there (imageio only inside)."""
    code = ("import importlib, os, sys, tempfile\n"
            f"for blocked in {IMPORT_BLOCKED!r}:\n"
            "    sys.modules[blocked] = None\n"
            f"for m in {SLICE_10_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "import numpy as np, torch\n"
            "from ark_tpu_torch.ops import cc, quantiles\n"
            "from ark_tpu_torch.parallel.prefetch import PrefetchLoader\n"
            "from ark_tpu_torch.utils import profiling\n"
            "mask = np.eye(6, dtype=bool)\n"
            "assert cc.label_np(mask, 2, device='cpu')[1] == 1\n"
            "assert cc.remove_small_holes_np(~mask, 8, device='cpu').all()\n"
            "x = torch.arange(12.0).reshape(6, 2)\n"
            "assert quantiles.nonzero_quantile_per_column_bisect(x, 1.0).tolist() == [10, 11]\n"
            "got = [v.tolist() for _, v in PrefetchLoader(range(3), np.ones, device='cpu')]\n"
            "assert got == [[], [1.0], [1.0, 1.0]]\n"
            "with tempfile.TemporaryDirectory() as d:\n"
            "    with profiling.trace(d, device='cpu'):\n"
            "        x.sum()\n"
            "    assert len(os.listdir(d)) == 1\n"
            "assert 'jax' not in sys.modules\n"
            "assert not [m for m in sys.modules if m.startswith('ark_tpu.')]\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert set(SLICE_10_MODULES) <= set(_modules())


def test_entry_points_of_the_last_single_card_slice_take_a_device():
    """The functions that take a host mask take `device`, keyword-only,
    defaulting to "cuda", as does trace; so does the loader's `device`
    (None keeps the host results)."""
    import inspect

    from ark_tpu_torch.ops import cc
    from ark_tpu_torch.parallel.prefetch import PrefetchLoader
    from ark_tpu_torch.utils import profiling

    for fn in (cc.label, cc.label_checked, cc.label_np, cc.remove_small_objects,
               cc.remove_small_holes, cc.remove_small_holes_np, profiling.trace):
        param = inspect.signature(fn).parameters.get("device")
        assert param is not None and param.kind is param.KEYWORD_ONLY, fn.__qualname__
        assert param.default == "cuda", fn.__qualname__
    assert inspect.signature(PrefetchLoader).parameters["device"].default == "cuda"


def test_no_module_imports_the_packages_the_port_replaced():
    """imageio and sklearn, which the card's machine lacks, are imported by
    no module of the port, inside functions included: the port has its own
    TIFF codec (``io/tiff.py``), Ward clustering
    (``cluster_helpers.WardClustering``) and cosine similarity."""
    offenders = [f"{os.path.relpath(path, REPO)}:{line} {name}"
                 for path in _files((".py",)) for line, name in _imported_names(path)
                 if name.split(".")[0] in NEVER_IMPORTED]
    assert not offenders, offenders


FILE_ENTRY_POINTS = """
import tempfile
import numpy as np
import chip_smoke as smoke
from ark_tpu_torch.segmentation import synthetic

rng = np.random.default_rng(21)
chans = ["chan0", "chan1", "chan2", "chan3"]
raws = smoke.make_cohort(rng, n_fovs=2, size=64)
raws = [r[..., :4] for r in raws]
with tempfile.TemporaryDirectory() as base:
    _, seconds, got = smoke.pixel_stage_from_files(raws, base, "cpu", channels=chans,
                                                   xdim=3, ydim=3, max_k=4)
want = smoke.drive_slice(raws, "cpu", xdim=3, ydim=3)
smoke.check_pixel_stage_from_files(got, want, (64, 64), 9, 4)
print("pixel steps", sorted(seconds))

planted = synthetic.synthetic_cells(np.random.default_rng(22), 2, hw=64)[0]
images = {f"fov{i}": {"nuclear": planted[i, ..., 0], "membrane": planted[i, ..., 1],
                      "marker0": rng.gamma(1.0, 2.0, (64, 64)).astype(np.float32),
                      "marker1": rng.poisson(3.0, (64, 64)).astype(np.float32)}
          for i in range(2)}
fiber = smoke.fiber_image(np.random.default_rng(23), size=64, n_fibers=4)
kw = dict(ckpt=smoke.CKPT, xdim=3, ydim=3, max_k=4)
with tempfile.TemporaryDirectory() as base:
    out, seconds = smoke.templates_from_files(base, images, fiber, "cpu", **kw)
    n_cells, n_meta = smoke.check_templates_from_files(out, images, fiber, "cpu", **kw)
print("template steps", sorted(seconds), n_cells, n_meta)
"""


def test_file_entry_points_run_without_the_card_missing_packages():
    """With imageio, sklearn, h5py, matplotlib and seaborn blocked, the
    smoke's file paths run on the CPU at a small size (2 FOVs
    of 64², 4 channels, a 3x3 SOM, the mini checkpoint) and pass the
    smoke's own checks: run_pixel_clustering with its pixel masks, then
    generate_deepcell_input -> create_deepcell_output -> generate_cell_table
    -> the cell SOM and cell_consensus_cluster -> the cell masks ->
    calc_dist_matrix with the neighborhood matrix, run_fiber_segmentation and
    the fov_to_ome/ome_to_fov round trip."""
    out = run_blocked(FILE_ENTRY_POINTS, timeout=240)
    assert "pixel steps ['pixel_masks', 'run_pixel_clustering', 'write_tiffs']" in out
    assert "create_deepcell_output" in out and "ome_to_fov" in out


def _kernel_timer():
    """scripts/port_kernel_ab.py as a module (it imports no card until a
    timing runs)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "port_kernel_ab", os.path.join(REPO, "scripts", "port_kernel_ab.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("bound, ms, by", [
    # phase A of the 8 x 512^2 whole-cell relief: 683 rounds, 334,006 of
    # 2,097,152 pixels labelled at the end
    (lambda ab: ab.scan_bound_ms(2_097_152, 334_006, 683), 1.5503, "L2 bytes"),
    # the pixel stage's BMU call: 4,194,304 rows x 16 channels, K = 100
    (lambda ab: ab.bmu_bound_ms(4_194_304, 16, 100), 0.2003, "operations"),
], ids=["level_scan", "bmu"])
def test_kernel_timer_bounds_match_the_kernel_table(bound, ms, by):
    """The bounds scripts/port_kernel_ab.py reckons, at the shapes of the
    kernel table in PERF.md, read as that table does (ms to 4 places)."""
    got, got_by = bound(_kernel_timer())
    assert (round(got, 4), got_by) == (ms, by)
