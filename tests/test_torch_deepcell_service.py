"""The DeepCell-service helpers of ark_tpu_torch.utils.deepcell_service_utils
against ark_tpu.utils.deepcell_service_utils.

``generate_deepcell_input``, ``zip_input_files`` and
``extract_deepcell_response`` write the same files as the JAX package's,
byte for byte, with the same warnings (the integer overflow promotion, the
missing masks); ``read_image_bytes`` decodes the same arrays.
``run_deepcell_direct`` writes the same zip members, with masks from the
port's own heads, which differ from the JAX package's in the last bits: the
instances agree by the mesmer slice's rule (recall and precision at IoU 0.5
at least 0.98).
"""

import datetime
import io
import os
import warnings
from zipfile import ZipFile

import numpy as np
import pytest
import torch

from ark_tpu.io.image_utils import save_image
from ark_tpu.utils import deepcell_service_utils as JD
from ark_tpu_torch.io import tiff
from ark_tpu_torch.segmentation import synthetic as TS
from ark_tpu_torch.utils import deepcell_service_utils as TD
from tests import test_utils

torch.set_num_threads(2)

CKPT = os.path.join(os.path.dirname(JD.__file__), "..", "models", "checkpoints",
                    "mesmer_mini_synthetic.npz")
AGREEMENT = 0.98


@pytest.fixture(autouse=True)
def _frozen_tiff_clock(monkeypatch):
    """The TIFF writer stamps each file's DateTime tag with the wall clock's
    second, so two packages writing the same image across a second's boundary
    wrote different bytes (most often in a process's first case, where the
    JAX package's first call compiles). Both writers, imageio's and the
    port's codec, write under one fixed clock."""
    from imageio.plugins import tifffile as tiff_plugin

    stamp = datetime.datetime(2020, 1, 2, 3, 4, 5)
    monkeypatch.setattr(tiff_plugin._tifffile.TiffWriter, "_now", lambda self: stamp)
    monkeypatch.setattr(tiff, "now", lambda: stamp)


def _read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _run_both(fn_j, fn_t, tmp_path, *args, **kwargs):
    """Run each package's `fn` into its own output folder; returns the two
    folders and the warnings' messages of each."""
    out = {}
    for name, fn in (("jax", fn_j), ("port", fn_t)):
        d = tmp_path / name
        d.mkdir()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn(str(d), *args, **kwargs)
        out[name] = (d, [str(w.message) for w in caught])
    return out


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    differ = [n for n in names if _read_bytes(a / n) != _read_bytes(b / n)]
    assert not differ, f"first differing file: {differ[0]} (of {differ})"


@pytest.mark.parametrize("case", ["nuc_and_mem", "mem_only", "float", "overflow"])
def test_generate_deepcell_input_writes_the_jax_files(tmp_path, case):
    tiff_dir = tmp_path / "tiffs"
    if case == "overflow":
        # three ~30k-count uint16 membrane channels sum past int16 and uint16
        (tiff_dir / "fovX").mkdir(parents=True)
        for chan in ("nuc", "mem1", "mem2", "mem3"):
            save_image(str(tiff_dir / "fovX" / f"{chan}.tiff"),
                       np.full((16, 16), 30000, np.uint16))
        args = (["nuc"], ["mem1", "mem2", "mem3"], ["fovX"])
    else:
        data = test_utils.create_image_cohort(str(tiff_dir), ["fov0", "fov1"],
                                              ["nuc1", "nuc2", "mem1"], shape=(32, 32))
        if case == "float":
            for fov, (_, imgs) in data.items():
                for ci, chan in enumerate(["nuc1", "nuc2", "mem1"]):
                    save_image(str(tiff_dir / fov / f"{chan}.tiff"),
                               imgs[..., ci].astype(np.float32) / 7)
        nuc = None if case == "mem_only" else ["nuc1", "nuc2"]
        args = (nuc, ["mem1"], ["fov0", "fov1"])
    out = _run_both(JD.generate_deepcell_input, TD.generate_deepcell_input, tmp_path,
                    str(tiff_dir), *args, img_sub_folder=None)
    _same_files(out["jax"][0], out["port"][0])
    assert out["jax"][1] == out["port"][1], (out["jax"][1], out["port"][1])
    assert any("exceed" in m for m in out["port"][1]) == (case == "overflow")


def test_generate_deepcell_input_validation_matches_jax(tmp_path):
    for module in (JD, TD):
        with pytest.raises(ValueError, match="should be non-empty"):
            module.generate_deepcell_input(str(tmp_path), str(tmp_path), [], [], ["fov0"])


def _inputs(tmp_path, fovs, hw=64):
    imgs = TS.synthetic_cells(np.random.default_rng(11), len(fovs), hw=hw)[0]
    input_dir = tmp_path / "deepcell_input"
    input_dir.mkdir()
    for i, fov in enumerate(fovs):
        save_image(str(input_dir / f"{fov}.tiff"), np.moveaxis(imgs[i], -1, 0))
    return input_dir


def test_zip_input_files_matches_jax(tmp_path):
    input_dir = _inputs(tmp_path, ["fov0", "fov1"])
    contents = {}
    for name, module in (("jax", JD), ("port", TD)):
        path = module.zip_input_files(str(input_dir), ["fov0", "fov1"], batch_num=name)
        assert path == str(input_dir / f"fovs_batch_{name}.zip")
        mtime = os.path.getmtime(path)
        assert module.zip_input_files(str(input_dir), ["fov0"], batch_num=name) == path
        assert os.path.getmtime(path) == mtime            # skipped: it exists
        with ZipFile(path) as zf:
            contents[name] = {n: zf.read(n) for n in zf.namelist()}
    assert contents["jax"] == contents["port"]
    assert sorted(contents["port"]) == ["fov0.tiff", "fov1.tiff"]


def test_run_and_extract_deepcell_response_match_jax(tmp_path):
    fovs = ["fovs_a", "fovs_b"]
    input_dir = _inputs(tmp_path, fovs)
    zip_path = JD.zip_input_files(str(input_dir), fovs, batch_num=1)
    masks, members = {}, {}
    for name, run in (("jax", lambda z, d: JD.run_deepcell_direct(z, d, weights_path=CKPT)),
                      ("port", lambda z, d: TD.run_deepcell_direct(
                          z, d, weights_path=CKPT, device="cpu"))):
        d = tmp_path / f"run_{name}"
        d.mkdir()
        assert run(zip_path, str(d)) == 0
        with ZipFile(d / "deepcell_response_fovs_batch_1.zip") as zf:
            members[name] = sorted(zf.namelist())
            masks[name] = {n: TD.read_image_bytes(zf.read(n)) for n in zf.namelist()}
    assert members["jax"] == members["port"] == [
        "fovs_a_feature_0.tif", "fovs_a_feature_1.tif",
        "fovs_b_feature_0.tif", "fovs_b_feature_1.tif"]
    for n, want in masks["jax"].items():
        got = masks["port"][n]
        assert got.dtype == want.dtype == np.int32 and got.shape == want.shape
        stats = TS.match_instances(got, want)
        assert stats["recall"] >= AGREEMENT and stats["precision"] >= AGREEMENT, (n, stats)

    # extraction of the JAX package's response zip, one missing mask included
    response = tmp_path / "run_jax" / "deepcell_response_fovs_batch_1.zip"
    out = {}
    for name, module in (("jax", JD), ("port", TD)):
        d = tmp_path / f"extract_{name}"
        d.mkdir()
        (d / response.name).write_bytes(response.read_bytes())
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            module.extract_deepcell_response(str(d), fovs + ["fovs_c"], 1,
                                             "_whole_cell", "_nuclear")
        os.remove(d / response.name)
        out[name] = (d, [str(w.message) for w in caught])
    _same_files(out["jax"][0], out["port"][0])
    assert out["jax"][1] == out["port"][1], (out["jax"][1], out["port"][1])
    assert len(out["port"][1]) == 2
    assert sorted(os.listdir(out["port"][0])) == [
        f"{f}{s}.tiff" for f in fovs for s in ("_nuclear", "_whole_cell")]


@pytest.mark.parametrize("pages", [1, 2])
def test_read_image_bytes_matches_jax(pages):
    from PIL import Image

    rng = np.random.default_rng(pages)
    frames = [Image.fromarray(rng.integers(0, 1000, (8, 12)).astype(np.int32))
              for _ in range(pages)]
    buf = io.BytesIO()
    frames[0].save(buf, format="TIFF", save_all=True, append_images=frames[1:])
    got, want = TD.read_image_bytes(buf.getvalue()), JD.read_image_bytes(buf.getvalue())
    assert got.shape == want.shape == ((8, 12) if pages == 1 else (2, 8, 12))
    np.testing.assert_array_equal(got, want)
