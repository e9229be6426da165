"""ark_tpu_torch.io.ome_utils against ark_tpu.io.ome_utils, on the CPU.

OME-TIFFs and their channel sidecars written by either package read the
same in the other: the channel trees that come back hold equal arrays
under equal names, the OME files themselves are equal byte for byte (the
TIFF writer's clock held fixed, as it stamps each file with the second),
and without a sidecar both readers recover the same names (or the same
generic names with the same warning). OME-TIFFs that carry their channel
names only in OME-XML, as tifffile writes them, unbundle the same in both
packages; the port writes the JAX package's OME-XML header, when asked, as
imageio writes a description.
"""

import datetime
import os
import warnings

import numpy as np
import pytest

from ark_tpu.io import load_utils as JL
from ark_tpu.io import ome_utils as JO
from ark_tpu.io.image_utils import read_image, save_image
from ark_tpu_torch.io import load_utils as TL
from ark_tpu_torch.io import tiff
from ark_tpu_torch.io import ome_utils as TO
from tests import test_utils

PACKAGES = {"jax": JO, "port": TO}
DIRECTIONS = [("jax", "port"), ("port", "jax")]
CHANNELS = ["CD3", "CD45", "ECAD", "dsDNA"]


@pytest.fixture(autouse=True)
def _frozen_tiff_clock(monkeypatch):
    from imageio.plugins import tifffile as tiff_plugin

    stamp = datetime.datetime(2020, 1, 2, 3, 4, 5)
    monkeypatch.setattr(tiff_plugin._tifffile.TiffWriter, "_now", lambda self: stamp)
    monkeypatch.setattr(tiff, "now", lambda: stamp)


@pytest.fixture
def tree(tmp_path):
    test_utils.create_image_cohort(str(tmp_path / "tree"), ["fov0", "fov1"], CHANNELS,
                                   shape=(24, 20))
    return tmp_path / "tree"


def _channel_tree(fov_dir):
    return {f: read_image(os.path.join(fov_dir, f)) for f in sorted(os.listdir(fov_dir))}


def _assert_same_tree(got, want):
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_ome_written_by_one_reads_back_in_the_other(tmp_path, tree, writer, reader):
    ome = PACKAGES[writer].fov_to_ome(str(tree / "fov0"), str(tmp_path / "ome"))
    assert ome == str(tmp_path / "ome" / "fov0.ome.tiff")
    out = PACKAGES[reader].ome_to_fov(ome, str(tmp_path / "back"), img_sub_folder="TIFs")
    assert out == str(tmp_path / "back" / "fov0")
    back = _channel_tree(os.path.join(out, "TIFs"))
    assert list(back) == [f"{c}.tiff" for c in sorted(CHANNELS)]
    _assert_same_tree(back, _channel_tree(tree / "fov0"))


@pytest.mark.parametrize("sub_folder", [None, "TIFs"])
def test_both_write_the_same_ome_file_and_sidecar(tmp_path, sub_folder):
    test_utils.create_image_cohort(str(tmp_path / "tree"), ["fovA"], CHANNELS,
                                   shape=(16, 16), sub_folder=sub_folder or "")
    paths = {name: mod.fov_to_ome(str(tmp_path / "tree" / "fovA"), str(tmp_path / name),
                                  img_sub_folder=sub_folder, fov_name="renamed")
             for name, mod in PACKAGES.items()}
    for suffix in ("", ".channels.txt"):
        with open(paths["jax"] + suffix, "rb") as a, open(paths["port"] + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    assert os.path.basename(paths["port"]) == "renamed.ome.tiff"
    assert TO._ome_xml(CHANNELS, (16, 20), np.uint16) == \
        JO._ome_xml(CHANNELS, (16, 20), np.uint16)


def _names_and_warnings(mod, path, n):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        names = mod._read_channel_names(path, n)
    return names, [str(w.message) for w in caught]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_channel_names_without_the_sidecar_are_the_same(tmp_path, tree, writer):
    """Without its sidecar an OME file's names come from its OME-XML
    description where the TIFF writer kept it, else generic names with a
    warning: both readers give the same names and warnings, and unbundle
    the same tree."""
    ome = PACKAGES[writer].fov_to_ome(str(tree / "fov1"), str(tmp_path / "ome"))
    os.remove(ome + ".channels.txt")
    got = {name: _names_and_warnings(mod, ome, len(CHANNELS))
           for name, mod in PACKAGES.items()}
    assert got["jax"] == got["port"]
    assert got["port"][0] in (sorted(CHANNELS), [f"channel_{i}" for i in range(4)])
    trees = {name: _channel_tree(mod.ome_to_fov(ome, str(tmp_path / name)))
             for name, mod in PACKAGES.items()}
    _assert_same_tree(trees["port"], trees["jax"])


def test_generic_names_and_warning_are_the_same(tmp_path):
    """A channels-first TIFF with neither sidecar nor OME-XML."""
    path = str(tmp_path / "plain.tiff")
    save_image(path, np.arange(3 * 8 * 8, dtype=np.uint16).reshape(3, 8, 8))
    got = {name: _names_and_warnings(mod, path, 3) for name, mod in PACKAGES.items()}
    assert got["jax"] == got["port"]
    assert got["port"][0] == ["channel_0", "channel_1", "channel_2"]
    assert len(got["port"][1]) == 1


def test_mibitiff_loader_reads_either_packages_ome(tmp_path, tree):
    for name, mod in PACKAGES.items():
        for fov in ("fov0", "fov1"):
            mod.fov_to_ome(str(tree / fov), str(tmp_path / name))
    ref = JL.load_imgs_from_mibitiff(str(tmp_path / "jax"), channels=["ECAD", "CD3"])
    for name in PACKAGES:
        got = TL.load_imgs_from_mibitiff(str(tmp_path / name), channels=["ECAD", "CD3"])
        np.testing.assert_array_equal(got.values, ref.values)
        assert list(got.coords["channels"]) == ["ECAD", "CD3"]
        assert list(got.coords["fovs"]) == list(ref.coords["fovs"])


def test_load_utils_keeps_one_copy_of_the_channel_reader():
    assert TL._read_channel_names is TO._read_channel_names


def _tifffile_ome(path, stack, names, tiffdata):
    """An OME-TIFF as the vendored tifffile writes it: the JAX package's
    OME-XML header with `tiffdata` added, one page a channel, no sidecar."""
    from imageio.plugins import _tifffile

    xml = JO._ome_xml(names, stack.shape[1:], stack.dtype).replace(
        "</Pixels>", tiffdata + "</Pixels>")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with _tifffile.TiffWriter(path) as w:
            w.save(stack, description=xml, photometric="minisblack", metadata=None)
    return path


TIFFDATA = {"none": "", "all_pages": "<TiffData/>",
            "per_plane": "".join(f'<TiffData FirstC="{i}" IFD="{i}" PlaneCount="1"/>'
                                 for i in range(len(CHANNELS)))}


@pytest.mark.parametrize("tiffdata", sorted(TIFFDATA))
def test_tifffile_ome_unbundles_the_same_in_both(tmp_path, tiffdata):
    """Names from the OME-XML's Channel Name attributes, arrays as imageio
    reads them: ome_to_fov, _read_channel_names and the MIBItiff loader give
    the JAX package's results."""
    import imageio.v3 as iio

    rng = np.random.default_rng(len(tiffdata))
    names = ["CD3", "ECAD", "H3", "Ki67"]
    for fov in ("fovA", "fovB"):
        stack = rng.integers(0, 4000, (len(names), 12, 10)).astype(np.uint16)
        _tifffile_ome(str(tmp_path / f"{fov}.ome.tiff"), stack, names, TIFFDATA[tiffdata])
    ome = str(tmp_path / "fovA.ome.tiff")
    got = {name: _names_and_warnings(mod, ome, len(names)) for name, mod in PACKAGES.items()}
    assert got["port"] == got["jax"] == (names, [])
    np.testing.assert_array_equal(TO.read_image(ome), iio.imread(ome))
    trees = {name: _channel_tree(mod.ome_to_fov(ome, str(tmp_path / name)))
             for name, mod in PACKAGES.items()}
    assert list(trees["port"]) == [f"{c}.tiff" for c in names]
    _assert_same_tree(trees["port"], trees["jax"])
    want = JL.load_imgs_from_mibitiff(str(tmp_path), channels=["Ki67", "CD3"])
    have = TL.load_imgs_from_mibitiff(str(tmp_path), channels=["Ki67", "CD3"])
    np.testing.assert_array_equal(have.values, want.values)
    assert list(have.coords["fovs"]) == list(want.coords["fovs"])


def test_ome_xml_header_when_asked_is_imageios_description(tmp_path, tree, monkeypatch):
    """With OME_XML set the port's file is the one imageio writes when its
    TIFF writer takes the JAX package's header as a description, and its
    channel names come back from the header alone."""
    import imageio.v2 as iio2

    monkeypatch.setattr(TO, "OME_XML", True)
    ome = TO.fov_to_ome(str(tree / "fov0"), str(tmp_path / "port"))
    with open(ome + ".channels.txt") as f:
        names = f.read().splitlines()
    stack = np.stack([read_image(str(tree / "fov0" / f"{c}.tiff")) for c in names])
    want = str(tmp_path / "imageio.ome.tiff")
    writer = iio2.get_writer(want, format="TIFF")
    writer.append_data(stack, {"description": JO._ome_xml(names, stack.shape[1:],
                                                          stack.dtype)})
    writer.close()
    with open(ome, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    os.remove(ome + ".channels.txt")
    got = {name: _names_and_warnings(mod, ome, len(names)) for name, mod in PACKAGES.items()}
    assert got["port"] == got["jax"] == (names, [])
    trees = {name: _channel_tree(mod.ome_to_fov(ome, str(tmp_path / name)))
             for name, mod in PACKAGES.items()}
    _assert_same_tree(trees["port"], trees["jax"])
