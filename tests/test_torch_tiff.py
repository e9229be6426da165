"""ark_tpu_torch.io.tiff, the port's TIFF codec, against imageio on the CPU.

Writes: the bytes of ``ark_tpu.io.image_utils.save_image`` (imageio's legacy
TIFF plugin) and of ``ark_tpu.io.ome_utils.fov_to_ome``, byte for byte, for
every dtype and 2-D or channels-first shape up to 64², both writers' clocks
held fixed. Reads: the array ``imageio.v3.imread`` returns (dtype, shape and
values) on a corpus made here from seeded arrays: the JAX package's files,
PIL's raw, deflate, LZW and PackBits files with and without predictor 2, a
multi-page PIL file, the vendored tifffile writer's big-endian, deflate
(8 and 32946), predictor and tiled files, and its OME-TIFFs (planes mapped
to pages by TiffData, or left to the generic series). Unsupported files
raise a ValueError naming the tag; names other than .tif and .tiff are
refused by ``save_image`` and by the tile stitcher. One FOV read into the
planes of a channel-first stack (``load_utils.load_fov_planes`` over
``tiff.read_into``) is ``load_imgs_from_tree``'s array transposed, bit for
bit, for every layout above and for mixed dtypes.
"""

import datetime
import os
import struct
import warnings

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from ark_tpu.io import image_utils as JI
from ark_tpu.io import ome_utils as JO
from ark_tpu_torch.io import image_utils as TI
from ark_tpu_torch.io import ome_utils as TO
from ark_tpu_torch.io import tiff
from ark_tpu_torch.utils import deepcell_service_utils as TD

STAMP = datetime.datetime(2021, 6, 7, 8, 9, 10)
DTYPES = ["uint8", "int16", "uint16", "int32", "uint32", "float32",
          "bool", "float64", "int64"]          # the last three through save_image's casts


@pytest.fixture(autouse=True)
def _frozen_clocks(monkeypatch):
    from imageio.plugins import tifffile as tiff_plugin

    monkeypatch.setattr(tiff_plugin._tifffile.TiffWriter, "_now", lambda self: STAMP)
    monkeypatch.setattr(tiff, "now", lambda: STAMP)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _image(rng, dtype, shape):
    if dtype == "bool":
        return rng.random(shape) < 0.5
    if np.dtype(dtype).kind == "f":
        return (rng.standard_normal(shape) * 1e3).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)


SHAPES = st.one_of(
    st.tuples(st.integers(1, 64), st.integers(1, 64)),
    st.tuples(st.integers(1, 6), st.integers(1, 64), st.integers(1, 64)))


@settings(max_examples=60, deadline=None)
@given(dtype=st.sampled_from(DTYPES), shape=SHAPES, seed=st.integers(0, 2 ** 16))
def test_save_image_bytes_equal_the_jax_writer(tmp_path_factory, dtype, shape, seed):
    img = _image(np.random.default_rng(seed), dtype, shape)
    d = tmp_path_factory.mktemp("w")
    JI.save_image(str(d / "jax.tiff"), img)
    TI.save_image(str(d / "port.tiff"), img)
    want = _bytes(d / "jax.tiff")
    assert _bytes(d / "port.tiff") == want
    if dtype not in ("bool", "float64", "int64"):
        assert tiff.encode(img) == want


@pytest.mark.parametrize("dtype", DTYPES[:6])
@pytest.mark.parametrize("shape", [(1, 1), (3, 4), (2, 64, 64), (3, 5, 7), (4, 8, 3),
                                   (5, 17, 9), (1, 9, 9), (9, 4, 1)])
def test_encode_bytes_and_round_trip(tmp_path, dtype, shape):
    """Shapes that take each of the writer's layouts: one page, pages,
    RGB planes (3 or 4 leading), RGB samples (3 or 4 trailing), a trailing
    1; the codec reads its own file back as imageio does."""
    import imageio.v3 as iio

    img = _image(np.random.default_rng(len(shape) * 7 + shape[-1]), dtype, shape)
    JI.save_image(str(tmp_path / "jax.tiff"), img)
    assert tiff.encode(img) == _bytes(tmp_path / "jax.tiff")
    got, want = tiff.read(str(tmp_path / "jax.tiff")), iio.imread(str(tmp_path / "jax.tiff"))
    assert got.dtype == want.dtype and got.shape == want.shape == shape
    np.testing.assert_array_equal(got, img)


def test_datetime_comes_from_the_module_clock(monkeypatch):
    img = np.zeros((2, 3), np.uint8)
    assert b"2021:06:07 08:09:10\0" in tiff.encode(img)
    monkeypatch.setattr(tiff, "now", lambda: datetime.datetime(1999, 12, 31, 23, 59, 58))
    assert b"1999:12:31 23:59:58\0" in tiff.encode(img)


@pytest.mark.parametrize("n_channels", [1, 2, 3, 5])
def test_fov_to_ome_bytes_equal_the_jax_writer(tmp_path, n_channels):
    rng = np.random.default_rng(n_channels)
    fov = tmp_path / "fov0"
    for c in range(n_channels):
        JI.save_image(str(fov / f"chan{c}.tiff"),
                      rng.integers(0, 5000, (24, 20)).astype(np.uint16))
    paths = {name: mod.fov_to_ome(str(fov), str(tmp_path / name))
             for name, mod in (("jax", JO), ("port", TO))}
    assert _bytes(paths["port"]) == _bytes(paths["jax"])


# --- reading: the corpus

def _pil(path, arr, compression, predictor):
    from PIL import Image

    info = {317: 2} if predictor else {}
    Image.fromarray(arr).save(path, compression=compression, tiffinfo=info)


PIL_ARRAYS = {"L": np.uint8, "I;16": np.uint16, "I": np.int32, "F": np.float32}
PIL_CASES = [(mode, comp, pred) for mode in PIL_ARRAYS
             for comp in ("raw", "tiff_deflate", "tiff_adobe_deflate", "tiff_lzw", "packbits")
             for pred in (False, True)]


def _assert_reads_as_imageio(path):
    import imageio.v3 as iio

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = iio.imread(path)
    got = tiff.read(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    shape, dtype = tiff.shape_dtype(path)
    assert shape == want.shape and dtype == want.dtype
    np.testing.assert_array_equal(tiff.decode(_bytes(path)), want)
    return got


@pytest.mark.parametrize("mode,compression,predictor", PIL_CASES)
def test_reads_pil_files_as_imageio(tmp_path, mode, compression, predictor):
    rng = np.random.default_rng(3)
    arr = (rng.poisson(40, (37, 29)) - (2000 if mode == "I" else 0)).astype(PIL_ARRAYS[mode])
    if mode == "F":
        arr = arr / np.float32(7)
    path = str(tmp_path / "pil.tif")
    _pil(path, arr, compression, predictor)
    got = _assert_reads_as_imageio(path)
    # libtiff differences integer samples for deflate and LZW only; PIL's own
    # raw and PackBits writers set the tag over undifferenced samples
    differenced = compression in ("tiff_deflate", "tiff_adobe_deflate", "tiff_lzw")
    if not predictor or (differenced and mode != "F"):
        np.testing.assert_array_equal(got, arr)


def test_reads_a_multipage_pil_file_as_imageio(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(4)
    frames = [Image.fromarray(rng.integers(0, 1000, (8, 12)).astype(np.int32))
              for _ in range(3)]
    path = str(tmp_path / "pages.tif")
    frames[0].save(path, save_all=True, append_images=frames[1:], compression="tiff_lzw")
    assert _assert_reads_as_imageio(path).shape == (3, 8, 12)


VENDORED_CASES = [(dtype, shape, order, compress, predictor, tile)
                  for dtype in ("uint8", "uint16", "int16", "int32", "float32", "float64")
                  for shape in ((40, 50), (3, 40, 50), (5, 40, 50), (40, 50, 3))
                  for order, compress, predictor, tile in (
                      (">", 0, False, None), (">", ("DEFLATE", 6), False, (16, 16)),
                      ("<", 6, True, None), ("<", ("DEFLATE", 6), True, (32, 48)),
                      ("<", 0, False, (16, 16)), (">", 6, True, (16, 16)))
                  if not (predictor and dtype.startswith("float"))]


@pytest.mark.parametrize("dtype,shape,order,compress,predictor,tile", VENDORED_CASES)
def test_reads_vendored_writer_files_as_imageio(tmp_path, dtype, shape, order, compress,
                                                predictor, tile):
    """Big-endian, deflate as 8 (an int level) and 32946, predictor 2 and
    tiles (whole and ragged), from the TIFF writer imageio vendors."""
    from imageio.plugins import _tifffile

    arr = _image(np.random.default_rng(sum(shape)), dtype, shape)
    path = str(tmp_path / "vendored.tif")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with _tifffile.TiffWriter(path, byteorder=order) as w:
            w.save(arr, compress=compress, predictor=predictor, tile=tile)
    got = _assert_reads_as_imageio(path)
    if not (predictor and order == ">"):
        # the writer's differenced big-endian samples come out in native
        # order (numpy.insert), so imageio itself does not read back `arr`
        np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("dtype", DTYPES)
def test_reads_the_jax_writer_files(tmp_path, dtype):
    img = _image(np.random.default_rng(9), dtype, (3, 16, 24))
    JI.save_image(str(tmp_path / "jax.tiff"), img)
    _assert_reads_as_imageio(str(tmp_path / "jax.tiff"))


def test_shape_dtype_reads_the_header_only(tmp_path):
    img = _image(np.random.default_rng(1), "float32", (64, 48))
    path = tmp_path / "img.tiff"
    TI.save_image(str(path), img)
    buf = _bytes(path)
    cut = tmp_path / "cut.tiff"
    cut.write_bytes(buf[:len(buf) - img.nbytes])   # the pixels cut off
    assert tiff.shape_dtype(str(cut)) == ((64, 48), np.dtype("float32"))
    with pytest.raises(ValueError):
        tiff.read(str(cut))


def test_read_image_bytes_decodes_through_the_codec():
    img = _image(np.random.default_rng(2), "int16", (2, 16, 16))
    np.testing.assert_array_equal(TD.read_image_bytes(tiff.encode(img)), img)


def _ome(n_c=3, n_z=1, n_t=1, order="XYCZT", tiffdata="", uuid=None, spp=1,
         annotations=""):
    channels = "".join(f'<Channel ID="Channel:0:{i}" Name="c{i}" SamplesPerPixel="{spp}"/>'
                       for i in range(n_c))
    root_uuid = f' UUID="{uuid}"' if uuid else ""
    return ('<?xml version="1.0" encoding="UTF-8"?>'
            f'<OME xmlns="http://www.openmicroscopy.org/Schemas/OME/2016-06"{root_uuid}>'
            f'<Image ID="Image:0" Name="img"><Pixels ID="Pixels:0" DimensionOrder="{order}" '
            f'Type="uint16" SizeX="12" SizeY="10" SizeC="{n_c}" SizeZ="{n_z}" SizeT="{n_t}">'
            f"{channels}{tiffdata}</Pixels></Image>{annotations}</OME>")


def _write_ome(path, pages, description):
    """`pages` as one page each, `description` (OME-XML) first, as the
    vendored tifffile writes them."""
    from imageio.plugins import _tifffile

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with _tifffile.TiffWriter(path) as w:
            w.save(pages, description=description, photometric="minisblack", metadata=None)
    return path


def _planes(n):
    return "".join(f'<TiffData FirstC="{i}" IFD="{i}" PlaneCount="1"/>' for i in range(n))


OWN = "urn:uuid:0f0e0d0c"
OME_CASES = {
    "no_tiffdata": (3, _ome()),                               # the generic series
    "one_tiffdata": (3, _ome(tiffdata="<TiffData/>")),
    "plane_count": (3, _ome(tiffdata='<TiffData IFD="0" PlaneCount="3"/>')),
    "per_plane": (3, _ome(tiffdata=_planes(3))),
    "reordered": (3, _ome(tiffdata="".join(f'<TiffData FirstC="{i}" IFD="{2 - i}" '
                                           f'PlaneCount="1"/>' for i in range(3)))),
    "missing_plane": (3, _ome(tiffdata='<TiffData FirstC="1" IFD="0" PlaneCount="1"/>')),
    "fewer_channels": (3, _ome(n_c=2, tiffdata="<TiffData/>")),
    "one_channel": (1, _ome(n_c=1, tiffdata="<TiffData/>")),
    "z_and_c": (6, _ome(n_z=2, tiffdata="<TiffData/>")),
    "xyzct": (6, _ome(n_z=2, order="XYZCT", tiffdata="<TiffData/>")),
    "own_uuid": (3, _ome(uuid=OWN, tiffdata=f'<TiffData IFD="0" PlaneCount="3">'
                                            f'<UUID FileName="x.ome.tif">{OWN}</UUID>'
                                            f'</TiffData>')),
    "bad_xml": (3, '<?xml version="1.0"?><OME><Image></OME>'),
    "no_image": (3, '<?xml version="1.0"?><OME></OME>'),
}


@pytest.mark.parametrize("case", sorted(OME_CASES))
@pytest.mark.parametrize("dtype", ["uint16", "float32"])
def test_reads_ome_tiffs_as_imageio(tmp_path, case, dtype):
    """An OME-XML description maps the first image's planes to pages as the
    vendored tifffile does (reversed DimensionOrder, TiffData IFD /
    PlaneCount / First*, an unmapped plane as zeros, size-1 axes squeezed);
    without a TiffData, or where the XML does not parse, the file reads as
    the generic series."""
    n_pages, xml = OME_CASES[case]
    pages = _image(np.random.default_rng(n_pages), dtype, (n_pages, 10, 12))
    _assert_reads_as_imageio(_write_ome(str(tmp_path / "img.ome.tif"), pages, xml))


def _unsupported(kind, tmp_path):
    from imageio.plugins import _tifffile
    from PIL import Image

    arr = (np.random.default_rng(0).random((20, 30)) * 200).astype(np.uint8)
    path = str(tmp_path / f"{kind}.tif")
    if kind == "jpeg":
        Image.fromarray(arr).save(path, compression="jpeg")
    elif kind == "bigtiff":
        with _tifffile.TiffWriter(path, bigtiff=True) as w:
            w.save(arr)
    elif kind == "float_predictor":
        Image.fromarray(arr.astype(np.float32)).save(
            path, compression="tiff_adobe_deflate", tiffinfo={317: 3})
    elif kind.startswith("ome"):
        pages = np.zeros((3, 10, 12), np.uint16)
        xml = {"ome_other_file": _ome(uuid=OWN, tiffdata='<TiffData IFD="0" PlaneCount="3">'
                                                         '<UUID FileName="y.ome.tif">'
                                                         'urn:uuid:other</UUID></TiffData>'),
               "ome_modulo": _ome(tiffdata="<TiffData/>", annotations=(
                   '<StructuredAnnotations><XMLAnnotation ID="Annotation:0" Namespace='
                   '"openmicroscopy.org/omero/dimension/modulo"/></StructuredAnnotations>')),
               "ome_samples": _ome(n_c=1, spp=3, tiffdata="<TiffData/>")}[kind]
        _write_ome(path, pages, xml)
    return path


@pytest.mark.parametrize("kind,match", [("jpeg", "Compression 7"),
                                        ("bigtiff", "version 43"),
                                        ("float_predictor", "Predictor 3"),
                                        ("ome_other_file", "UUID 'urn:uuid:other'"),
                                        ("ome_modulo", "modulo"),
                                        ("ome_samples", "SamplesPerPixel 3")])
def test_unsupported_files_raise_naming_the_tag(tmp_path, kind, match):
    path = _unsupported(kind, tmp_path)
    with pytest.raises(ValueError, match=match):
        tiff.read(path)
    with pytest.raises(ValueError, match=match):
        tiff.shape_dtype(path)


@pytest.mark.parametrize("codec", ["lzw", "packbits"])
def test_decompressors_round_trip_a_large_page(tmp_path, codec):
    """A 256² uint16 page of Poisson counts through PIL's LZW and PackBits
    encoders (several strips, long runs and table resets)."""
    arr = np.random.default_rng(6).poisson(3, (256, 256)).astype(np.uint16)
    arr[:40] = 7                                       # long runs
    path = str(tmp_path / "big.tif")
    _pil(path, arr, {"lzw": "tiff_lzw", "packbits": "packbits"}[codec], False)
    np.testing.assert_array_equal(_assert_reads_as_imageio(path), arr)


def test_writes_reject_what_imageio_rejects():
    for bad in (np.zeros((0, 4), np.uint8), np.zeros(5, np.uint8),
                np.zeros((2, 2, 2, 2), np.uint8), np.zeros((2, 2), np.complex64)):
        with pytest.raises(ValueError):
            tiff.encode(bad)


@pytest.mark.parametrize("name", ["img.png", "img.jpg", "img.jpeg", "img", "img.tif.gz"])
def test_save_image_refuses_names_other_than_tiff(tmp_path, name):
    with pytest.raises(ValueError, match="TIFF only"):
        TI.save_image(str(tmp_path / name), np.zeros((4, 4), np.uint8))
    assert not (tmp_path / name).exists()
    TI.save_image(str(tmp_path / "IMG.TIF"), np.zeros((4, 4), np.uint8))


def test_stitching_refuses_png_tiles_before_writing(tmp_path):
    """The JAX package stitches PNG tiles through imageio; the port reads
    TIFF only, and says so before it makes the stitched directory."""
    from ark_tpu_torch.utils import data_utils as TDU

    for fov in ("R1C1", "R1C2"):
        (tmp_path / "imgs" / fov).mkdir(parents=True)
        (tmp_path / "imgs" / fov / "chan0.png").write_bytes(b"\x89PNG\r\n")
    with pytest.raises(ValueError, match="chan0.png: the port reads and writes TIFF only"):
        TDU.stitch_images_by_shape(str(tmp_path / "imgs"), str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()


# --- one FOV read into planes (load_utils.load_fov_planes over tiff.read_into)

def _strip_file(path, arr, rows):
    """An uncompressed little-endian page of `arr` in strips of `rows` rows,
    the strips laid out in the file last to first."""
    arr = np.ascontiguousarray(arr, "<" + arr.dtype.char)
    h, w = arr.shape
    strips = [arr[i:i + rows].tobytes() for i in range(0, h, rows)]
    n = len(strips)
    assert n > 1
    tags = 10
    arrays_at = 8 + 2 + 12 * tags + 4
    at, offsets = arrays_at + 8 * n, [0] * n
    for i in reversed(range(n)):
        offsets[i] = at
        at += len(strips[i])

    def entry(code, typ, count, value):
        return struct.pack("<HHI", code, typ, count) + struct.pack(
            "<H2x" if typ == 3 else "<I", value)
    ifd = struct.pack("<H", tags) + b"".join((
        entry(256, 4, 1, w), entry(257, 4, 1, h), entry(258, 3, 1, 8 * arr.itemsize),
        entry(259, 3, 1, 1), entry(262, 3, 1, 1), entry(273, 4, n, arrays_at),
        entry(277, 3, 1, 1), entry(278, 4, 1, rows), entry(279, 4, n, arrays_at + 4 * n),
        entry(339, 3, 1, {"u": 1, "i": 2, "f": 3}[arr.dtype.kind]))) + struct.pack("<I", 0)
    with open(path, "wb") as f:
        f.write(b"II*\0" + struct.pack("<I", 8) + ifd
                + struct.pack(f"<{n}I", *offsets)
                + struct.pack(f"<{n}I", *(len(s) for s in strips))
                + b"".join(reversed(strips)))


def _channel_file(path, writer, dtype, rng):
    from imageio.plugins import _tifffile

    os.makedirs(os.path.dirname(path), exist_ok=True)
    arr = _image(rng, dtype, (30, 20) if writer == "small" else (37, 29))
    if arr.dtype.kind == "f":
        arr.flat[:2] = (np.nan, -0.0)
    if writer in ("port", "small"):
        tiff.write(path, arr)
    elif writer == "big":
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with _tifffile.TiffWriter(path, byteorder=">") as w:
                w.save(arr)
    elif writer == "strips":
        _strip_file(path, arr, rows=5)
    else:
        _pil(path, arr, {"lzw": "tiff_lzw", "deflate": "tiff_deflate",
                         "predictor": "tiff_lzw"}[writer], writer == "predictor")


# case: (a (writer, dtype) a channel, files read straight into the promoted
# stack, into a float32 one); "port" is the port's writer (one native strip),
# "small" the same at 30 x 20 in a 37 x 29 FOV (zero-padded), "strips" 8
# native strips of 5 rows laid out last to first, "big" big-endian
PLANAR_CASES = {
    "float32": ([("port", "float32")] * 3, 3, 3),
    "uint16": ([("port", "uint16")] * 3, 3, 0),
    "int32": ([("port", "int32")] * 3, 3, 0),
    "float64": ([("port", "float64")] * 3, 3, 0),
    "uint8_uint16": ([("port", "uint8"), ("port", "uint16"), ("port", "uint8")], 1, 0),
    "int64_uint64": ([("port", "int64"), ("port", "uint64"), ("port", "int64")], 0, 0),
    "big_endian": ([("big", "float32")] * 3, 0, 0),
    "lzw": ([("lzw", "float32")] * 3, 0, 0),
    "deflate": ([("deflate", "float32")] * 3, 0, 0),
    "multi_strip": ([("strips", "float32")] * 3, 3, 3),
    "predictor_2": ([("predictor", "uint16")] * 3, 0, 0),
    "ragged": ([("port", "float32"), ("small", "float32"), ("port", "float32")], 2, 2),
}


@pytest.mark.parametrize("case", list(PLANAR_CASES))
def test_fov_planes_are_the_tree_loader_transposed(tmp_path, case):
    """``load_fov_planes`` returns ``load_imgs_from_tree``'s array of the
    FOV transposed channel-first, bit for bit (NaN and -0.0 included; the
    dtype in native byte order), and into a float32 stack whatever
    ``np.asarray(..., np.float32)`` of that array holds, each value cast
    through the promoted dtype (int64 with uint64 rounds twice, through
    float64). It counts the files read straight into their planes."""
    from ark_tpu_torch.io import load_utils as TL

    specs, direct, direct_f32 = PLANAR_CASES[case]
    rng = np.random.default_rng(len(case))
    names = ["ch10", "ch2", "ch1"]
    for name, (writer, dtype) in zip(names, specs):
        _channel_file(str(tmp_path / "fov0" / f"{name}.tiff"), writer, dtype, rng)
    data_dir = str(tmp_path)
    for channels in (None, ["ch1", "ch2.tiff"]):
        want = TL.load_imgs_from_tree(data_dir, fovs=["fov0"], channels=channels)
        ref = want.values[0].transpose(2, 0, 1)
        stack, got_names, n_direct, n_decoded = TL.load_fov_planes(
            data_dir, "fov0", channels=channels)
        assert got_names == list(want.coords["channels"])
        assert stack.dtype == ref.dtype.newbyteorder("=") and stack.flags.c_contiguous
        assert stack.tobytes() == np.ascontiguousarray(ref, stack.dtype).tobytes()
        f32, _, f32_direct, f32_decoded = TL.load_fov_planes(
            data_dir, "fov0", channels=channels,
            empty=lambda shape, _: np.full(shape, np.nan, np.float32))
        assert f32.tobytes() == np.ascontiguousarray(
            np.asarray(want.values[0], np.float32).transpose(2, 0, 1)).tobytes()
        if channels is None:
            assert (n_direct, n_decoded) == (direct, 3 - direct)
            assert (f32_direct, f32_decoded) == (direct_f32, 3 - direct_f32)
        else:
            assert n_direct + n_decoded == f32_direct + f32_decoded == 2
    if case == "ragged":                      # a channel larger than the first fits neither
        for load in (lambda: TL.load_imgs_from_tree(data_dir, fovs=["fov0"],
                                                    channels=["ch2", "ch10"]),
                     lambda: TL.load_fov_planes(data_dir, "fov0", channels=["ch2", "ch10"])):
            with pytest.raises(ValueError, match="broadcast"):
                load()


def test_read_into_opens_one_read_span_a_file(tmp_path):
    from ark_tpu_torch.utils import profiling

    rng = np.random.default_rng(5)
    for writer in ("port", "lzw"):
        path = str(tmp_path / f"{writer}.tiff")
        _channel_file(path, writer, "float32", rng)
        plane = np.empty((37, 29), np.float32)
        profiling.reset()
        try:
            with profiling.recording():
                direct = tiff.read_into(path, plane)
            (span,) = profiling.spans()
        finally:
            profiling.reset()
        assert direct == (writer == "port")
        assert span["name"] == "tiff.read"
        assert span["attrs"] == {"bytes": os.path.getsize(path)}
        assert plane.tobytes() == tiff.read(path).astype(np.float32).tobytes()
