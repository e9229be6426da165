"""The port's TIFF codec: numpy, zlib and the standard library, no imaging package.

``write``/``encode`` lay a channels-first stack or a 2-D image out byte for
byte as imageio's legacy TIFF plugin writes it (its vendored tifffile's
``TiffWriter.save(data, contiguous=False)`` then ``close()``): one
uncompressed strip a plane, a ``{"shape": [...]}`` ImageDescription padded
with 64 NULs, Software ``tifffile.py``, a DateTime from ``now()`` (tests
patch it), the first IFD before the data and the other pages' IFDs after
it. A trailing axis or a leading one of 3 or 4 becomes an RGB(A) sample
axis, as there.

``read``/``decode`` return the array ``imageio.v3.imread`` returns for such
files and for the strip or tile layouts other writers make (raw, deflate
8 and 32946, LZW 5, PackBits 32773, horizontal predictor 2, either byte
order): the first series, whole, as the vendored tifffile forms it (an
OME-XML description's first image, its planes mapped to pages by its
TiffData elements; a shaped description's stack; else the pages that share
the first page's shape). Anything else (multi-file or modulo OME series,
several samples a pixel in an OME series, ImageJ and vendor series, other
compressions) raises a ``ValueError`` naming the tag and its value.
``shape_dtype`` reads the IFDs only. ``read_into`` reads a file into a
plane of the caller's: an uncompressed page of the plane's layout straight
from the file, any other through the decode and one copy.

``read``, ``read_into`` and ``write`` run in ``tiff.read`` and
``tiff.write`` spans whose ``bytes`` is the file's size.
"""

from __future__ import annotations

import datetime
import io
import json
import os
import struct
import sys
import xml.etree.ElementTree as etree
import zlib
from typing import BinaryIO, List, Optional, Tuple

import numpy as np

from ark_tpu_torch.utils import profiling


def now() -> datetime.datetime:
    """The writer's DateTime stamp (tests replace it to freeze the clock)."""
    return datetime.datetime.now()


# TIFF field types: struct code of one value
_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 5: "2I", 6: "b", 7: "B", 8: "h", 9: "i",
          10: "2i", 11: "f", 12: "d", 13: "I"}
_COMPRESSIONS = (1, 5, 8, 32773, 32946)
_SAMPLE_KINDS = {1: "u", 2: "i", 3: "f"}
# tags of formats whose series tifffile builds its own way
_SERIES_TAGS = {34412: "CZ_LSMINFO", 34362: "MM_Stamp", 43314: "NIHImageHeader",
                33445: "MDFileTag", 33629: "UIC2tag"}
_NAMES = {259: "Compression", 266: "FillOrder", 270: "ImageDescription",
          317: "Predictor", 32997: "ImageDepth", 32998: "TileDepth",
          339: "SampleFormat", 258: "BitsPerSample", 530: "YCbCrSubSampling"}


# --- writing -----------------------------------------------------------------


def encode(data: np.ndarray, description: Optional[str] = None) -> bytes:
    """The bytes imageio's legacy TIFF plugin writes for `data`, a 2-D image
    or a 3-D stack (native byte order; integer and float dtypes of 1-8
    bytes). A `description` (ASCII) is written as tifffile's
    ``save(description=...)`` writes it: a first ImageDescription before
    the shaped one."""
    bo = "<" if sys.byteorder == "little" else ">"
    data = np.asarray(data)
    if data.dtype.kind not in "uif" or data.dtype.itemsize not in (1, 2, 4, 8):
        raise ValueError(f"cannot write dtype {data.dtype} as TIFF")
    data = np.ascontiguousarray(data, bo + data.dtype.char)
    if data.ndim not in (2, 3) or data.size == 0:
        raise ValueError(f"cannot write an array of shape {data.shape} as one TIFF image")
    input_shape = shape = data.shape
    rgb = len(shape) == 3 and (shape[-1] in (3, 4) or shape[-3] in (3, 4))
    if rgb and shape[-1] in (3, 4):            # contiguous samples
        planar, spp = 1, shape[-1]
        norm = (1,) + shape[-3:]
    elif rgb:                                  # separate planes
        planar, spp = 2, shape[-3]
        norm = shape[-3:] + (1,)
    else:
        planar, spp = None, 1
        while len(shape) > 2 and shape[-1] == 1:
            shape = shape[:-1]
        norm = (1,) + shape[-2:] + (1,)
    norm = norm[:1] + (1,) + norm[1:]          # (planes, depth, H, W, samples)
    pages = data.size // int(np.prod(norm))
    planes, height, width = norm[0], norm[2], norm[3]
    if 8 + data.nbytes > 2 ** 31 - 1:
        raise ValueError("data too large for standard TIFF file")

    def pack(fmt, *values):
        return struct.pack(bo + fmt, *values)

    tags = []                     # (code, entry bytes, value bytes or None, once)

    def addtag(code, dtype, count, value, once=False):
        tiff_type = {"s": 2, "H": 3, "I": 4, "2I": 5}[dtype]
        raw_count = count
        if dtype == "s":
            value = value + b"\0"
            count = len(value)
            end = value.find(b"\0\0")
            raw_count = count if end < 0 else end + 1
            value = (value,)
        if len(dtype) > 1:
            count *= int(dtype[:-1])
            dtype = dtype[-1]
        entry = pack("HH", code, tiff_type) + pack("I", raw_count)
        if struct.calcsize(dtype) * count <= 4:
            entry += pack("4s", pack(f"{count}{dtype}", *value))
            tags.append((code, entry, None, once))
        else:
            tags.append((code, entry + pack("I", 0), pack(f"{count}{dtype}", *value), once))

    if description:
        addtag(270, "s", 0, description.encode("ascii"), once=True)
    shaped = json.dumps({"shape": list(input_shape)}).encode("ascii") + b"\0" * 64
    addtag(270, "s", 0, shaped, once=True)
    addtag(305, "s", 0, b"tifffile.py", once=True)
    addtag(306, "s", 0, now().strftime("%Y:%m:%d %H:%M:%S").encode("ascii"), once=True)
    addtag(259, "H", 1, (1,))
    addtag(256, "I", 1, (width,))
    addtag(257, "I", 1, (height,))
    addtag(254, "I", 1, (0,))
    addtag(339, "H", spp, ({"u": 1, "i": 2, "f": 3}[data.dtype.kind],) * spp)
    addtag(262, "H", 1, (2 if planar else 1,))
    addtag(277, "H", 1, (spp,))
    bits = data.dtype.itemsize * 8
    if planar:
        addtag(284, "H", 1, (planar,))
        addtag(258, "H", spp, (bits,) * spp)
    else:
        addtag(258, "H", 1, (bits,))
    if spp == 4:
        addtag(338, "H", 1, (1,))              # associated alpha
    addtag(282, "2I", 1, (1, 1))
    addtag(283, "2I", 1, (1, 1))
    addtag(296, "H", 1, (1,))
    strip_bytes = int(np.prod(norm[1:])) * data.dtype.itemsize
    addtag(279, "I", planes, (strip_bytes,) * planes)
    addtag(273, "I", planes, (0,) * planes)
    addtag(278, "I", 1, (height,))
    tags.sort(key=lambda t: t[0])

    fh = io.BytesIO()
    fh.write({"<": b"II", ">": b"MM"}[bo] + pack("H", 42) + pack("I", 0))
    ifd_pointer = 4
    # the first IFD, its values, then every plane's data
    pos = fh.tell()
    fh.seek(ifd_pointer)
    fh.write(pack("I", pos))
    fh.seek(pos)
    fh.write(pack("H", len(tags)))
    tag_offset = fh.tell()
    fh.write(b"".join(t[1] for t in tags))
    ifd_pointer = fh.tell()
    fh.write(pack("I", 0))
    strip_offsets_at = None
    for i, (code, _, value, _) in enumerate(tags):
        if value:
            pos = fh.tell()
            if pos % 2:
                fh.write(b"\0")
                pos += 1
            fh.seek(tag_offset + i * 12 + 8)
            fh.write(pack("I", pos))
            fh.seek(pos)
            if code == 273:
                strip_offsets_at = pos
            fh.write(value)
    data_offset = fh.tell()
    data_offset += 16 - data_offset % 16
    fh.seek(data_offset)
    fh.write(data.tobytes())
    end = fh.tell()
    i273 = next(i for i, t in enumerate(tags) if t[0] == 273)
    fh.seek(strip_offsets_at if strip_offsets_at is not None
            else tag_offset + i273 * 12 + 8)
    fh.write(pack(f"{planes}I", *(data_offset + k * strip_bytes for k in range(planes))))
    fh.seek(end)
    # the other pages' IFDs: one template whose value offsets point at its
    # first copy, with only the strip offsets patched a page
    tags = [t for t in tags if not t[3]]
    fh_pos = fh.tell()
    if fh_pos % 2:
        fh.write(b"\0")
        fh_pos += 1
    ifd = io.BytesIO()
    ifd.write(pack("H", len(tags)))
    ifd.write(b"".join(t[1] for t in tags))
    next_at = ifd.tell()
    ifd.write(pack("I", 0))
    offsets_entry = offsets_value = None
    for i, (code, _, value, _) in enumerate(tags):
        to_value = 2 + i * 12 + 8
        if value:
            pos = ifd.tell()
            if pos % 2:
                ifd.write(b"\0")
                pos += 1
            ifd.seek(to_value)
            ifd.write(pack("I", pos + fh_pos))
            ifd.seek(pos)
            ifd.write(value)
            if code == 273:
                offsets_entry, offsets_value = to_value, pos
        elif code == 273:
            offsets_entry, offsets_value = None, to_value
    if ifd.tell() % 2:
        ifd.write(b"\0")
    page_bytes = planes * strip_bytes
    for page in range(1, pages):
        pos = fh.tell()
        fh.seek(ifd_pointer)
        fh.write(pack("I", pos))
        fh.seek(pos)
        ifd_pointer = pos + next_at
        first = data_offset + page * page_bytes
        if offsets_entry is None:
            ifd.seek(offsets_value)
            ifd.write(pack("I", first))
        else:
            ifd.seek(offsets_entry)
            ifd.write(pack("I", pos + offsets_value))
            ifd.seek(offsets_value)
            ifd.write(pack(f"{planes}I", *(first + k * strip_bytes for k in range(planes))))
        fh.write(ifd.getvalue())
    return fh.getvalue()


def write(path: str, data: np.ndarray, description: Optional[str] = None) -> None:
    """Write `data` to `path` as ``encode`` lays it out."""
    with profiling.span("tiff.write") as sp:
        buf = encode(data, description)
        with open(path, "wb") as f:
            f.write(buf)
        sp.attrs["bytes"] = len(buf)


# --- reading -----------------------------------------------------------------


class _Page:
    """One IFD's tags (values as tuples, strings as bytes) and its layout."""

    def __init__(self, fh: BinaryIO, bo: str, offset: int):
        fh.seek(offset)
        (n,) = struct.unpack(bo + "H", _read(fh, 2))
        if n > 4096:
            raise ValueError(f"corrupted tag list at offset {offset}")
        raw = _read(fh, 12 * n)
        (self.next,) = struct.unpack(bo + "I", _read(fh, 4))
        self.tags = {}
        descriptions = []
        for i in range(n):
            code, typ, count = struct.unpack(bo + "HHI", raw[12 * i:12 * i + 8])
            if typ not in _TYPES:
                continue                       # a type no tag read here uses
            fmt = _TYPES[typ]
            size = struct.calcsize(fmt) * count
            value = raw[12 * i + 8:12 * i + 12]
            if size > 4:
                (at,) = struct.unpack(bo + "I", value)
                fh.seek(at)
                value = _read(fh, size)
            if fmt == "s":
                self.tags.setdefault(code, value[:count])
                if code == 270:
                    descriptions.append(value[:count].split(b"\0", 1)[0].decode(
                        "utf-8", "replace"))
            else:
                n_values = count * (2 if fmt[0] == "2" else 1)
                self.tags.setdefault(code, struct.unpack(
                    f"{bo}{n_values}{fmt[-1]}", value[:size]))
        self.bo = bo
        self.width = self._one(256)
        self.length = self._one(257)
        self.spp = self._one(277, 1)
        self.planar = self._one(284, 1)
        rgb = self._one(262, 0) == 2 or self.spp > 1
        if rgb and self.planar == 1:
            self.shape = (self.length, self.width, self.spp)
            self.axes = "YXS"
        elif rgb:
            self.shape = (self.spp, self.length, self.width)
            self.axes = "SYX"
        else:
            self.shape = (self.length, self.width)
            self.axes = "YX"
        # the first two ImageDescription tags (tifffile's description and
        # description1)
        self.description, self.description1 = (descriptions + ["", ""])[:2]

    def _one(self, code, default=None):
        value = self.tags.get(code)
        if value is None:
            if default is None:
                raise ValueError(f"required tag {code} is missing")
            return default
        return value[0]

    def _uniform(self, code, default):
        values = set(self.tags.get(code, (default,))[:self.spp])
        if len(values) != 1:
            raise ValueError(f"{_NAMES[code]} {sorted(values)} differ between samples")
        return values.pop()

    def dtype(self) -> np.dtype:
        fmt, bits = self._uniform(339, 1), self._uniform(258, 1)
        if fmt not in _SAMPLE_KINDS or bits not in (8, 16, 32, 64) or (fmt, bits) == (3, 8):
            raise ValueError(f"SampleFormat {fmt} with BitsPerSample {bits} is not supported")
        return np.dtype(f"{_SAMPLE_KINDS[fmt]}{bits // 8}")

    def check(self):
        """Raise for every layout this codec does not decode."""
        self.dtype()
        for code, ok in ((259, _COMPRESSIONS), (317, (1, 2)), (266, (1,)),
                         (32997, (1,))):
            value = self._one(code, 1)
            if value not in ok:
                raise ValueError(f"{_NAMES[code]} {value} is not supported")
        for code in (32998, 530):
            if code in self.tags:
                raise ValueError(f"{_NAMES[code]} {self.tags[code]} is not supported")

    def asarray(self, fh: BinaryIO) -> np.ndarray:
        self.check()
        dtype = self.dtype()
        typecode = self.bo + dtype.char
        compression = self._one(259, 1)
        decompress = {1: lambda chunk: chunk, 5: _lzw_decode, 8: zlib.decompress,
                      32773: _packbits_decode, 32946: zlib.decompress}[compression]
        offsets = self.tags.get(324, self.tags.get(273))
        counts = self.tags.get(325, self.tags.get(279))
        if offsets is None or counts is None:
            raise ValueError("StripOffsets or StripByteCounts is missing")
        planes, samples = (self.spp, 1) if self.planar == 2 else (1, self.spp)
        predictor = self._one(317, 1)

        def unpack(chunk):
            chunk = decompress(chunk)
            usable = len(chunk) // dtype.itemsize * dtype.itemsize
            return np.frombuffer(chunk if usable == len(chunk) else chunk[:usable], typecode)

        if 322 in self.tags:                   # tiles
            tw, tl = self._one(322), self._one(323)
            ny, nx = -(-self.length // tl), -(-self.width // tw)
            out = np.zeros((planes, ny * tl, nx * tw, samples), dtype)
            tile_shape = (tl, tw, samples)
            for i, (at, count) in enumerate(zip(offsets, counts)):
                if i >= planes * ny * nx:
                    break
                fh.seek(at)
                tile = unpack(_read(fh, count))
                if tile.size != np.prod(tile_shape):
                    full = np.zeros(int(np.prod(tile_shape)), dtype)
                    full[:min(tile.size, full.size)] = tile[:full.size]
                    tile = full
                tile = tile.reshape(tile_shape)
                if predictor == 2:
                    tile = np.cumsum(tile, axis=-2, dtype=dtype)
                p, rest = divmod(i, ny * nx)
                y, x = divmod(rest, nx)
                out[p, y * tl:(y + 1) * tl, x * tw:(x + 1) * tw] = tile
            out = out[:, :self.length, :self.width]
        else:                                  # strips
            out = np.zeros(planes * self.length * self.width * samples, dtype)
            rows = self.tags.get(278)
            rows = rows[0] if rows is not None and len(rows) == 1 else self.length
            strip_size = rows * self.width * samples
            index = 0
            for at, count in zip(offsets, counts):
                if at <= 0 or count <= 0:
                    if count > 0:
                        raise ValueError("StripOffsets holds an invalid offset")
                    continue
                fh.seek(at)
                strip = unpack(_read(fh, count))
                size = min(out.size, strip.size, strip_size, out.size - index)
                out[index:index + size] = strip[:size]
                index += size
            out = out.reshape(planes, self.length, self.width, samples)
            if predictor == 2:
                np.cumsum(out, axis=-2, dtype=dtype, out=out)
        return out.reshape(self.shape)


def _read(fh: BinaryIO, n: int) -> bytes:
    data = fh.read(n)
    if len(data) != n:
        raise ValueError("the TIFF file ends inside a tag or a strip")
    return data


def _pages(fh: BinaryIO) -> List[_Page]:
    head = _read(fh, 8)
    bo = {b"II": "<", b"MM": ">"}.get(head[:2])
    if bo is None:
        raise ValueError(f"not a TIFF file (byte order mark {head[:2]!r})")
    (version,) = struct.unpack(bo + "H", head[2:4])
    if version != 42:
        raise ValueError(f"TIFF version {version} is not supported (43 is BigTIFF)")
    (offset,) = struct.unpack(bo + "I", head[4:8])
    pages, seen = [], set()
    while offset and offset not in seen:
        seen.add(offset)
        page = _Page(fh, bo, offset)
        pages.append(page)
        offset = page.next
    if not pages:
        raise ValueError("the TIFF file holds no IFD")
    return pages


def _tag(element) -> str:
    return element.tag.rsplit("}", 1)[-1]


def _ome_series(pages: List[_Page], xml: str) -> Optional[Tuple[list, tuple]]:
    """The first image of an OME-XML description as tifffile's
    ``_ome_series`` forms it: its Pixels' planes (sizes in reversed
    DimensionOrder) mapped to this file's pages by the TiffData elements, a
    plane no TiffData maps left None (read as zeros), size-1 axes other
    than Y and X squeezed. None where tifffile falls back to the generic
    series: the XML does not parse, or no image maps a page."""
    try:
        root = etree.fromstring(xml)
    except etree.ParseError:
        return None
    own_uuid = root.attrib.get("UUID")
    images, modulo = [], None
    for element in root:
        if _tag(element) == "BinaryOnly":
            break
        if _tag(element) == "StructuredAnnotations":
            for annot in element:
                if annot.attrib.get("Namespace", "").endswith("modulo"):
                    modulo = annot.attrib["Namespace"]
        if _tag(element) == "Image":
            images.append(element)
    for element in images:
        for pixels in element:
            if _tag(pixels) != "Pixels":
                continue
            order = pixels.attrib.get("DimensionOrder")
            if order is None:
                raise ValueError("OME-XML Pixels without a DimensionOrder")
            axes = order[::-1]
            missing = [f"Size{ax}" for ax in axes if f"Size{ax}" not in pixels.attrib]
            if missing:
                raise ValueError(f"OME-XML Pixels without {', '.join(missing)}")
            shape = [int(pixels.attrib["Size" + ax]) for ax in axes]
            planes: Optional[list] = None
            for data in pixels:
                if data.tag.endswith("Channel"):
                    spp = int(data.attrib.get("SamplesPerPixel", 1))
                    if spp != 1:
                        raise ValueError(f"OME-XML Channel SamplesPerPixel {spp} "
                                         f"is not supported")
                if planes is None:
                    planes = [None] * int(np.prod(shape[:-2]))
                if not data.tag.endswith("TiffData"):
                    continue
                attr = data.attrib
                ifd = int(attr.get("IFD", 0))
                num = int(attr.get("NumPlanes", 1 if "IFD" in attr else 0))
                num = int(attr.get("PlaneCount", num))
                first = [int(attr.get("First" + ax, 0)) for ax in axes[:-2]]
                try:
                    at = int(np.ravel_multi_index(first, shape[:-2]))
                except ValueError:
                    continue                   # tifffile skips an invalid index
                for uuid in data:
                    if _tag(uuid) == "UUID":
                        if uuid.text != own_uuid:
                            raise ValueError(f"OME-XML TiffData UUID {uuid.text!r} "
                                             f"(another file) is not supported")
                        break
                if ifd < 0:
                    raise ValueError(f"OME-XML TiffData IFD {ifd} is not supported")
                for i in range(num if num else len(pages)):
                    if at + i >= len(planes) or ifd + i >= len(pages):
                        break                  # tifffile stops at the end
                    planes[at + i] = pages[ifd + i]
            if planes is None:
                raise ValueError("OME-XML Pixels without Channel or TiffData elements")
            mapped = [p for p in planes if p is not None]
            if not mapped:
                continue
            if modulo is not None:
                raise ValueError(f"OME-XML annotation Namespace {modulo!r} "
                                 f"(modulo axes) is not supported")
            key = (mapped[0].shape, mapped[0].axes, mapped[0].dtype())
            if any((p.shape, p.axes, p.dtype()) != key for p in mapped):
                raise ValueError("OME-XML series over pages of differing shape or type")
            if mapped[0].spp != 1:
                raise ValueError(f"SamplesPerPixel {mapped[0].spp} in an OME-XML "
                                 f"series is not supported")
            squeezed = tuple(n for n, ax in zip(shape, axes) if n > 1 or ax in "XY")
            if int(np.prod(squeezed)) != len(planes) * int(np.prod(key[0])):
                raise ValueError(f"OME-XML sizes {dict(zip(axes, shape))} do not "
                                 f"match {len(planes)} planes of {key[0]}")
            return planes, squeezed
    return None


def _series(pages: List[_Page]) -> Tuple[list, tuple]:
    """The first series' pages (None for a plane read as zeros) and its
    shape, as tifffile forms them."""
    first = pages[0]
    desc = first.description
    if desc[:14] == "<?xml version=" and desc[-6:] == "</OME>":
        ome = _ome_series(pages, desc)
        if ome is not None:
            return ome
    else:
        # tifffile looks for ImageJ and shaped metadata in the first two
        # descriptions
        described = [d for d in (desc, first.description1) if d] if desc else []
        for d in described:
            if d[:7] == "ImageJ=":
                raise ValueError(f"ImageDescription {d[:40]!r}... (ImageJ) "
                                 f"is not supported")
        for code, name in _SERIES_TAGS.items():
            if code in first.tags:
                raise ValueError(f"tag {code} ({name}) marks a format this codec "
                                 f"does not read")
        shaped = [d for d in described
                  if (d[:1] == "{" and '"shape":' in d) or d[:6] == "shape="]
        if shaped:
            d = shaped[0]
            if d[:6] == "shape=":
                meta = {"shape": tuple(int(s) for s in d[7:-1].split(",") if s.strip())}
            else:
                meta = json.loads(d)
            shape = tuple(int(s) for s in meta["shape"])
            if meta.get("truncated"):
                raise ValueError(f"ImageDescription {d!r}: truncated series")
            n, rest = divmod(int(np.prod(shape)), int(np.prod(first.shape)))
            if not rest:
                if n > len(pages):
                    raise ValueError(f"ImageDescription {d!r} asks for {n} pages; "
                                     f"the file has {len(pages)}")
                return pages[:max(n, 1)], shape
    key = (first.shape, first.axes)
    same = [p for p in pages if (p.shape, p.axes) == key]
    return same, (((len(same),) if len(same) > 1 else ()) + first.shape)


def _decode(fh: BinaryIO) -> np.ndarray:
    pages, shape = _series(_pages(fh))
    page = next(p for p in pages if p is not None)
    arrays = [p.asarray(fh) if p is not None else None for p in pages]
    arrays = [a if a is not None else np.zeros(page.shape, page.dtype()) for a in arrays]
    out = arrays[0] if len(arrays) == 1 else np.stack(arrays)
    return out.reshape(shape)


def decode(buf: bytes) -> np.ndarray:
    """The array ``read`` returns for a file holding `buf`."""
    return _decode(io.BytesIO(buf))


def read(path: str) -> np.ndarray:
    """The first series of the TIFF at `path`, as ``imageio.v3.imread``
    returns it."""
    with profiling.span("tiff.read") as sp, open(path, "rb") as fh:
        if sp.recorded:
            sp.attrs["bytes"] = os.fstat(fh.fileno()).st_size
        return _decode(fh)


def read_into(path: str, plane: np.ndarray, via=None) -> bool:
    """Read the TIFF at `path` into `plane`, a writable 2-D array, as
    ``plane[:] = 0; plane[:h, :w] = read(path).astype(via)`` would (no cast
    through `via` where it is None), in one ``tiff.read`` span as ``read``
    opens. True where the pixels went straight from the file into `plane`:
    one uncompressed page of `plane`'s shape in strips, no predictor, of
    `plane`'s dtype and byte order (and `via`'s), `plane` C-contiguous: one
    ``readinto`` a strip and no other copy. Any other page is decoded as
    ``read`` decodes it and copied in (False)."""
    with profiling.span("tiff.read") as sp, open(path, "rb") as fh:
        if sp.recorded:
            sp.attrs["bytes"] = os.fstat(fh.fileno()).st_size
        strips = _direct_strips(*_series(_pages(fh)), plane, via)
        if strips is not None:
            flat = plane.reshape(-1).view(np.uint8)
            at = 0
            for offset, count in strips:
                fh.seek(offset)
                if fh.readinto(flat[at:at + count]) != count:
                    raise ValueError("the TIFF file ends inside a tag or a strip")
                at += count
            return True
        fh.seek(0)
        img = _decode(fh)
    if via is not None:
        img = img.astype(via, copy=False)
    if img.shape[:2] != plane.shape:
        plane[...] = 0
    plane[:img.shape[0], :img.shape[1]] = img
    return False


def _direct_strips(pages: list, shape: tuple, plane: np.ndarray,
                   via) -> Optional[List[Tuple[int, int]]]:
    """(offset, bytes) of each strip, in the plane's order, where
    ``read_into`` reads the series straight into `plane`; else None."""
    page = pages[0]
    if (len(pages) != 1 or page is None or tuple(shape) != plane.shape
            or not plane.flags.c_contiguous or page.axes != "YX"):
        return None
    page.check()
    dtype = np.dtype(page.bo + page.dtype().char)
    if (dtype != plane.dtype or (via is not None and np.dtype(via) != dtype)
            or page._one(259, 1) != 1 or page._one(317, 1) != 1
            or {322, 324} & set(page.tags)):
        return None
    offsets, counts = page.tags.get(273), page.tags.get(279)
    rows = page.tags.get(278)
    rows = rows[0] if rows is not None and len(rows) == 1 else page.length
    if offsets is None or counts is None or rows <= 0:
        return None
    total = plane.nbytes
    strip = rows * page.width * dtype.itemsize
    want = [min(strip, total - at) for at in range(0, total, strip)]
    if (len(offsets) != len(want) or list(counts) != want
            or min(offsets) <= 0):
        return None
    return list(zip(offsets, want))


def shape_dtype(path: str) -> Tuple[tuple, np.dtype]:
    """(shape, dtype) of what ``read(path)`` returns, from the IFDs alone."""
    with open(path, "rb") as fh:
        pages, shape = _series(_pages(fh))
    pages = [p for p in pages if p is not None]
    for p in pages:
        p.check()
    return shape, pages[0].dtype()


def description(path: str) -> str:
    """The first page's ImageDescription ('' without one)."""
    with open(path, "rb") as fh:
        return _pages(fh)[0].description


# --- decompressors (tifffile's pure-Python forms) ------------------------------


def _packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        head = data[i] + 1
        i += 1
        if head < 129:
            out += data[i:i + head]
            i += head
        elif head > 129:
            if i >= n:
                break
            out += data[i:i + 1] * (258 - head)
            i += 1
    return bytes(out)


def _lzw_decode(data: bytes) -> bytes:
    """TIFF LZW: MSB-first 9-12 bit codes, early change, CLEAR 256, EOI 257.
    Ends at EOI or where a code reaches the stream's end, as tifffile does."""
    if len(data) < 4:
        raise ValueError("strip must be at least 4 characters long")
    if (data[0] << 1 | data[1] >> 7) != 256:
        raise ValueError("strip must begin with CLEAR code")
    base = [bytes([i]) for i in range(256)] + [b"", b""]
    table, result = base[:], []
    append = result.append
    n, bit_max = len(data), len(data) * 8
    buf = nbits = bitpos = pos = old = 0
    width, mask = 9, 511
    while True:
        while nbits < width:
            buf = ((buf << 8) | (data[pos] if pos < n else 0)) & 0xFFFFFF
            pos += 1
            nbits += 8
        nbits -= width
        code = (buf >> nbits) & mask
        bitpos += width
        if code == 257 or bitpos >= bit_max:
            break
        if code == 256:
            table = base[:]
            width, mask = 9, 511
            while nbits < width:
                buf = ((buf << 8) | (data[pos] if pos < n else 0)) & 0xFFFFFF
                pos += 1
                nbits += 8
            nbits -= width
            code = (buf >> nbits) & mask
            bitpos += width
            if code == 257:
                break
            if code > 255:
                raise ValueError(f"LZW code {code} right after CLEAR")
            append(table[code])
        else:
            size = len(table)
            if code < size:
                decoded = table[code]
                table.append(table[old] + decoded[:1])
            elif code == size:
                decoded = table[old] + table[old][:1]
                table.append(decoded)
            else:
                raise ValueError(f"LZW code {code} past the table ({size})")
            append(decoded)
            if size in (510, 1022, 2046):      # the table reaches 511, 1023, 2047
                width += 1
                mask = (1 << width) - 1
        old = code
    return b"".join(result)
