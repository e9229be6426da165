"""Classic netCDF-3 (CDF) file format, pure numpy: the port's copy of
``ark_tpu/utils/netcdf3.py``, for `*_dist_mat.xr` files.

The reference persists per-FOV distance matrices with
`xarray.DataArray.to_netcdf(path, format='NETCDF3_64BIT')`
(`src/ark/analysis/spatial_analysis_utils.py:55-60`) and loads them with
`xr.load_dataarray` (`neighborhood_analysis.py:92`). That is the classic
CDF binary format, version byte 2 (64-bit offsets), not netCDF-4/HDF5, so
files this module writes open in real xarray and in the JAX package, and
files either of them wrote load here.

Implements the subset the dist-mat contract needs, with xarray's
conventions on top:

- header: magic 'CDF\\x02', numrecs, dim/gatt/var lists per the spec
  (https://docs.unidata.ucar.edu/netcdf-c classic format spec)
- non-record variables only (dist matrices have no unlimited dim)
- types NC_BYTE/CHAR/SHORT/INT/FLOAT/DOUBLE, big-endian, 4-byte padding
- xarray conventions: an unnamed DataArray's variable is
  '__xarray_dataarray_variable__'; int64 coords coerce to int32 (netCDF-3
  has no 64-bit ints; xarray's coerce_nc3_dtype does the same, erroring on
  overflow); unicode coords become NC_CHAR matrices over an extra
  'string{N}' dim (xarray re-joins them on read via concat_characters)
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

NC_DIMENSION = 0x0A
NC_VARIABLE = 0x0B
NC_ATTRIBUTE = 0x0C

XARRAY_UNNAMED = "__xarray_dataarray_variable__"

# nc_type -> numpy dtype (big-endian on disk). No unsigned entries:
# every unsigned dtype must pass through coerce_nc3_dtype's checked cast
# (uint8 values >= 128 would silently wrap as NC_BYTE otherwise).
_NC_TO_NP = {1: ">i1", 2: "S1", 3: ">i2", 4: ">i4", 5: ">f4", 6: ">f8"}
_NP_TO_NC = {"i1": 1, "S1": 2, "i2": 3, "i4": 4, "f4": 5, "f8": 6}


def coerce_nc3_dtype(arr: np.ndarray) -> np.ndarray:
    """xarray's netCDF-3 dtype coercion: int64->int32, uint->next signed,
    bool->int8, f16->f32; raises on values that do not fit (matching
    xarray.backends.netcdf3.coerce_nc3_dtype semantics)."""
    casts = {"int64": "int32", "uint64": "int32", "uint32": "int32",
             "uint16": "int16", "uint8": "int8", "bool": "int8",
             "float16": "float32"}
    new = casts.get(str(arr.dtype))
    if new is None:
        return arr
    out = arr.astype(new)
    # value-level comparison, NOT a cast-back round trip: uint8 200 ->
    # int8 -56 -> uint8 200 wraps invertibly, so a round-trip check
    # cannot detect overflow. == promotes to a common wide dtype.
    wide = np.float64 if out.dtype.kind == "f" else np.int64
    if not (out.astype(wide) == arr.astype(wide)).all():
        raise ValueError(
            f"could not safely cast {arr.dtype} to {new} for netCDF-3")
    return out


def _pad4(n: int) -> int:
    return (4 - n % 4) % 4


def _pack_name(name: str) -> bytes:
    b = name.encode("utf-8")
    return struct.pack(">i", len(b)) + b + b"\x00" * _pad4(len(b))


def _pack_values(arr: np.ndarray) -> Tuple[int, bytes]:
    """(nc_type, padded big-endian bytes) for an array."""
    arr = coerce_nc3_dtype(np.asarray(arr))
    kind_key = arr.dtype.str.lstrip("<>|=")
    if kind_key not in _NP_TO_NC:
        raise TypeError(f"dtype {arr.dtype} is not representable in netCDF-3")
    nc_type = _NP_TO_NC[kind_key]
    raw = arr.astype(_NC_TO_NP[nc_type]).tobytes()
    return nc_type, raw + b"\x00" * _pad4(len(raw))


def _str_coord_to_chars(c: np.ndarray) -> Tuple[np.ndarray, int]:
    """Unicode coord -> (n, maxlen) 'S1' char matrix + the char-dim width
    (xarray's encoding for strings in netCDF-3)."""
    enc = [str(v).encode("utf-8") for v in c]
    width = max((len(e) for e in enc), default=1) or 1
    out = np.zeros((len(enc), width), dtype="S1")
    for i, e in enumerate(enc):
        out[i, :len(e)] = np.frombuffer(e, dtype="S1")
    return out, width


class _Var:
    __slots__ = ("name", "dims", "arr", "nc_type", "payload", "begin")

    def __init__(self, name, dims, arr):
        self.name = name
        self.dims = list(dims)
        self.nc_type, self.payload = _pack_values(arr)
        self.arr = arr
        self.begin = 0


def write(path: str, values: np.ndarray, dims: List[str],
          coords: Dict[str, np.ndarray], name: Optional[str] = None,
          version: int = 2) -> None:
    """Write one data variable + its coordinate variables as classic
    netCDF (version 2 = 64-bit offsets, the reference's NETCDF3_64BIT)."""
    values = np.asarray(values)
    if len(dims) != values.ndim:
        raise ValueError(f"{len(dims)} dims for rank-{values.ndim} values")

    dim_order: List[Tuple[str, int]] = list(zip(dims, values.shape))
    variables: List[_Var] = []
    for d, size in zip(dims, values.shape):
        c = np.asarray(coords[d])
        if len(c) != size:
            raise ValueError(f"coord '{d}' length {len(c)} != axis {size}")
        if c.dtype.kind in "UO":
            chars, width = _str_coord_to_chars(c)
            char_dim = f"string{width}"
            if char_dim not in [n for n, _ in dim_order]:
                dim_order.append((char_dim, width))
            variables.append(_Var(d, [d, char_dim], chars))
        else:
            variables.append(_Var(d, [d], c))
    variables.append(_Var(name or XARRAY_UNNAMED, list(dims), values))

    dim_ids = {n: i for i, (n, _) in enumerate(dim_order)}
    header = [b"CDF", bytes([version]), struct.pack(">i", 0)]  # numrecs=0
    header.append(struct.pack(">ii", NC_DIMENSION, len(dim_order)))
    for dname, dsize in dim_order:
        header.append(_pack_name(dname) + struct.pack(">i", dsize))
    header.append(struct.pack(">ii", 0, 0))  # no global attributes

    # variable headers need data offsets: lay out payloads after the header
    header.append(struct.pack(">ii", NC_VARIABLE, len(variables)))
    begin_fmt = ">q" if version == 2 else ">i"
    var_headers = []
    for v in variables:
        vh = [_pack_name(v.name), struct.pack(">i", len(v.dims))]
        vh += [struct.pack(">i", dim_ids[d]) for d in v.dims]
        vh.append(struct.pack(">ii", 0, 0))  # no variable attributes
        vsize = min(len(v.payload), 2 ** 32 - 1)  # spec: clamp, readers
        vh.append(struct.pack(">i", v.nc_type))   # recompute from dims
        vh.append(struct.pack(">I", vsize))
        var_headers.append(b"".join(vh))
    fixed = sum(len(b) for b in header) + sum(len(b) for b in var_headers) \
        + len(variables) * struct.calcsize(begin_fmt)
    offset = fixed
    for v in variables:
        v.begin = offset
        offset += len(v.payload)

    # atomic: a killed run must not leave a truncated file that resume
    # logic (ensure_dist_matrices' exists-check) would treat as complete
    tmp = path + ".tmp-nc3"
    with open(tmp, "wb") as f:
        for b in header:
            f.write(b)
        for v, vh in zip(variables, var_headers):
            f.write(vh)
            f.write(struct.pack(begin_fmt, v.begin))
        for v in variables:
            f.write(v.payload)
    os.replace(tmp, path)


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def i4(self) -> int:
        (v,) = struct.unpack_from(">i", self.buf, self.pos)
        self.pos += 4
        return v

    def u4(self) -> int:
        (v,) = struct.unpack_from(">I", self.buf, self.pos)
        self.pos += 4
        return v

    def i8(self) -> int:
        (v,) = struct.unpack_from(">q", self.buf, self.pos)
        self.pos += 8
        return v

    def name(self) -> str:
        n = self.i4()
        s = self.buf[self.pos:self.pos + n].decode("utf-8")
        self.pos += n + _pad4(n)
        return s

    def values(self) -> np.ndarray:
        nc_type = self.i4()
        n = self.i4()
        dt = np.dtype(_NC_TO_NP[nc_type])
        nbytes = n * dt.itemsize
        arr = np.frombuffer(self.buf[self.pos:self.pos + nbytes], dt).copy()
        self.pos += nbytes + _pad4(nbytes)
        return arr


def read(path: str):
    """Read a classic netCDF file (v1 or v2) written by this module, real
    xarray/scipy, or the reference. Returns
    (values, dims, coords, name, attrs); the data variable is the one that
    is not a coordinate variable (xarray single-DataArray layout). Raises
    on record (unlimited-dim) files — the dist-mat contract has none."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:3] != b"CDF" or buf[3] not in (1, 2):
        raise ValueError(f"{path}: not a classic netCDF (CDF-1/2) file")
    version = buf[3]
    r = _Reader(buf)
    r.pos = 4
    numrecs = r.i4()
    if numrecs not in (0,):
        raise NotImplementedError("record (unlimited) dimensions")

    tag, ndims = r.i4(), r.i4()
    dims: List[Tuple[str, int]] = []
    if tag == NC_DIMENSION:
        dims = [(r.name(), r.i4()) for _ in range(ndims)]
    attrs = {}
    tag, natts = r.i4(), r.i4()
    if tag == NC_ATTRIBUTE:
        for _ in range(natts):
            aname = r.name()
            attrs[aname] = r.values()
    tag, nvars = r.i4(), r.i4()
    raw_vars = {}
    var_order = []
    if tag == NC_VARIABLE:
        for _ in range(nvars):
            vname = r.name()
            vdims = [r.i4() for _ in range(r.i4())]
            vtag, vnatts = r.i4(), r.i4()
            if vtag == NC_ATTRIBUTE:
                for _ in range(vnatts):
                    r.name()
                    r.values()      # variable attrs parsed and dropped
            nc_type = r.i4()
            r.u4()                  # vsize (untrusted per spec)
            begin = r.i8() if version == 2 else r.i4()
            shape = tuple(dims[d][1] for d in vdims)
            dt = np.dtype(_NC_TO_NP[nc_type])
            nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            arr = np.frombuffer(buf[begin:begin + nbytes],
                                dt).reshape(shape).copy()
            dnames = [dims[d][0] for d in vdims]
            raw_vars[vname] = (dnames, arr)
            var_order.append(vname)

    # split coordinate variables (named after a dim) from the data variable
    dim_names = {n for n, _ in dims}
    data_names = [n for n in var_order if n not in dim_names]
    if len(data_names) != 1:
        raise ValueError(f"{path}: expected exactly one data variable, "
                         f"found {data_names}")
    vname = data_names[0]
    vdims, values = raw_vars[vname]
    coords = {}
    for d in vdims:
        if d not in raw_vars:
            continue
        cdims, carr = raw_vars[d]
        if carr.dtype.kind == "S" and carr.ndim == 2 and \
                cdims[-1].startswith("string"):
            carr = np.array([b"".join(row).decode("utf-8").rstrip("\x00")
                             for row in carr])
        coords[d] = (carr.astype(carr.dtype.newbyteorder("="))
                     if carr.dtype.byteorder == ">" else carr)
    name = None if vname == XARRAY_UNNAMED else vname
    values = values.astype(values.dtype.newbyteorder("=")) \
        if values.dtype.byteorder == ">" else values
    return values, vdims, coords, name, attrs
