"""A minimal labeled N-d array: the port's copy of
``ark_tpu/utils/labeled_array.py``.

The reference returns `xarray.DataArray` objects from its loaders and its
quantification; xarray is absent here and on the card's machine, so the
API boundary uses this small container: named dims, per-dim coordinate
labels, `.sel()`/`.isel()`/`.loc` selection, zero-copy `.values`, and the
JAX package's persistence: classic netCDF (the reference's `*_dist_mat.xr`
format, through the port's ``utils/netcdf3.py``) and its legacy HDF5
layout (h5py is imported only by the two HDF5 methods).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Union

import numpy as np


def _as_list(x) -> list:
    if isinstance(x, (list, tuple)):
        return list(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    return [x]


class DataArray:
    """N-d array with named dims and coordinate labels along each dim."""

    def __init__(self, values, coords: Union[Dict[str, Sequence], Sequence] = None,
                 dims: Sequence[str] = None, name: str = None):
        values = np.asarray(values)
        if dims is None and isinstance(coords, dict):
            dims = list(coords.keys())
        if dims is None:
            dims = [f"dim_{i}" for i in range(values.ndim)]
        if isinstance(coords, (list, tuple)):
            coords = {d: c for d, c in zip(dims, coords)}
        coords = coords or {}
        if len(dims) != values.ndim:
            raise ValueError(f"got {len(dims)} dims for array of rank {values.ndim}")
        self.values = values
        self.dims = tuple(dims)
        self.name = name
        self.coords: Dict[str, np.ndarray] = {}
        for i, d in enumerate(self.dims):
            c = coords.get(d)
            if c is None:
                c = np.arange(values.shape[i])
            c = np.asarray(c)
            if len(c) != values.shape[i]:
                raise ValueError(
                    f"coord '{d}' has length {len(c)} but axis is {values.shape[i]}")
            self.coords[d] = c

    # ---- basic protocol ----
    @property
    def shape(self):
        return self.values.shape

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def ndim(self):
        return self.values.ndim

    def __array__(self, dtype=None):
        return self.values if dtype is None else self.values.astype(dtype)

    def __len__(self):
        return len(self.values)

    def __repr__(self):
        cs = ", ".join(f"{d}: {self.values.shape[i]}" for i, d in enumerate(self.dims))
        return f"<ark_tpu_torch.DataArray ({cs}) dtype={self.dtype}>"

    def __eq__(self, other):
        vals = other.values if isinstance(other, DataArray) else other
        return self.values == vals

    def _index_of(self, dim: str, label) -> Any:
        coord = self.coords[dim]
        if isinstance(label, (list, tuple, np.ndarray)):
            lut = {v: i for i, v in enumerate(coord.tolist())}
            try:
                return np.array([lut[v] for v in _as_list(label)])
            except KeyError as e:
                raise KeyError(f"label {e} not found in coord '{dim}'")
        matches = np.nonzero(coord == label)[0]
        if len(matches) == 0:
            raise KeyError(f"label {label!r} not found in coord '{dim}'")
        return int(matches[0])

    # ---- selection ----
    def sel(self, indexers: Dict[str, Any] = None, **kw) -> "DataArray":
        """Label-based selection along named dims (scalar labels drop the dim)."""
        indexers = dict(indexers or {}, **kw)
        return self.isel({dim: self._index_of(dim, label)
                          for dim, label in indexers.items()})

    def isel(self, indexers: Dict[str, Any] = None, **kw) -> "DataArray":
        """Integer-position selection along named dims (scalar positions
        drop the dim)."""
        indexers = dict(indexers or {}, **kw)
        out_vals = self.values
        out_dims: List[str] = list(self.dims)
        out_coords = dict(self.coords)
        for dim, idx in indexers.items():
            ax = out_dims.index(dim)
            out_vals = np.take(out_vals, idx, axis=ax)
            if isinstance(idx, (list, np.ndarray)):
                out_coords[dim] = np.asarray(self.coords[dim])[idx]
            else:
                out_dims.pop(ax)
                out_coords.pop(dim)
        return DataArray(out_vals, coords={d: out_coords[d] for d in out_dims},
                         dims=out_dims, name=self.name)

    class _Loc:
        def __init__(self, da):  # positional-label indexing like xr .loc
            self.da = da

        def __getitem__(self, key):
            if not isinstance(key, tuple):
                key = (key,)
            indexers = {}
            for d, k in zip(self.da.dims, key):
                if isinstance(k, slice):
                    if k != slice(None):
                        raise NotImplementedError("label slices not supported")
                    continue
                indexers[d] = k
            return self.da.sel(indexers)

        def __setitem__(self, key, value):
            if not isinstance(key, tuple):
                key = (key,)
            idx = []
            list_axes = []
            for ax, (d, k) in enumerate(zip(self.da.dims, key)):
                if isinstance(k, slice):
                    idx.append(k)
                else:
                    resolved = self.da._index_of(d, k)
                    if isinstance(resolved, (list, np.ndarray)):
                        list_axes.append(ax)
                    idx.append(resolved)
            if len(list_axes) > 1:
                # xarray .loc semantics: several label lists select their
                # outer product, where numpy fancy indexing would pair them
                full = [np.arange(n)[i] if isinstance(i, slice)
                        else np.atleast_1d(i)
                        for i, n in zip(idx, self.da.values.shape)]
                self.da.values[np.ix_(*full)] = value
                return
            self.da.values[tuple(idx)] = value

    @property
    def loc(self):
        return DataArray._Loc(self)

    # ---- persistence ----
    def to_netcdf(self, path: str):
        """Write as classic netCDF (CDF-2, 64-bit offsets) with xarray's
        single-DataArray conventions: the byte format of the reference's
        `to_netcdf(format='NETCDF3_64BIT')`
        (`src/ark/analysis/spatial_analysis_utils.py:55-60`), so real
        xarray and the JAX package open these files and vice versa."""
        from ark_tpu_torch.utils import netcdf3
        netcdf3.write(path, self.values, list(self.dims),
                      {d: np.asarray(c) for d, c in self.coords.items()},
                      name=self.name)

    def to_h5(self, path: str):
        import h5py
        with h5py.File(path, "w") as f:
            f.create_dataset("values", data=self.values)
            f.attrs["dims"] = list(self.dims)
            if self.name:
                f.attrs["name"] = self.name
            for d, c in self.coords.items():
                c = np.asarray(c)
                if c.dtype.kind in "UO":
                    # h5py's variable-length utf-8 string dtype: a bare
                    # astype('S') is ASCII-only and fails on marker names
                    # like αSMA
                    f.create_dataset(
                        f"coords/{d}", data=[str(v) for v in c],
                        dtype=h5py.string_dtype(encoding="utf-8"))
                else:
                    f.create_dataset(f"coords/{d}", data=c)

    @staticmethod
    def from_file(path: str) -> "DataArray":
        """Open either on-disk layout by its magic bytes: classic netCDF
        ('CDF\\x01'/'CDF\\x02', written by `to_netcdf`, real xarray, the
        JAX package or the reference) or the legacy HDF5 layout."""
        with open(path, "rb") as f:
            magic = f.read(4)
        if magic[:3] == b"CDF":
            from ark_tpu_torch.utils import netcdf3
            values, dims, coords, name, _ = netcdf3.read(path)
            return DataArray(values, coords=coords, dims=dims, name=name)
        return DataArray._from_h5_layout(path)

    @staticmethod
    def from_h5(path: str) -> "DataArray":
        """The JAX package's reader name; opens both layouts, as
        `from_file` does."""
        return DataArray.from_file(path)

    @staticmethod
    def _from_h5_layout(path: str) -> "DataArray":
        import h5py
        with h5py.File(path, "r") as f:
            values = f["values"][:]
            dims = list(f.attrs["dims"])
            name = f.attrs.get("name")
            coords = {}
            for d in dims:
                c = f[f"coords/{d}"][:]
                if c.dtype.kind == "S":         # legacy ascii files
                    c = c.astype(str)
                elif c.dtype.kind == "O":       # vlen utf-8 strings
                    c = np.array([v.decode("utf-8") if isinstance(v, bytes)
                                  else str(v) for v in c])
                coords[d] = c
        return DataArray(values, coords=coords, dims=dims, name=name)

    def equals(self, other: "DataArray") -> bool:
        return (self.dims == other.dims
                and all(np.array_equal(self.coords[d], other.coords[d]) for d in self.dims)
                and np.array_equal(self.values, other.values))
