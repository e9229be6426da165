"""Filesystem listing/validation helpers.

Re-provides the `alpineer.io_utils` surface the reference leans on everywhere
(SURVEY.md §1 L0: list_files, list_folders, validate_paths,
remove_file_extensions), built fresh for this framework.
"""

from __future__ import annotations

import os
import pathlib
import re
import warnings
from typing import List, Union


def _natsort_key(s: str):
    """Natural-order sort key ('fov2' < 'fov10')."""
    return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", s)]


def natsorted(items):
    return sorted(items, key=lambda s: _natsort_key(str(s)))


def validate_paths(paths: Union[str, List[Union[str, pathlib.Path]]]):
    """Verify that every path exists; raise FileNotFoundError naming the missing one."""
    if not isinstance(paths, (list, tuple)):
        paths = [paths]
    for p in paths:
        if not os.path.exists(str(p)):
            raise FileNotFoundError(
                f"The path {p} does not exist. Check that it was specified correctly.")


def list_files(dir_name, substrs=None, exact_match: bool = False,
               ignore_hidden: bool = True) -> List[str]:
    """List files in `dir_name` whose names contain (or exactly match, sans
    extension) one of `substrs`. Natural-sorted."""
    files = [f for f in os.listdir(dir_name)
             if os.path.isfile(os.path.join(dir_name, f))]
    if ignore_hidden:
        files = [f for f in files if not f.startswith(".")]
    if substrs is not None:
        if not isinstance(substrs, (list, tuple)):
            substrs = [substrs]
        if exact_match:
            files = [f for f in files
                     if os.path.splitext(f)[0] in substrs]
        else:
            files = [f for f in files if any(s in f for s in substrs)]
    return natsorted(files)


def list_folders(dir_name, substrs=None, exact_match: bool = False,
                 ignore_hidden: bool = True) -> List[str]:
    """List subdirectories of `dir_name`, filtered like `list_files`."""
    folders = [f for f in os.listdir(dir_name)
               if os.path.isdir(os.path.join(dir_name, f))]
    if ignore_hidden:
        folders = [f for f in folders if not f.startswith(".")]
    if substrs is not None:
        if not isinstance(substrs, (list, tuple)):
            substrs = [substrs]
        if exact_match:
            folders = [f for f in folders if f in substrs]
        else:
            folders = [f for f in folders if any(s in f for s in substrs)]
    return natsorted(folders)


def remove_file_extensions(files: List[str]) -> List[str]:
    """Strip recognized file extensions; warn on unusual ones."""
    if files is None:
        return None
    known = {".tiff", ".tif", ".png", ".jpg", ".jpeg", ".tar", ".gz", ".csv",
             ".feather", ".bin", ".json", ".h5", ".h5ad", ".zarr", ".xr", ".npz"}
    names, unknown = [], set()
    for f in files:
        base, ext = os.path.splitext(f)
        if ext and ext.lower() not in known:
            unknown.add(ext)
        # always strip (alpineer contract): keeping some unknown
        # extensions but not others made name resolution depend on
        # whether the extension happened to be alphanumeric
        names.append(base)
    if unknown:
        warnings.warn(f"Unusual file extensions found: {sorted(unknown)}")
    return names


def extract_delimited_names(names: List[str], delimiter: str = "_",
                            delimiter_optional: bool = True) -> List[str]:
    """Take the prefix of each name before the first `delimiter`."""
    if names is None:
        return None
    if not delimiter_optional:
        bad = [n for n in names if delimiter not in n]
        if bad:
            raise ValueError(f"names lacking delimiter '{delimiter}': {bad}")
    return [n.split(delimiter)[0] for n in names]
