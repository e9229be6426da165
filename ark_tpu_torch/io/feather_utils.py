"""Feather read/write via pyarrow (the reference stores per-FOV pixel matrices
and SOM files as feather files; `cluster_helpers.py:116`, pixie stages).

Beyond the pandas round trip the reference uses, this module exposes an
arrow-Table path (`read_table`/`write_table`/`table_set_columns`): the
per-FOV pixie passes each rewrite a ~70 MB frame to add or update one or
two label columns, and converting every untouched column through pandas
both ways made host IO — not the TPU — the 100-FOV cohort bottleneck
(PERF.md endurance run). Passthrough columns stay as arrow buffers;
computed columns are converted with the same `Array.from_pandas` path
`write_feather(df)` uses, so files read back identically either way."""

from __future__ import annotations

from typing import Dict, List, Optional

import pandas as pd
import pyarrow as pa
from pyarrow import feather as _pa_feather


def write_dataframe(df: pd.DataFrame, path, compression: str = "uncompressed"):
    _pa_feather.write_feather(df, str(path), compression=compression)


def read_dataframe(path, columns: Optional[List[str]] = None) -> pd.DataFrame:
    """Read a feather file into pandas; `columns` selects a subset without
    deserializing the rest (the cluster-average and c2pc passes need 2–17
    of ~21 columns of each per-FOV frame)."""
    return _pa_feather.read_feather(str(path), columns=columns)


def read_table(path) -> pa.Table:
    """Read a feather file as an arrow Table (no pandas conversion)."""
    return _pa_feather.read_table(str(path))


def write_table(table: pa.Table, path, compression: str = "uncompressed"):
    _pa_feather.write_feather(table, str(path), compression=compression)


def table_set_columns(table: pa.Table,
                      updates: Dict[str, pd.Series]) -> pa.Table:
    """Replace-or-append columns on an arrow Table from pandas Series.

    Each Series goes through `pa.Array.from_pandas` — the exact per-column
    conversion `write_feather(DataFrame)` performs — so a file written from
    the updated table reads back (via `read_dataframe`) identically to one
    written from the equivalent updated DataFrame. Existing columns are
    replaced in place (preserving position, as DataFrame assignment does);
    new columns append at the end."""
    names = table.column_names
    for name, series in updates.items():
        arr = pa.Array.from_pandas(series)
        if name in names:
            table = table.set_column(names.index(name), name, arr)
        else:
            table = table.append_column(name, arr)
            names = table.column_names
    return table


def read_column_names(path) -> list:
    """Column names of a feather file without reading its data (the resume
    detector schema-checks every per-FOV file; a full read per FOV would
    make restart cost scale with cohort size)."""
    import pyarrow.ipc as _ipc

    with _ipc.open_file(str(path)) as reader:
        return reader.schema.names
