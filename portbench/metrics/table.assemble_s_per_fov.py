"""Seconds a FOV in the cell table's assembly over the window's jobs (host
code): the `quant.assemble` spans of `generate_cell_table` (the derived
columns, the transforms and the DataFrames)."""

from portbench import spans


def read(rec):
    steps = spans.named(rec, "quant.cell_table", "quant.assemble")
    if not steps or not rec.get("fovs"):
        return None
    return sum(spans.seconds(s) for s in steps) / rec["fovs"]
