"""Seconds a FOV in the cell table's hull rasters and concavity counts over
the window's jobs (host code): the `quant.convex` and `quant.concavities`
spans of `generate_cell_table`."""

from portbench import spans


def read(rec):
    steps = (spans.named(rec, "quant.cell_table", "quant.convex")
             + spans.named(rec, "quant.cell_table", "quant.concavities"))
    if not steps or not rec.get("fovs"):
        return None
    return sum(spans.seconds(s) for s in steps) / rec["fovs"]
