"""Seconds a FOV in the cell table's loads over the window's jobs (host IO):
the `quant.load` spans of `generate_cell_table` (the FOV's channel TIFFs and
its masks, the codec's `tiff.read` spans inside them)."""

from portbench import spans


def read(rec):
    loads = spans.named(rec, "quant.cell_table", "quant.load")
    if not loads or not rec.get("fovs"):
        return None
    return sum(spans.seconds(s) for s in loads) / rec["fovs"]
