"""Host milliseconds a FOV in the cell table's device reductions over the
window's jobs (device ops): the `quant.reduce` spans of `generate_cell_table`,
one a compartment (the uploads, both segment sums and their readback)."""

from portbench import spans


def read(rec):
    reduces = spans.named(rec, "quant.cell_table", "quant.reduce")
    if not reduces or not rec.get("fovs"):
        return None
    return 1e3 * sum(spans.seconds(s) for s in reduces) / rec["fovs"]
