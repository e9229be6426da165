"""Seconds a FOV in template 3's cell counts over the window's jobs (host
IO): the `cells.c2pc` spans of `create_c2pc_data` (the cell-table CSV's read,
each FOV's pixel-feather columns read and counted, the join)."""

from portbench import spans


def read(rec):
    steps = spans.named(rec, "cells.run", "cells.c2pc")
    if not steps or not rec.get("fovs"):
        return None
    return sum(spans.seconds(s) for s in steps) / rec["fovs"]
