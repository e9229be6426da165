"""Seconds a FOV in template 3's table passes over the window's jobs (host
code): the `cells.normalize`, `cells.som_avg`, `cells.consensus`,
`cells.meta_avg`, `cells.weighted` and `cells.wc_avg` spans."""

from portbench import spans

STEPS = ("cells.normalize", "cells.som_avg", "cells.consensus", "cells.meta_avg",
         "cells.weighted", "cells.wc_avg")


def read(rec):
    steps = [s for s in spans.window(rec, "cells.run") or () if s["name"] in STEPS]
    if not steps or not rec.get("fovs"):
        return None
    return sum(spans.seconds(s) for s in steps) / rec["fovs"]
