"""Seconds a FOV in the assignment phase over the window's jobs (host code):
the `assign` spans of `run_pixel_clustering` (the readback wait, the f64
divide, the BMU launch and the flush into the host store)."""

from portbench import spans


def read(rec):
    phases = spans.named(rec, "pixie.run", "assign")
    if not phases or not rec.get("fovs"):
        return None
    return sum(spans.seconds(s) for s in phases) / rec["fovs"]
