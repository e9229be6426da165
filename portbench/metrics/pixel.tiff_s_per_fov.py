"""Seconds in the port's TIFF codec per FOV over the window's jobs (host IO),
from the harness's TiffClock; nothing when the clock counted no call."""


def read(rec):
    if not rec.get("tiff_calls") or not rec.get("fovs"):
        return None
    return rec["tiff_s"] / rec["fovs"]
