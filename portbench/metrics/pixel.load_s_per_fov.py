"""Seconds a FOV in the program's FOV loads over the window's jobs (host IO):
the `pixie.load_fov` spans of `run_pixel_clustering`, which hold the codec's
channel reads (`tiff.read`) and the image's assembly around them."""

from portbench import spans


def read(rec):
    loads = spans.named(rec, "pixie.run", "pixie.load_fov")
    if not loads or not rec.get("fovs"):
        return None
    return sum(spans.seconds(s) for s in loads) / rec["fovs"]
