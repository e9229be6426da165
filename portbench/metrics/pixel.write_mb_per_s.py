"""Megabytes a second of the job's table writes (host IO): the `bytes` over
the seconds of the window's `feather.write` spans (the feathers and the
stage's CSVs), 1 MB = 1e6 bytes."""

from portbench import spans


def read(rec):
    writes = spans.named(rec, "pixie.run", "feather.write")
    took = sum(spans.seconds(s) for s in writes)
    if not writes or took <= 0:
        return None
    return sum(s["attrs"].get("bytes", 0) for s in writes) / 1e6 / took
