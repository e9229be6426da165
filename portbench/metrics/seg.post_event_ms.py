"""Milliseconds a call in Mesmer's phases other than the forward (device
ops: normalize, maxima, markers, quantize, flood, area_filter, the phases
`seg.postprocess_ms` sums), by the device events of the window's
`mesmer.<phase>` spans, which never synchronise."""

from portbench import spans

PHASES = tuple(f"mesmer.{p}" for p in ("normalize", "maxima", "markers", "quantize",
                                        "flood", "area_filter"))


def read(rec):
    phases = [s for s in spans.window(rec, "mesmer.segment_fovs") or ()
              if s["name"] in PHASES]
    if not phases or not rec.get("calls") or any(s["device_ms"] is None for s in phases):
        return None
    return sum(s["device_ms"] for s in phases) / rec["calls"]
