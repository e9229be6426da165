"""Milliseconds per call in Mesmer's phases other than the forward (device
ops: normalize, maxima, markers, quantize, flood, area_filter), from the
app's phase clock over calls of their own after the traced window."""


def read(rec):
    phases = rec.get("phase_s")
    if not phases or not rec.get("phase_calls"):
        return None
    return 1e3 * sum(s for k, s in phases.items() if k != "forward") / rec["phase_calls"]
