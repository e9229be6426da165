"""The share of the traced window in which no kernel, copy or set ran on the
device (device), in percent, from torch.profiler's trace in the run's own
process."""


def read(rec):
    if not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
