"""Reading a window traced by ``torch.profiler`` in the run's own process.

The harness labels the window and the host's phases with
``record_function``; this module turns the raw events into what the
per-layer metrics read: the device's busy time (the union of kernel, copy
and set intervals), device time summed by operation name, and the idle gaps
between device operations, each named after the innermost host label that
was open at the gap's middle.
"""

from __future__ import annotations

import bisect
import contextlib

WINDOW = "portbench.window"
GAP_STEP_NS = 1_000_000


def _events(prof):
    return list(prof.profiler.kineto_results.events())


def read(prof) -> dict:
    """{"window_s", "busy_s", "device_ops": [(name, s)], "idle_gaps": [(label,
    s)], "device_s_by_name": {name: s}} of the traced window."""
    from torch.autograd import DeviceType

    events = _events(prof)
    window = [e for e in events if e.name() == WINDOW and e.device_type() != DeviceType.CUDA]
    if not window:
        raise RuntimeError("the traced window's label is missing from the trace")
    w0 = window[0].start_ns()
    w1 = w0 + window[0].duration_ns()
    device, labels = [], []
    for e in events:
        if e.name().startswith("portbench."):
            # the harness's labels; the profiler mirrors them on the device's
            # timeline, where they are no device work
            if e.device_type() != DeviceType.CUDA and e.name() != WINDOW:
                labels.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()[10:]))
        elif e.device_type() == DeviceType.CUDA:
            s, t = e.start_ns(), e.start_ns() + e.duration_ns()
            if t > w0 and s < w1:
                device.append((max(s, w0), min(t, w1), e.name()))
    device.sort()
    by_name, busy, gaps = {}, 0, []
    cur_s = cur_t = None
    last_end = w0
    for s, t, name in device:
        by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e9
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                busy += cur_t - cur_s
            if s > last_end:
                gaps.append((last_end, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
        last_end = max(last_end, t)
    if cur_t is not None:
        busy += cur_t - cur_s
    if w1 > last_end:
        gaps.append((last_end, w1))
    labels.sort()
    starts = [lab[0] for lab in labels]

    def host_label(at):
        # the innermost label open at `at`: the latest start whose span covers it
        for i in range(bisect.bisect_right(starts, at) - 1, -1, -1):
            s, t, name = labels[i]
            if t >= at:
                return name
        return "harness"

    named = {}
    for s, t in gaps:
        # each millisecond of a gap goes to what the host was doing then
        n = max(1, int((t - s) // GAP_STEP_NS))
        step = (t - s) / n
        for k in range(n):
            label = host_label(s + (k + 0.5) * step)
            named[label] = named.get(label, 0.0) + step / 1e9
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy / 1e9,
        "device_s_by_name": by_name,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(named.items(), key=lambda kv: -kv[1])[:10],
    }


@contextlib.contextmanager
def profiled(enabled: bool):
    """The profiler over the block (CPU and CUDA activity), or nothing."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def labelled(module, names):
    """Wrap module.<name> for each name with a ``record_function`` label of
    the same name; returns a function that restores the originals."""
    import torch

    saved = {}
    for name in names:
        fn = getattr(module, name)
        saved[name] = fn

        def wrapper(*args, _fn=fn, _label="portbench." + name, **kwargs):
            with torch.profiler.record_function(_label):
                return _fn(*args, **kwargs)
        setattr(module, name, wrapper)

    def restore():
        for name, fn in saved.items():
            setattr(module, name, fn)
    return restore
