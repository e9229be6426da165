"""Spans of the port's own steps, and profiler traces.

`span(name, **attrs)` marks one step of a call (a pipeline phase, a FOV's
load, a file write, a flood). While recording is on it stores one record:
its name, its id, its parent (the innermost open span of the same thread,
or the one it was given), its root (shared by every span of one call), its
thread, its start and end in ns on the profiler's clock, and `attrs`, a few
ints and strings. Counts that happen at a span's boundary (bytes written,
blocks run) are attributes of that span, so a window's counts are the sum
over its spans. A span given a CUDA `device` also records a CUDA event on
the current stream at each edge; its device milliseconds are read when the
spans are read, after the caller's own synchronise. A span never
synchronises.

Recording is on inside `recording()`, whenever a torch profiler is
recording on the span's thread, and inside a recorded span (a span in a
worker thread records when the span it was given as its parent did). Under
a profiler the span also opens a profiler range of its name (a CPU range,
which the profiler does not mirror onto the device's timeline), so it sits
on the kernels' timeline in any trace. Off, a span reads the clock twice
and stores nothing; its `seconds` still time the block. `spans()` reads
the store and `reset()` empties it; it holds at most `MAX_RECORDS` records
and counts the rest in `dropped()`.

`trace()` wraps a block in a torch.profiler trace written as a Chrome trace,
the counterpart of the JAX package's jax.profiler trace for TensorBoard.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Optional

import torch

MAX_RECORDS = 1_000_000

_profiler_enabled = torch._C._autograd._profiler_enabled
# a CPU-op range: `record_function`'s user ranges are mirrored onto the
# device's timeline as device events of their own
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", None)

_lock = threading.Lock()
_records: list = []
_dropped = 0
_forced = 0
_ids = itertools.count(1)
_local = threading.local()


def _epoch_offset() -> int:
    """Epoch ns minus perf_counter ns: torch.profiler stamps its events in
    epoch ns."""
    a = time.perf_counter_ns()
    wall = time.time_ns()
    b = time.perf_counter_ns()
    return wall - (a + b) // 2


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One step; use through `span`. `seconds` is its host duration after it
    closes, `attrs` its attributes (set more of them inside the block), and
    `recorded` says whether it goes into the store."""

    __slots__ = ("name", "attrs", "device", "parent", "id", "root", "thread",
                 "offset", "t0", "t1", "recorded", "_range", "_events")

    def __init__(self, name: str, device, parent: Optional["Span"], attrs: dict):
        self.name = name
        self.attrs = attrs
        self.device = device
        self.parent = parent
        self.recorded = False
        self._range = self._events = None

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def __enter__(self) -> "Span":
        parent = self.parent if self.parent is not None else current()
        profiled = _profiler_enabled()
        if _forced or profiled or (parent is not None and parent.recorded):
            self._open(parent, profiled)
        self.t0 = time.perf_counter_ns()
        return self

    def _open(self, parent: Optional["Span"], profiled: bool):
        self.parent = parent
        self.id = next(_ids)
        if parent is None:
            # a root fixes the clock's offset for its whole tree
            self.root, self.offset = self.id, _epoch_offset()
        else:
            self.root, self.offset = parent.root, parent.offset
        self.thread = threading.get_ident()
        self.recorded = True
        _stack().append(self)
        if profiled and _Range is not None:
            self._range = _Range(self.name)
            self._range.__enter__()
        device = self.device
        if device is not False and device is not None:
            if device is True:
                device = "cuda" if torch.cuda.is_initialized() else "cpu"
            device = torch.device(device)
            if device.type == "cuda":
                stream = torch.cuda.current_stream(device)
                self._events = (stream, torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                self._events[1].record(stream)
            else:
                # work on the CPU is done when its call returns: the host
                # clock is the device's
                self._events = "host"

    def __exit__(self, exc_type, exc, tb):
        self.t1 = time.perf_counter_ns()
        if self.recorded:
            self._close(exc_type)
        return False

    def _close(self, exc_type):
        global _dropped
        if isinstance(self._events, tuple):
            self._events[2].record(self._events[0])
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        with _lock:
            if len(_records) < MAX_RECORDS:
                _records.append(self)
            else:
                _dropped += 1

    def device_ms(self) -> Optional[float]:
        """Milliseconds between the span's two events on the device's
        timeline (the host's for CPU work); None without events or before
        the device has passed the second."""
        events = self._events
        if events is None:
            return None
        if events == "host":
            return (self.t1 - self.t0) / 1e6
        if isinstance(events, float):
            return events
        _, start, end = events
        if not end.query():
            return None
        self._events = start.elapsed_time(end)
        return self._events


def span(name: str, *, device=False, parent: Optional[Span] = None, **attrs) -> Span:
    """A context manager that marks one step; it yields the `Span`.
    `device`: True for the current CUDA device, or a torch device (CUDA:
    events at both edges; CPU: the host's times). `parent`: the span that
    handed this work to another thread."""
    return Span(name, device, parent, attrs)


def current() -> Optional[Span]:
    """The innermost recorded span open on this thread, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with or without a profiler."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def spans() -> list:
    """The stored spans, oldest end first, as dicts: name, id, parent (id or
    None), root, thread, start_ns and end_ns (epoch ns, the profiler's
    clock), attrs (a copy) and device_ms (None unless the span was given a
    device)."""
    with _lock:
        held = list(_records)
    return [{"name": s.name, "id": s.id,
             "parent": s.parent.id if s.parent is not None else None,
             "root": s.root, "thread": s.thread,
             "start_ns": s.t0 + s.offset, "end_ns": s.t1 + s.offset,
             "attrs": dict(s.attrs), "device_ms": s.device_ms()} for s in held]


def dropped() -> int:
    """Spans not stored since the last `reset()` because the store was full."""
    return _dropped


def reset():
    """Empty the store and the dropped count."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


@contextlib.contextmanager
def trace(log_dir: str, *, device="cuda"):
    """torch.profiler around a block, with the card's activity beside the
    host's unless `device` is the CPU. On exit it writes a Chrome trace
    (`<worker>.<ms>.pt.trace.json`) into `log_dir`, for chrome://tracing,
    Perfetto or TensorBoard's profiler plugin; it yields the profiler, whose
    `events()` and `key_averages()` the caller may read. The port's spans
    inside the block are recorded and appear in the trace under their
    names. A card that is asked for and absent raises."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError(f"trace(device={device!r}): no CUDA device")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
