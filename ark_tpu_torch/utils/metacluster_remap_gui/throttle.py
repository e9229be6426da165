"""Trailing-edge rate limiter for GUI callbacks.

Behavioral contract (matches the reference GUI's needs,
`metacluster_remap_gui/throttle.py`): the first call in a quiet period fires
immediately; calls arriving inside the wait window replace any pending call;
the final call always executes. Implemented as a single debouncer class
scheduling trailing invocations on the running asyncio loop (ipywidgets
callbacks run inside one)."""

from __future__ import annotations

import asyncio
import functools
import time


class _Debouncer:
    def __init__(self, fn, wait: float):
        self._fn = fn
        self._wait = wait
        self._last_fired = float("-inf")
        self._pending: asyncio.Task | None = None

    def __call__(self, *args, **kwargs):
        if self._pending is not None:
            self._pending.cancel()
            self._pending = None
        remaining = self._wait - (time.monotonic() - self._last_fired)
        if remaining <= 0:
            self._fire(args, kwargs)
            return
        # only schedule a trailing call when a loop is actually RUNNING
        # (the Jupyter kernel's, where ipywidgets callbacks execute).
        # asyncio.ensure_future without one does NOT raise — it grabs or
        # creates a never-running loop via get_event_loop, silently
        # dropping the call — so probe get_running_loop explicitly and
        # degrade to firing immediately in plain scripts.
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            self._fire(args, kwargs)
            return
        self._pending = loop.create_task(
            self._fire_later(remaining, args, kwargs))

    def _fire(self, args, kwargs):
        self._last_fired = time.monotonic()
        self._fn(*args, **kwargs)

    async def _fire_later(self, delay, args, kwargs):
        await asyncio.sleep(delay)
        self._fire(args, kwargs)


def throttle(wait: float):
    """Decorator factory: limit `fn` to one call per `wait` seconds, always
    delivering the most recent call's arguments."""
    def decorator(fn):
        debouncer = _Debouncer(fn, wait)

        # wraps() must target a plain function — attributes cannot be
        # assigned on the bound `debouncer.__call__` method
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return debouncer(*args, **kwargs)

        return wrapper
    return decorator
