"""Seconds spent in the port's TIFF codec while the clock is entered.

It wraps the public functions of ``ark_tpu_torch.io.tiff`` (the outermost
call only), so it sees exactly the calls the program makes through the
module attribute; the traced run checks that it counted the reads.
"""

from __future__ import annotations

import time


class TiffClock:
    NAMES = ("read", "write", "decode", "encode", "shape_dtype", "description")

    def __init__(self):
        self.seconds = 0.0
        self.calls = 0
        self._depth = 0
        self._saved = {}

    def _wrap(self, fn):
        def timed(*args, **kwargs):
            self._depth += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self._depth -= 1
                if not self._depth:
                    self.seconds += time.perf_counter() - t0
                    self.calls += 1
        return timed

    def __enter__(self):
        from ark_tpu_torch.io import tiff

        for name in self.NAMES:
            self._saved[name] = getattr(tiff, name)
            setattr(tiff, name, self._wrap(self._saved[name]))
        return self

    def __exit__(self, *exc):
        from ark_tpu_torch.io import tiff

        for name, fn in self._saved.items():
            setattr(tiff, name, fn)
        self._saved = {}
