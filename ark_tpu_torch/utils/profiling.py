"""Pipeline observability: per-stage timing/throughput metrics and profiler
traces.

The port's copy of ``ark_tpu/utils/profiling.py``. Every pipeline stage can
run under `StageTimer`, which records wall time and data throughput
(pixels/s, FOVs/s) into a structured log; `trace()` wraps a block in a
torch.profiler trace, the counterpart of the JAX package's jax.profiler
trace for TensorBoard.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch


@dataclass
class StageRecord:
    name: str
    seconds: float
    items: Optional[float] = None
    unit: str = "items"

    @property
    def throughput(self) -> Optional[float]:
        if self.items is None or self.seconds == 0:
            return None
        return self.items / self.seconds

    def to_dict(self) -> Dict:
        d = {"stage": self.name, "seconds": round(self.seconds, 4)}
        if self.items is not None:
            d["items"] = self.items
            d["unit"] = self.unit
            # throughput is None for zero-duration stages (sub-resolution
            # timers); rounding None raised from StageTimer's finally
            # block, masking the stage's own result
            if self.throughput is not None:
                d["per_second"] = round(self.throughput, 2)
        return d


@dataclass
class StageTimer:
    """Collects per-stage timings; use as a context manager per stage.

    Example:
        timer = StageTimer()
        with timer.stage("blur+norm", items=n_pixels, unit="pixels"):
            run_prep(...)
        timer.report()
    """
    records: List[StageRecord] = field(default_factory=list)
    log_path: Optional[str] = None
    verbose: bool = True

    @contextlib.contextmanager
    def stage(self, name: str, items: Optional[float] = None,
              unit: str = "items"):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            rec = StageRecord(name, time.perf_counter() - t0, items, unit)
            self.records.append(rec)
            if self.verbose:
                tp = f", {rec.throughput:,.1f} {unit}/s" if rec.throughput \
                    else ""
                print(f"[stage] {name}: {rec.seconds:.3f}s{tp}")
            if self.log_path:
                with open(self.log_path, "a") as f:
                    f.write(json.dumps(rec.to_dict()) + "\n")

    def report(self) -> List[Dict]:
        return [r.to_dict() for r in self.records]

    @property
    def total_seconds(self) -> float:
        return sum(r.seconds for r in self.records)


@contextlib.contextmanager
def trace(log_dir: str, *, device="cuda"):
    """torch.profiler around a block, with the card's activity beside the
    host's unless `device` is the CPU. On exit it writes a Chrome trace
    (`<worker>.<ms>.pt.trace.json`) into `log_dir`, for chrome://tracing,
    Perfetto or TensorBoard's profiler plugin; it yields the profiler, whose
    `events()` and `key_averages()` the caller may read. A card that is
    asked for and absent raises."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError(f"trace(device={device!r}): no CUDA device")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
