"""Async host prefetch: overlap TIFF/feather loading with device compute.

The port's copy of ``ark_tpu/parallel/prefetch.py``. A background thread
keeps `buffer_size` loaded results ahead of the consumer, already on
`device` (the card unless the caller names another, or None to keep the
host arrays). On a CUDA device the thread copies each host array from
pinned memory on a stream of its own and records an event after the copy;
the consumer's stream waits on that event before the result is handed
over, so the copy of result i + 1 overlaps the consumer's work on result i
with no host synchronize."""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch


def _map_arrays(fn, data):
    """`fn` applied to every numpy array and tensor in `data`, through
    dicts, lists and tuples; other leaves pass unchanged."""
    if isinstance(data, (np.ndarray, torch.Tensor)):
        return fn(data)
    if isinstance(data, dict):
        return {k: _map_arrays(fn, v) for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        return type(data)(_map_arrays(fn, v) for v in data)
    return data


class PrefetchLoader:
    """Iterate `(item, load_fn(item))` with background prefetching.

    Args:
        items: the work list (e.g. FOV names).
        load_fn: host loader (e.g. TIFF tree read -> np array).
        buffer_size: number of results to keep ready ahead of the consumer.
        device: every array in a result becomes a tensor on this device
            while the consumer computes on the previous result; None hands
            the loaded results over as they are.
    """

    def __init__(self, items: Iterable, load_fn: Callable,
                 buffer_size: int = 2, device="cuda"):
        self.items = list(items)
        self.load_fn = load_fn
        self.buffer_size = max(buffer_size, 1)
        self.device = None if device is None else torch.device(device)

    def __len__(self):
        return len(self.items)

    def _to_device(self, data, stream):
        """(data on the device, the event after its copies, or None)."""
        if self.device.type != "cuda":
            return _map_arrays(lambda a: torch.as_tensor(a, device=self.device),
                               data), None

        def copy(a):
            if isinstance(a, torch.Tensor) and a.device.type != "cpu":
                return a.to(self.device)
            host = torch.as_tensor(a)
            if not host.is_pinned():
                host = host.pin_memory()
            return host.to(self.device, non_blocking=True)

        with torch.cuda.stream(stream):
            data = _map_arrays(copy, data)
            event = torch.cuda.Event()
            event.record(stream)
        return data, event

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.buffer_size)
        sentinel = object()
        error_holder = []
        stop = threading.Event()

        def producer():
            try:
                stream = None
                if self.device is not None and self.device.type == "cuda":
                    stream = torch.cuda.Stream(device=self.device)
                for item in self.items:
                    if stop.is_set():
                        return
                    data, event = self.load_fn(item), None
                    if self.device is not None:
                        data, event = self._to_device(data, stream)
                    # bounded put that notices consumer abandonment: a
                    # consumer that breaks out of the loop would otherwise
                    # leave this thread blocked forever on a full queue,
                    # pinning the loaded batch (and device buffers)
                    while not stop.is_set():
                        try:
                            q.put((item, data, event), timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except Exception as e:  # propagate to consumer
                error_holder.append(e)
            finally:
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                out = q.get()
                if out is sentinel:
                    if error_holder:
                        raise error_holder[0]
                    return
                item, data, event = out
                if event is not None:
                    # the consumer's stream waits for the copies, and the
                    # allocator keeps the copies' memory until its work on
                    # them is done
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(event)
                    _map_arrays(lambda t: t.record_stream(consumer), data)
                yield item, data
        finally:
            # consumer done or abandoned (break / GeneratorExit): release
            # the producer and drop any buffered batches
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
