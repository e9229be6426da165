"""ark_tpu_torch.parallel.prefetch.PrefetchLoader, on the CPU: the seven
cases of tests/parallel/test_prefetch.py (order, overlap, error
propagation, device placement, empty and single lists, the buffer's floor,
an abandoned consumer), and the same results as the JAX package's loader
on the same loads. `device=None` stands for the JAX loader's default of no
`device_put`; the port's own default is the card. The CUDA stream path is a
card test (tests/test_torch_cuda.py)."""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from ark_tpu.parallel.prefetch import PrefetchLoader as JaxPrefetchLoader
from ark_tpu_torch.parallel.prefetch import PrefetchLoader


def test_yields_all_items_in_order():
    items = [f"fov{i}" for i in range(7)]
    loader = PrefetchLoader(items, lambda it: it.upper(), buffer_size=3, device=None)
    assert len(loader) == 7
    got = list(loader)
    assert [k for k, _ in got] == items
    assert [v for _, v in got] == [it.upper() for it in items]
    assert got == list(JaxPrefetchLoader(items, lambda it: it.upper(), buffer_size=3))


def test_loading_overlaps_consumption():
    """While the consumer holds result i, the producer is already loading
    ahead."""
    started = []
    gate = threading.Event()

    def load(item):
        started.append(item)
        if item >= 2:
            gate.wait(timeout=5)
        return item

    it = iter(PrefetchLoader(range(4), load, buffer_size=2, device=None))
    next(it)
    deadline = time.monotonic() + 5
    while len(started) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(started) >= 3
    gate.set()
    assert [v for _, v in it] == [1, 2, 3]


def test_producer_exception_propagates_to_consumer():
    def load(item):
        if item == 2:
            raise RuntimeError("corrupt feather")
        return item

    got = []
    with pytest.raises(RuntimeError, match="corrupt feather"):
        for _, v in PrefetchLoader(range(5), load, buffer_size=2, device=None):
            got.append(v)
    assert got == [0, 1]


def test_device_places_batches_as_tensors_on_the_device():
    """`device` takes the place of the JAX loader's `device_put`: every array
    of a result, through dicts, lists and tuples, becomes a tensor on it,
    equal to what the JAX loader hands over."""
    rng = np.random.default_rng(0)
    data = {f"f{i}": {"img": rng.random((8, 4)).astype(np.float32),
                      "masks": (rng.integers(0, 9, (8, 4)).astype(np.int32), "fov")}
            for i in range(3)}
    ref = dict(JaxPrefetchLoader(list(data), lambda k: data[k]["img"], buffer_size=2,
                                 device_put=jax.devices("cpu")[0]))
    for key, batch in PrefetchLoader(list(data), lambda k: data[k], buffer_size=2,
                                     device="cpu"):
        img, (masks, name) = batch["img"], batch["masks"]
        assert isinstance(img, torch.Tensor) and img.device.type == "cpu"
        np.testing.assert_array_equal(img.numpy(), data[key]["img"])
        np.testing.assert_array_equal(img.numpy(), np.asarray(ref[key]))
        assert masks.dtype == torch.int32 and name == "fov"


def test_empty_and_single_item_lists():
    assert list(PrefetchLoader([], lambda x: x, device=None)) == []
    assert list(PrefetchLoader(["only"], lambda x: x + "!", device=None)) == \
        [("only", "only!")]


def test_buffer_size_floor_is_one():
    loader = PrefetchLoader(range(3), lambda x: x, buffer_size=0, device=None)
    assert loader.buffer_size == 1
    assert [v for _, v in loader] == [0, 1, 2]


def test_abandoned_iteration_releases_producer():
    """A consumer that breaks early leaves no producer thread blocked on a
    full queue."""
    before = set(threading.enumerate())
    for _, v in PrefetchLoader(range(100), lambda x: x, buffer_size=2, device=None):
        if v == 1:
            break
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if not [t for t in threading.enumerate() if t not in before and t.is_alive()]:
            break
        time.sleep(0.05)
    assert not [t for t in threading.enumerate() if t not in before and t.is_alive()]


def test_cuda_device_without_a_card_raises_in_the_consumer(monkeypatch):
    """No fallback: a CUDA device that cannot be reached fails the
    iteration, through the producer's error path."""
    def no_stream(device=None):
        raise RuntimeError("no CUDA device")

    monkeypatch.setattr(torch.cuda, "Stream", no_stream)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        list(PrefetchLoader(range(3), lambda x: np.zeros(2), device="cuda"))


def test_default_device_is_the_card(monkeypatch):
    """With no `device` the loader copies to the card: the CUDA path is
    taken (here it fails, with no card), not a host hand-over."""
    def no_stream(device=None):
        raise RuntimeError("no CUDA device")

    monkeypatch.setattr(torch.cuda, "Stream", no_stream)
    loader = PrefetchLoader(range(3), lambda x: np.zeros(2))
    assert loader.device == torch.device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        list(loader)
