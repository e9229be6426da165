"""ark_tpu_torch.utils.profiling on the CPU: spans and traces.

A span stores nothing while recording is off; `recording()` and a torch
profiler each turn it on. Its records nest by thread (or by the parent it
was handed), survive the block's exceptions, stay within the store's cap,
and sit on the profiler's clock: within 1 ms of the profiler's own range of
the same name. `trace` writes a Chrome trace that holds the block's torch
ops and spans; asked for a card that is absent it raises. The card's own
trace and a span's device events are card tests (tests/test_torch_cuda.py).
"""

import json
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from ark_tpu_torch.utils import profiling as TP

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def empty_store():
    TP.reset()
    yield
    TP.reset()


def _by_name():
    return {s["name"]: s for s in TP.spans()}


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(TP, "_Range", lambda name: opened.append(name))
    with TP.span("outer", device="cpu", n=1) as outer:
        with TP.span("inner"):
            pass
        assert TP.current() is None
    assert TP.spans() == [] and opened == [] and TP.dropped() == 0
    assert not outer.recorded and outer.seconds >= 0 and outer.device_ms() is None


@pytest.mark.parametrize("switch", ["recording", "profiler"])
def test_recording_and_a_cpu_profiler_each_turn_it_on(switch):
    on = TP.recording() if switch == "recording" else torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with on:
        with TP.span("step", fov="fov0") as sp:
            sp.attrs["bytes"] = 12
    with TP.span("after"):
        pass
    (rec,) = TP.spans()
    assert rec["name"] == "step" and rec["attrs"] == {"fov": "fov0", "bytes": 12}
    assert rec["parent"] is None and rec["root"] == rec["id"]
    assert rec["thread"] == threading.get_ident()
    assert 0 < rec["end_ns"] - rec["start_ns"] < 10**9
    assert rec["device_ms"] is None


def test_ids_parents_and_roots_nest():
    with TP.recording():
        for _ in range(2):
            with TP.span("run"):
                with TP.span("phase"):
                    with TP.span("load"):
                        pass
                    with TP.span("write"):
                        pass
                with TP.span("flood"):
                    pass
    got = TP.spans()
    assert [s["name"] for s in got] == ["load", "write", "phase", "flood", "run"] * 2
    assert len({s["id"] for s in got}) == 10
    for call in (got[:5], got[5:]):
        load, write, phase, flood, run = call
        assert run["parent"] is None
        assert {s["root"] for s in call} == {run["id"]}
        assert phase["parent"] == flood["parent"] == run["id"]
        assert load["parent"] == write["parent"] == phase["id"]
        assert run["start_ns"] <= phase["start_ns"] <= load["start_ns"] <= load["end_ns"] \
            <= write["start_ns"] <= phase["end_ns"] <= flood["start_ns"] <= run["end_ns"]
    assert got[4]["root"] != got[9]["root"]


def test_an_exception_passes_through_and_closes_the_span():
    with TP.recording():
        with pytest.raises(ValueError, match="the step's own error"):
            with TP.span("run"):
                with TP.span("step"):
                    raise ValueError("the step's own error")
        assert TP.current() is None
        with TP.span("next"):
            pass
    got = _by_name()
    assert got["step"]["attrs"] == {"error": "ValueError"}
    assert got["run"]["attrs"] == {"error": "ValueError"}
    assert got["step"]["parent"] == got["run"]["id"]
    assert got["next"]["parent"] is None


def test_a_worker_span_records_its_thread_and_its_given_parent():
    """The pool's threads see no profiler; their spans follow the parent
    they are handed, and stay out of the caller's stack."""
    main = threading.get_ident()

    def work(i, parent):
        with TP.span("worker", parent=parent, fov=i):
            with TP.span("worker.inner"):
                return threading.get_ident()

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with TP.span("call") as call:
            with ThreadPoolExecutor(2) as pool:
                threads = list(pool.map(work, range(4), [call] * 4))
                # handed no parent, a worker thread outside `recording()`
                # sees no profiler and records nothing
                pool.submit(work, 9, None).result()
            assert TP.current() is call
    got = TP.spans()
    call_rec = [s for s in got if s["name"] == "call"][0]
    workers = sorted((s for s in got if s["name"] == "worker"), key=lambda s: s["attrs"]["fov"])
    assert [s["attrs"]["fov"] for s in workers] == [0, 1, 2, 3]
    assert [s["thread"] for s in workers] == threads and main not in threads
    assert all(s["parent"] == call_rec["id"] and s["root"] == call_rec["id"] for s in workers)
    inner = [s for s in got if s["name"] == "worker.inner"]
    assert sorted(s["parent"] for s in inner) == sorted(s["id"] for s in workers)
    assert len(got) == 9


def test_the_store_keeps_its_cap_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(TP, "MAX_RECORDS", 3)
    with TP.recording():
        for i in range(5):
            with TP.span("s", i=i):
                pass
    assert [s["attrs"]["i"] for s in TP.spans()] == [0, 1, 2]
    assert TP.dropped() == 2
    TP.reset()
    assert TP.spans() == [] and TP.dropped() == 0


def test_spans_sit_within_1ms_of_their_profiler_ranges():
    """Each span's start and end on the profiler's clock, against the range
    the profiler recorded for it."""
    import time

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with TP.span(f"step{i}"):
                torch.ones(128, 128).matmul(torch.ones(128, 128))
                with TP.span(f"inner{i}"):
                    time.sleep(0.005)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    got = TP.spans()
    assert len(got) == 6
    for s in got:
        e = events[s["name"]]
        assert not e.is_user_annotation()
        assert abs(e.start_ns() - s["start_ns"]) < 1_000_000, s["name"]
        assert abs(e.start_ns() + e.duration_ns() - s["end_ns"]) < 1_000_000, s["name"]


def test_a_cpu_device_span_reads_the_host_clock():
    with TP.recording():
        with TP.span("cpu", device=torch.device("cpu")):
            torch.ones(64, 64).sum()
        with TP.span("plain"):
            pass
    got = _by_name()
    assert got["cpu"]["device_ms"] == pytest.approx(
        (got["cpu"]["end_ns"] - got["cpu"]["start_ns"]) / 1e6)
    assert got["plain"]["device_ms"] is None


def test_threads_record_every_span_under_contention():
    """More threads than cores, a short switch interval: every span stored
    once, each parented on its own thread's open span."""
    n_threads, per = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for i in range(per):
                with TP.span("outer", t=t):
                    with TP.span("inner", t=t, i=i):
                        pass
        with TP.recording():
            threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    got = TP.spans()
    assert len(got) == 2 * n_threads * per and len({s["id"] for s in got}) == len(got)
    outer = {s["id"]: s for s in got if s["name"] == "outer"}
    for s in got:
        if s["name"] == "inner":
            parent = outer[s["parent"]]
            assert parent["thread"] == s["thread"] and parent["attrs"]["t"] == s["attrs"]["t"]
            assert s["root"] == parent["id"]


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with TP.trace(str(tmp_path), device="cpu") as prof:
        with TP.span("port.step"):
            torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    names = {e.name for e in prof.events()}
    assert "aten::matmul" in names
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)
    assert any(e.get("name") == "port.step" for e in events)
    assert [s["name"] for s in TP.spans()] == ["port.step"]


def test_trace_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with TP.trace(str(tmp_path)):
            pass
    assert os.listdir(tmp_path) == []
