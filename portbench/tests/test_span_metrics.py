"""The readers of the program's spans, fed synthetic span lists: each reads
only the window's last `attempted` trees, and gives None where the program
records no spans or none of its kind."""

from __future__ import annotations

import pytest

from portbench import run as harness

MS = 1_000_000


class Spans:
    """A synthetic store: trees of (name, start ms, end ms, attrs, device ms)."""

    def __init__(self):
        self.items = []
        self.next_id = 1

    def tree(self, root, children):
        rid = self.next_id
        self.next_id += 1
        for name, t0, t1, attrs, dev in children:
            self.items.append({"name": name, "id": self.next_id, "parent": rid, "root": rid,
                               "thread": 1, "start_ns": t0 * MS, "end_ns": t1 * MS,
                               "attrs": dict(attrs), "device_ms": dev})
            self.next_id += 1
        self.items.append({"name": root, "id": rid, "parent": None, "root": rid, "thread": 1,
                           "start_ns": 0, "end_ns": 10**6 * MS, "attrs": {},
                           "device_ms": None})


@pytest.fixture
def store(monkeypatch):
    from ark_tpu_torch.utils import profiling

    spans = Spans()
    monkeypatch.setattr(profiling, "spans", lambda: [dict(s) for s in spans.items])
    return spans


def _job(spans, load_ms, assign_ms, writes):
    spans.tree("pixie.run", [("pixie.load_fov", 0, load_ms, {"fov": "fov0"}, None),
                             ("tiff.read", 0, 1, {"bytes": 10}, None),
                             ("assign", 100, 100 + assign_ms, {}, None)]
               + [("feather.write", 200, 200 + ms, {"bytes": b, "path": "x"}, None)
                  for b, ms in writes])


def test_pixel_readers(store):
    _job(store, 9000, 9000, [(10**9, 1)])       # an earlier window's job: not read
    _job(store, 300, 100, [(2_000_000, 2), (1_000_000, 1)])
    _job(store, 500, 300, [(6_000_000, 3)])
    rec = {"attempted": 2, "fovs": 8}
    assert harness.read_metric("pixel.load_s_per_fov", rec) == pytest.approx(0.8 / 8)
    assert harness.read_metric("pixel.assign_s_per_fov", rec) == pytest.approx(0.4 / 8)
    assert harness.read_metric("pixel.write_mb_per_s", rec) == pytest.approx(9.0 / 0.006)


def _call(spans, phase_ms, flood_ms, blocks):
    spans.tree("mesmer.segment_fovs",
               [(f"mesmer.{p}", 0, 1, {}, ms) for p, ms in phase_ms.items()]
               + [("watershed.flood", 0, ms, {"blocks": b, "engine": "minimax"}, None)
                  for ms, b in zip(flood_ms, blocks)])


def test_segmentation_readers(store):
    phases = {"normalize": 1.0, "forward": 50.0, "maxima": 2.0, "markers": 3.0,
              "quantize": 4.0, "flood": 100.0, "area_filter": 5.0, "readback": 7.0}
    _call(store, phases, [40, 60], [4, 6])
    _call(store, dict(phases, flood=200.0), [120], [8])
    rec = {"attempted": 2, "calls": 2}
    assert harness.read_metric("seg.post_event_ms", rec) == pytest.approx((115 + 215) / 2)
    assert harness.read_metric("seg.flood_ms_per_block", rec) == pytest.approx(220 / 18)


def test_a_phase_without_its_device_time_reads_none(store):
    _call(store, {"normalize": None, "flood": 3.0}, [5], [1])
    assert harness.read_metric("seg.post_event_ms", {"attempted": 1, "calls": 1}) is None


NEW = ["pixel.load_s_per_fov", "pixel.assign_s_per_fov", "pixel.write_mb_per_s",
       "seg.post_event_ms", "seg.flood_ms_per_block"]


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_reads_none(store, monkeypatch, name):
    rec = {"attempted": 1, "fovs": 4, "calls": 1}
    assert harness.read_metric(name, rec) is None                # no spans at all
    store.tree("other.root", [("assign", 0, 5, {}, 1.0)])
    assert harness.read_metric(name, rec) is None                # none of the cell's roots
    from ark_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")                      # a program without spans
    assert harness.read_metric(name, rec) is None
