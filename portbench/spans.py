"""The program's own spans (``ark_tpu_torch.utils.profiling``), recorded in
the run's process while the traced window's profiler was on, for the
per-layer metrics that read them.

The window's spans are the trees of its last ``attempted`` roots of the
cell's root name, so spans that an earlier traced window of the same
process left in the store are not counted. A program without spans (an
earlier commit) or a window without such roots gives None.
"""

from __future__ import annotations


def window(rec: dict, root_name: str):
    """The spans (dicts) of the window's jobs or calls, or None."""
    try:
        from ark_tpu_torch.utils import profiling

        held = profiling.spans()
    except (ImportError, AttributeError):
        return None
    n = rec.get("attempted") or 0
    roots = [s["id"] for s in held if s["parent"] is None and s["name"] == root_name]
    if not n or not roots:
        return None
    keep = set(roots[-n:])
    return [s for s in held if s["root"] in keep]


def named(rec: dict, root_name: str, name: str) -> list:
    """The window's spans called `name` ([] when there are none)."""
    return [s for s in window(rec, root_name) or () if s["name"] == name]


def seconds(span: dict) -> float:
    return (span["end_ns"] - span["start_ns"]) / 1e9
