"""Comparisons shared by the references: relative gaps and partitions."""

from __future__ import annotations

import numpy as np


def rel_gap(got, want) -> float:
    """max |got - want| / max |want| (0 when both are all zero)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    if got.size == 0:
        return 0.0
    scale = float(np.max(np.abs(want)))
    diff = float(np.max(np.abs(got - want)))
    if not np.isfinite(diff):
        return float("inf")
    return diff / scale if scale > 0 else (0.0 if diff == 0 else float("inf"))


def column_gap(got, want) -> float:
    """Largest gap of any column, each relative to its own largest |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    if got.size == 0:
        return 0.0
    return max(rel_gap(got[:, c], want[:, c]) for c in range(got.shape[1]))


def partition_mismatch(a, b) -> float:
    """Share of elements on which two labelings disagree as partitions:
    labels are paired greedily by overlap (each used once, 0 only with 0)
    and every element outside a pair counts."""
    a = np.asarray(a, np.int64).ravel()
    b = np.asarray(b, np.int64).ravel()
    if a.size == 0:
        return 0.0
    if a.shape != b.shape:
        return 1.0
    if min(a.min(), b.min()) < 0:
        raise ValueError("labels must be nonnegative")
    base = int(b.max()) + 1
    keys, counts = np.unique(a * base + b, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    used_a, used_b, matched = set(), set(), 0
    for i in order:
        la, lb = divmod(int(keys[i]), base)
        if la in used_a or lb in used_b or ((la == 0) != (lb == 0)):
            continue
        used_a.add(la)
        used_b.add(lb)
        matched += int(counts[i])
    return 1.0 - matched / a.size
