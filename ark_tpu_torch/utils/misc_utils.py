"""Argument checks of ``ark_tpu/io/misc_utils.py``, kept in the port.

``verify_in_list``, ``verify_same_elements`` and ``make_iterable`` are copies
of the JAX package's, in one copy for the whole port (``ark_tpu_torch.io``
keeps only ``save_figure`` of that module).
"""

from __future__ import annotations

import warnings
from collections.abc import Iterable
from typing import Any

import numpy as np


def make_iterable(a: Any, ignore_str: bool = True):
    """Wrap scalars in a list; pass iterables through (strings stay scalar)."""
    if isinstance(a, str) and ignore_str:
        return [a]
    if isinstance(a, Iterable) and not isinstance(a, (str, bytes)):
        return a
    if isinstance(a, type) or a is None or np.isscalar(a) or isinstance(a, bool):
        return [a]
    return a


def _fmt(vals, limit=20):
    vals = list(vals)
    shown = ", ".join(str(v) for v in vals[:limit])
    if len(vals) > limit:
        shown += f", ... ({len(vals) - limit} more)"
    return shown


def verify_in_list(warn: bool = False, **kwargs):
    """verify_in_list(provided_x=[...], accepted_x=[...]): raise (or warn)
    if any provided value is missing from the accepted list; empty lists
    raise."""
    if len(kwargs) != 2:
        raise ValueError("verify_in_list takes exactly two keyword list arguments")
    (name1, test), (name2, good) = kwargs.items()
    test_l = list(make_iterable(test))
    good_s = set(make_iterable(good))
    if len(test_l) == 0 or len(good_s) == 0:
        raise ValueError("List arguments cannot be empty")
    missing = [t for t in test_l if t not in good_s]
    if missing:
        msg = (f"Invalid value(s) provided for {name1.replace('_', ' ')}: "
               f"value(s) {_fmt(missing)} not found in {name2.replace('_', ' ')}: "
               f"{_fmt(good_s)}")
        if warn:
            warnings.warn(msg)
        else:
            raise ValueError(msg)
    return True


def verify_same_elements(enforce_order: bool = False, warn: bool = False, **kwargs):
    """verify_same_elements(list_a=[...], list_b=[...]): require equal
    element sets (and order, with `enforce_order`)."""
    if len(kwargs) != 2:
        raise ValueError("verify_same_elements takes exactly two keyword list arguments")
    (name1, l1), (name2, l2) = kwargs.items()
    l1, l2 = list(make_iterable(l1)), list(make_iterable(l2))
    s1, s2 = set(l1), set(l2)
    if s1 != s2:
        only1, only2 = s1 - s2, s2 - s1
        msg = (f"{len(only1)} value(s) in {name1} not in {name2}: {_fmt(only1)}; "
               f"{len(only2)} value(s) in {name2} not in {name1}: {_fmt(only2)}")
        if warn:
            warnings.warn(msg)
            return False
        raise ValueError(msg)
    if enforce_order and l1 != l2:
        msg = f"{name1} and {name2} have the same elements but different order"
        if warn:
            warnings.warn(msg)
            return False
        raise ValueError(msg)
    return True
