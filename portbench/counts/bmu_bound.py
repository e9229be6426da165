"""The BMU search's roofline bound.

One launch maps n rows of c columns to the nearest of k nodes: 2·n·c·k
float32 operations for the distances, and n·c·4 bytes read, k·c·4 read and
n·4 written. Its bound is the larger of the operations at the f32 peak and
the bytes at the HBM rate.
"""

from __future__ import annotations

from portbench import hw


def launch_bound_s(n: int, c: int, k: int) -> float:
    flop = 2.0 * n * c * k
    nbytes = 4.0 * (n * c + k * c + n)
    return hw.bound_s(nbytes=nbytes, flop=flop, flop_per_s=hw.F32_FLOP_PER_S)
