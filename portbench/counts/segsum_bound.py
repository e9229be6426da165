"""The segment sum's and its plan's roofline bounds, per launch on a label
image of N pixels and S segments.

A sum of K columns reads the values of the P pixels it sums (4·P·K bytes),
every label once (4·N), each segment's box (16·S) and writes the sums
(4·S·K): P·K float32 adds, and each column of the longest segment, of L
pixels, is one chain of L dependent adds (the kernel's contract adds a
segment's pixels in order). The plan reads every label and writes the boxes
(4·N + 16·S). The bound is the largest of the bytes at the HBM rate, the adds
at the f32 peak and the chain at one add's latency at the card's top clock.
"""

from __future__ import annotations

from portbench import hw

# SM cycles of one dependent float32 add on the H100 (one warp's chain of 2^20
# adds, cycles by clock64), and the H100 SXM's top SM clock: the least time a
# chain of adds can take
FADD_LATENCY_CYCLES = 4.219
SM_HZ = 1.98e9


def launch_bound_s(kind: str, n: int, k: int, segments: int, summed: int = 0,
                   chain: int = 0) -> float:
    """Seconds at least for one launch: `kind` "sum" or "plan"; `summed`
    the pixels whose values the sum reads, `chain` its longest segment."""
    if kind == "plan":
        return hw.bound_s(nbytes=4.0 * n + 16.0 * segments)
    nbytes = 4.0 * (summed * k + n + segments * k) + 16.0 * segments
    return max(hw.bound_s(nbytes=nbytes, flop=float(summed * k)),
               chain * FADD_LATENCY_CYCLES / SM_HZ)
