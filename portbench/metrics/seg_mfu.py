"""The segmentation step's share of the card's bf16 peak (network, whole
step), in percent: the published PanopticNet forward's operations per call
(portbench/counts/panoptic_flops.py) times the calls in the traced window,
over the window's seconds, over 989 TFLOP/s."""

from portbench import hw


def read(rec):
    if not rec.get("calls") or not rec.get("window_s"):
        return None
    return 100.0 * rec["call_flop"] * rec["calls"] / rec["window_s"] / hw.BF16_FLOP_PER_S
