"""The segment-sum kernels' share of their roofline (kernels), in percent: the
bound of every walk and plan launch the window's jobs made on a label image
(portbench/counts/segsum_bound.py) over those kernels' device time in the
trace, summed by the kernels' names."""

from portbench.counts import segsum_bound

KERNEL_NAMES = ("segment_walk_kernel", "segment_background_kernel", "box_init_kernel",
                "box_kernel")


def read(rec):
    launches = rec.get("segsum_launches") or []
    device_s = sum(s for name, s in rec.get("device_s_by_name", {}).items()
                   if any(k in name for k in KERNEL_NAMES))
    if not launches or device_s <= 0:
        return None
    return 100.0 * sum(segsum_bound.launch_bound_s(*launch) for launch in launches) / device_s
