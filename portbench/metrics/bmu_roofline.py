"""The BMU kernel's share of its roofline (kernels), in percent: the bound of
every launch in the window (portbench/counts/bmu_bound.py) over the kernel's
device time in the trace, summed by the kernel's name."""

from portbench.counts import bmu_bound

KERNEL_NAMES = ("bmu_regs_kernel", "bmu_wide_kernel")


def read(rec):
    launches = rec.get("bmu_launches") or []
    device_s = sum(s for name, s in rec.get("device_s_by_name", {}).items()
                   if any(k in name for k in KERNEL_NAMES))
    if not launches or device_s <= 0:
        return None
    return 100.0 * sum(bmu_bound.launch_bound_s(*shape) for shape in launches) / device_s
