"""``save_figure`` of ``ark_tpu/io/misc_utils.py``, kept in the port.

The argument checks of that module (``verify_in_list``,
``verify_same_elements``, ``make_iterable``) are in
``ark_tpu_torch.utils.misc_utils``, in one copy."""

from __future__ import annotations

import os


def save_figure(save_dir: str, save_file: str, dpi: int = 300):
    """Save the current matplotlib figure under `save_dir/save_file`."""
    import matplotlib.pyplot as plt

    if not os.path.exists(save_dir):
        raise FileNotFoundError(f"save_dir {save_dir} does not exist")
    plt.savefig(os.path.join(save_dir, save_file), dpi=dpi, bbox_inches="tight")
