"""``ark_tpu/io/misc_utils.py`` in the port: ``save_figure`` and
``create_invalid_data_str``. The argument checks of that module
(``verify_in_list``, ``verify_same_elements``, ``make_iterable``) live in
``ark_tpu_torch.utils.misc_utils``, in one copy, and are importable from
here under the JAX package's module path."""

from __future__ import annotations

import os

from ark_tpu_torch.utils.misc_utils import (make_iterable, verify_in_list,  # noqa: F401
                                            verify_same_elements)


def save_figure(save_dir: str, save_file: str, dpi: int = 300):
    """Save the current matplotlib figure under `save_dir/save_file`."""
    import matplotlib.pyplot as plt

    if not os.path.exists(save_dir):
        raise FileNotFoundError(f"save_dir {save_dir} does not exist")
    plt.savefig(os.path.join(save_dir, save_file), dpi=dpi, bbox_inches="tight")


def create_invalid_data_str(invalid_data) -> str:
    """The first ten invalid values, one a line."""
    return "\n".join(f"{v}" for v in list(invalid_data)[:10])
