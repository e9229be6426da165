"""Template 1's segmentation entry point on PyTorch.

Port of ``ark_tpu/utils/deepcell_service_utils.py::create_deepcell_output``:
every ``<fov>.tiff`` 2-channel input is segmented by the port's in-process
Mesmer on an explicit ``device``, and ``<fov>_whole_cell.tiff`` /
``<fov>_nuclear.tiff`` int32 masks are written through the port's
``ark_tpu_torch.io``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ark_tpu_torch.io import io_utils
from ark_tpu_torch.io.image_utils import read_image, save_image
from ark_tpu_torch.utils.misc_utils import verify_in_list


def create_deepcell_output(deepcell_input_dir, deepcell_output_dir, fovs=None,
                           wc_suffix="_whole_cell", nuc_suffix="_nuclear",
                           host=None, job_type="mesmer", scale=1.0,
                           timeout=300, zip_size=5,
                           weights_path: Optional[str] = None, *, device,
                           **predict_kwargs):
    """Segment every `<fov>.tiff` input with Mesmer on `device`; save
    `<fov><wc_suffix>.tiff` / `<fov><nuc_suffix>.tiff` int32 masks.
    Previously produced masks are skipped (resume semantics). `host`,
    `job_type` and `timeout` are accepted for compatibility and ignored;
    `zip_size` is the device batch size."""
    from ark_tpu_torch.segmentation.mesmer import Mesmer

    try:
        scale = float(scale)
    except ValueError:
        raise ValueError("Scale argument must be a number")

    input_files = io_utils.list_files(deepcell_input_dir, substrs=[".tiff"])
    if fovs is None:
        fovs = input_files
    fovs = io_utils.remove_file_extensions(fovs)
    verify_in_list(fovs=fovs,
                   deepcell_input_files=io_utils.remove_file_extensions(
                       input_files))
    os.makedirs(deepcell_output_dir, exist_ok=True)

    todo = [fov for fov in fovs if not (
        os.path.exists(os.path.join(deepcell_output_dir,
                                    fov + wc_suffix + ".tiff"))
        and os.path.exists(os.path.join(deepcell_output_dir,
                                        fov + nuc_suffix + ".tiff")))]
    if not todo:
        print("All FOVs already segmented, skipping")
        return
    skipped = len(fovs) - len(todo)
    if skipped:
        print(f"Skipping {skipped} previously processed FOVs.")

    app = Mesmer(weights_path=weights_path, device=device)
    batch = max(int(zip_size), 1)
    groups = [todo[i:i + batch] for i in range(0, len(todo), batch)]
    print(f"Processing tiffs in {len(groups)} batches...")
    for fov_group in groups:
        imgs = []
        for fov in fov_group:
            img = read_image(os.path.join(deepcell_input_dir, fov + ".tiff"))
            if img.ndim == 3 and img.shape[0] == 2:   # channels-first input
                img = np.moveaxis(img, 0, -1)
            imgs.append(img.astype(np.float32) * scale)
        out = app.predict(np.stack(imgs), **predict_kwargs)
        for i, fov in enumerate(fov_group):
            save_image(os.path.join(deepcell_output_dir,
                                    fov + wc_suffix + ".tiff"),
                       out["whole_cell"][i].astype(np.int32))
            save_image(os.path.join(deepcell_output_dir,
                                    fov + nuc_suffix + ".tiff"),
                       out["nuclear"][i].astype(np.int32))
