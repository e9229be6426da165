"""ez_seg utilities: mask file copying, cohort-unique renumbering, Mantis
project assembly, run logs, CSV filtering. Port of
``ark_tpu/segmentation/ez_seg/ez_seg_utils.py``; host code only."""

from __future__ import annotations

import os
import pathlib
import re
import shutil
from typing import List

import numpy as np
import pandas as pd

from ark_tpu_torch.io import io_utils
from ark_tpu_torch.io.image_utils import read_image, save_image


def find_and_copy_files(mask_names: List[str], source_folder,
                        destination_folder):
    """Copy every file matching any of mask_names into destination_folder."""
    os.makedirs(destination_folder, exist_ok=True)
    for mn in mask_names:
        pattern = re.compile(f".*{re.escape(mn)}.*", re.IGNORECASE)
        files_to_copy = []
        for root, dirs, files in os.walk(source_folder):
            for file in files:
                if pattern.match(file) and \
                        str(destination_folder) not in str(root):
                    files_to_copy.append(os.path.join(root, file))
        for file_path in files_to_copy:
            shutil.copy(file_path, os.path.join(
                destination_folder, os.path.basename(file_path)))


def renumber_masks(mask_dir):
    """Relabel every mask TIFF so labels are globally unique cohort-wide."""
    mask_dir_path = pathlib.Path(mask_dir)
    io_utils.validate_paths(mask_dir_path)
    global_unique_labels = 1
    for image in mask_dir_path.rglob("*.tiff"):
        img = read_image(str(image))
        unique_labels = np.unique(img)
        global_unique_labels += len(unique_labels[unique_labels != 0])
    for image in mask_dir_path.rglob("*.tiff"):
        img = read_image(str(image))
        # relabel through a fresh output array: an in-place
        # `img[img == label] = new` merges two objects whenever a new id
        # collides with a still-pending original label (non-contiguous
        # ez_seg ids make label values exceed the label COUNT routinely)
        out = np.zeros_like(img)
        for label in np.unique(img):
            if label != 0:
                out[img == label] = global_unique_labels
                global_unique_labels += 1
        save_image(str(image), out)
    print("Relabeling Complete.")


def create_mantis_project(fovs, image_data_dir, segmentation_dir, mantis_dir):
    """Assemble a Mantis viewing folder from raw images + masks."""
    from tqdm import tqdm

    for fov in tqdm(io_utils.list_folders(image_data_dir, substrs=fovs)):
        shutil.copytree(os.path.join(image_data_dir, fov),
                        dst=os.path.join(mantis_dir, fov))
        for seg_type in io_utils.list_folders(segmentation_dir):
            for mask in io_utils.list_files(
                    os.path.join(segmentation_dir, seg_type), substrs=fov):
                shutil.copy(os.path.join(segmentation_dir, seg_type, mask),
                            dst=os.path.join(mantis_dir, fov))


def log_creator(variables_to_log: dict, base_dir: str,
                log_name: str = "config_values.txt"):
    """Write a name: value run log."""
    output_file = os.path.join(base_dir, log_name)
    with open(output_file, "w") as file:
        for variable_name, variable_value in variables_to_log.items():
            file.write(f"{variable_name}: {variable_value}\n")
    print(f"Values saved to {output_file}")


def filter_csvs_by_mask(csv_path_name, csv_substr_replace: str,
                        column_to_filter: str = "mask_type") -> None:
    """Split cell-table CSVs into one CSV per mask_type value."""
    csv_files = io_utils.list_files(csv_path_name, substrs=".csv")
    for item in csv_files:
        if csv_substr_replace not in item:
            continue
        df = pd.read_csv(os.path.join(csv_path_name, item))
        for filter_value in df[column_to_filter].unique():
            filtered_df = df[df[column_to_filter] == filter_value]
            table_type_str = item.replace(csv_substr_replace, "")
            output_csv_file = os.path.join(
                csv_path_name, "".join([f"filtered_{filter_value}",
                                        table_type_str]))
            filtered_df.to_csv(output_csv_file, index=False)
    print("Filtering of csv's complete.")
