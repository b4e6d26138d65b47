"""Dataset layer: mapping CSV -> DICOM pixel arrays + encoded labels.

The port's own copy of `cadx_tpu/data/dataset.py`. The reference data
layer (Classes/Preprocessing.py) reads a CSV with columns
[dicom_file_path, pathology], loads each DICOM, keeps the raw pixel
arrays and string labels, and builds a sorted-unique label encoder; a
file that fails is skipped with a message. On top of that, the hooks the
reference declared but left as `pass`: resize, normalize, augment,
train/test split. `resize_images` runs the port's `ops/resize.py` on the
card unless the caller passes device="cpu"; the rest is numpy.
"""

from __future__ import annotations

import csv
import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from cadx_tpu_torch.data import dicom
from cadx_tpu_torch.device import resolve


@dataclasses.dataclass
class MammogramDataset:
    records: list[dict]                 # {"DICOM", "PatientID", "ImagePath", "Class"}
    raw_images: list[np.ndarray]
    raw_classes_str: list[str]
    raw_classes: list[int]
    label_encoder: dict[str, int]

    def __len__(self) -> int:
        return len(self.raw_images)


def fit_label_encoder(labels: Sequence[str]) -> dict[str, int]:
    """Sorted-unique label -> index (Preprocessing.fit_label_encoder)."""
    return {label: idx for idx, label in enumerate(sorted(set(labels)))}


def load_mapping_csv(mapping_csv_path: str,
                     reader: Callable = dicom.dcmread,
                     log: Callable[[str], None] = print) -> MammogramDataset:
    """Load the DICOMs a mapping CSV lists, skipping any that fails."""
    records: list[dict] = []
    try:
        with open(mapping_csv_path, newline="") as f:
            rows = list(csv.DictReader(f))
    except OSError as e:
        log(f"Failed to load mapping CSV: {e}")
        rows = []

    for row in rows:
        file_path = row.get("dicom_file_path", "")
        pathology = row.get("pathology", "")
        try:
            ds = reader(file_path)
            patient_id = ds.PatientID if hasattr(ds, "PatientID") else "Unknown"
            if isinstance(patient_id, str):
                patient_id = patient_id.replace(".dcm", "")
            records.append({
                "DICOM": ds,
                "PatientID": patient_id,
                "ImagePath": file_path,
                "Class": pathology,
            })
        except Exception as e:  # noqa: BLE001 — the reference skips any bad file
            log(f"Error reading {file_path}: {e}")

    kept_records, raw_images, raw_classes_str = [], [], []
    for item in records:
        try:
            # frame 0 / luma of multi-frame or color files: the training
            # stack is 2-D grayscale
            pixels = np.asarray(dicom.primary_frame(item["DICOM"]))
        except Exception as e:  # noqa: BLE001
            log(f"Skipping file due to pixel extraction error: {e}")
            continue
        # the record goes too, so that records[i] stays aligned with
        # raw_images[i] and raw_classes[i] (the reference let them drift)
        kept_records.append(item)
        raw_images.append(pixels)
        raw_classes_str.append(item["Class"])

    encoder = fit_label_encoder(raw_classes_str)
    raw_classes = [encoder[c] for c in raw_classes_str]
    return MammogramDataset(kept_records, raw_images, raw_classes_str,
                            raw_classes, encoder)


# ---------------------------------------------------------------------------
# The preprocessing hooks the reference declared but never implemented
# ---------------------------------------------------------------------------

def resize_images(images: Sequence[np.ndarray], target_shape: tuple[int, int],
                  interpolation: str = "area", device=None) -> np.ndarray:
    """Resize each image to (H, W) on `device` (the card when None):
    INTER_AREA or, for any other `interpolation`, bilinear. (N, H, W)
    float32 out."""
    from cadx_tpu_torch.ops.resize import resize_area, resize_linear

    dev = resolve(device)
    fn = resize_area if interpolation == "area" else resize_linear
    out = [fn(torch.from_numpy(np.asarray(im, np.float32)).to(dev)[None], target_shape)[0]
           for im in images]
    return torch.stack(out).cpu().numpy()


def normalize_images(images: np.ndarray, mode: str = "unit") -> np.ndarray:
    """'unit': scale to [0,1] by per-image max; 'standard': zero-mean/unit-var
    per image (the two normalizations used across the reference scripts)."""
    images = images.astype(np.float32)
    # reduce over ALL non-batch axes so (B,H,W) and (B,H,W,C) both work
    axes = tuple(range(1, images.ndim))
    if mode == "unit":
        maxv = np.maximum(images.max(axis=axes, keepdims=True), 1e-8)
        return images / maxv
    mean = images.mean(axis=axes, keepdims=True)
    std = images.std(axis=axes, keepdims=True) + 1e-8
    return (images - mean) / std


def augment_images(images: np.ndarray, labels: np.ndarray, *, seed: int = 0,
                   flips: bool = True, rot90: bool = True):
    """Simple label-preserving augmentation (reference augment_images stub)."""
    rng = np.random.default_rng(seed)
    out_x, out_y = [images], [labels]
    if flips:
        out_x.append(images[:, :, ::-1])
        out_y.append(labels)
    if rot90 and images.shape[1] == images.shape[2]:
        # 90-degree rotation changes the shape of non-square images and
        # could not be concatenated with the originals
        out_x.append(np.rot90(images, k=1, axes=(1, 2)))
        out_y.append(labels)
    x = np.concatenate(out_x)
    y = np.concatenate(out_y)
    perm = rng.permutation(len(x))
    return x[perm], y[perm]


def split_train_test(images, labels, test_size: float = 0.2, seed: int = 42,
                     stratify: bool = True):
    """Deterministic stratified split (reference split_train_test stub;
    matches the train_test_split usage at Classes/CNNModel.py:606-608)."""
    images = np.asarray(images)
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)
    test_idx: list[int] = []
    if stratify:
        for cls in np.unique(labels):
            idx = np.where(labels == cls)[0]
            rng.shuffle(idx)
            n_test = max(int(round(len(idx) * test_size)), 1)
            test_idx.extend(idx[:n_test])
    else:
        idx = rng.permutation(len(labels))
        test_idx = list(idx[: int(round(len(labels) * test_size))])
    test_mask = np.zeros(len(labels), bool)
    test_mask[test_idx] = True
    return (images[~test_mask], images[test_mask],
            labels[~test_mask], labels[test_mask])
