"""Case store + artifact workspace for the serving layer.

Replaces the reference's hard-coded absolute Windows folders and
prediction_data.csv "database" (app.py:41-49, :284-305) with a
workspace-rooted layout. The CSV schema is byte-compatible with the
reference's csv_headers (app.py:284-288).

Artifact writes that the reference did on unjoined threads (mask PNGs at
app.py:274, Grad-CAM overlays at app.py:649) run here through a tracked
executor: every async job registers a future, and readers wait on
completion instead of racing the filesystem (SURVEY.md section 5, race
detection row).
"""

from __future__ import annotations

import csv
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor

CSV_HEADERS = [
    "dicom_file_path", "preprocessed_file_path",
    "segmented_images_file_path",
    "patient_id", "breast", "image_view", "pathology", "modality",
    "image_name", "clean_image_path",
]

FOLDERS = {
    "raw": "Uploads/raw_image",
    "clean": "Uploads/clean_image_roi_highlight",
    "preprocessed": "Uploads/preprocessed_image",
    "segmentation": "Uploads/segmentation_image",
    "bulk": "static/Bulk_images",
    "explainability": "static/explainability",
    "trained_model": "static/trained_model",
    "images": "static/images",
}


class Workspace:
    """Rooted artifact folders + CSV case store + tracked async writer."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        for rel in FOLDERS.values():
            os.makedirs(os.path.join(self.root, rel), exist_ok=True)
        self.csv_path = os.path.join(self.root, "Uploads", "prediction_data.csv")
        self._executor = ThreadPoolExecutor(max_workers=2)
        self._jobs: dict[str, Future] = {}
        self._lock = threading.Lock()

    def folder(self, name: str) -> str:
        return os.path.join(self.root, FOLDERS[name])

    def clear_folder(self, name: str) -> None:
        folder = self.folder(name)
        for filename in os.listdir(folder):
            path = os.path.join(folder, filename)
            try:
                if os.path.isfile(path) or os.path.islink(path):
                    os.unlink(path)
            except OSError:
                pass

    # --- case CSV ---------------------------------------------------------
    def write_case(self, entry: dict) -> None:
        """Single-case overwrite, like the reference's df.to_csv
        (app.py:304-305) — written to a temp file and os.replace'd so
        unlocked concurrent readers (/diagnosis) never see a truncated
        or torn CSV."""
        row = {k: entry.get(k, "") for k in CSV_HEADERS}
        tmp = self.csv_path + ".tmp"
        with open(tmp, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=CSV_HEADERS)
            w.writeheader()
            w.writerow(row)
        os.replace(tmp, self.csv_path)

    def read_cases(self) -> list[dict]:
        if not os.path.exists(self.csv_path):
            return []
        with open(self.csv_path, newline="") as f:
            return [
                {k: (v if v not in (None, "") else "N/A") for k, v in row.items()}
                for row in csv.DictReader(f)
            ]

    def find_case(self, patient_id: str) -> dict | None:
        for row in self.read_cases():
            if row.get("patient_id") == patient_id:
                return row
        return None

    # --- tracked async artifact jobs ---------------------------------------
    def submit(self, key: str, fn, *args) -> Future:
        """Run an artifact job in the background, tracked under `key`."""
        fut = self._executor.submit(fn, *args)
        with self._lock:
            self._jobs[key] = fut
        return fut

    def wait(self, key: str, timeout: float | None = 600.0) -> None:
        """Block until the job under `key` (if any) completes. The default
        covers first-compile latency of the jitted artifact programs
        (a first Grad-CAM can take long); job exceptions propagate
        to the caller, which maps them to an HTTP 500."""
        with self._lock:
            fut = self._jobs.get(key)
        if fut is not None:
            fut.result(timeout=timeout)

    def copy_into(self, src: str, name: str, filename: str) -> str:
        dst = os.path.join(self.folder(name), filename)
        shutil.copyfile(src, dst)
        return dst

    def close(self) -> None:
        self._executor.shutdown(wait=True)
