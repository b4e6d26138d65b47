"""DICOM demo loader — the reference `Classes/load.py` equivalent.

Port of `cadx_tpu/compat/load.py` on the port's DICOM reader
(`data/dicom.py`): reads a DICOM, prints its metadata, and shows the image
(Classes/load.py:10-19 did the same via pydicom + matplotlib).
"""

from __future__ import annotations

from cadx_tpu_torch.data import dicom


def load_dicom(path: str, show: bool = True):
    """Read, print metadata, optionally display. Returns the dataset."""
    ds = dicom.dcmread(path)
    print(f"PatientID: {ds.PatientID}")
    print(f"Transfer syntax: {ds.transfer_syntax}")
    arr = ds.pixel_array
    print(f"Pixel array: {arr.shape} {arr.dtype} "
          f"range [{arr.min()}, {arr.max()}]")
    if show:
        import matplotlib.pyplot as plt

        plt.imshow(dicom.primary_frame(ds, arr=arr), cmap="gray")
        plt.title(f"DICOM Image : {ds.PatientID}")
        plt.show()
    return ds
