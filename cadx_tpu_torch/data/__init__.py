"""Data layer: the DICOM reader and its codecs, the upload reader
(`imageio.py`), and the mapping-CSV dataset."""
