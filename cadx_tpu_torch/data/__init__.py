"""Data layer: the DICOM reader and the mapping-CSV dataset."""
