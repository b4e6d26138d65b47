"""Port of `cadx_tpu/preprocess`."""
