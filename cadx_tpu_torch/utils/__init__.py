"""Port of `cadx_tpu/utils`."""
