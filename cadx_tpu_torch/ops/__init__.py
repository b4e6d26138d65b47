"""Port of `cadx_tpu/ops`."""
