"""Port of `cadx_tpu/models`."""
