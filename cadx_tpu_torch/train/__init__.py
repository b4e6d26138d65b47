"""Port of `cadx_tpu/train`."""
