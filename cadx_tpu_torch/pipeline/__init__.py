"""Port of `cadx_tpu/pipeline`."""
