"""Port of `cadx_tpu/tools`."""
