"""Port of `cadx_tpu/xai`."""
