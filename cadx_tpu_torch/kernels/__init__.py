"""Port of `cadx_tpu/kernels`."""
