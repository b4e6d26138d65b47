"""Port of `cadx_tpu/parallel`: meshes, data parallelism and H sharding."""
