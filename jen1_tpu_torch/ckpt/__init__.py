"""Port of jen1_tpu/ckpt (see the package docstring of jen1_tpu_torch)."""
