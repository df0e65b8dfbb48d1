"""Port of jen1_tpu/ops (see the package docstring of jen1_tpu_torch)."""
