"""Port of jen1_tpu/data (see the package docstring of jen1_tpu_torch)."""
