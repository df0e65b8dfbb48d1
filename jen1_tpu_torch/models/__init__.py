"""Port of jen1_tpu/models (see the package docstring of jen1_tpu_torch)."""
