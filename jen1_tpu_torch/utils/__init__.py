"""Port of jen1_tpu/utils (see the package docstring of jen1_tpu_torch)."""
