"""Port of jen1_tpu/api (see the package docstring of jen1_tpu_torch)."""
