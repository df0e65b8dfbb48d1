"""Port of jen1_tpu/conditioning (see the package docstring of jen1_tpu_torch)."""
