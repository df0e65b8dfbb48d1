"""Port of jen1_tpu/train (see the package docstring of jen1_tpu_torch)."""
