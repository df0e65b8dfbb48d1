"""Port of jen1_tpu/codec (see the package docstring of jen1_tpu_torch)."""
