"""Port of jen1_tpu/diffusion (see the package docstring of jen1_tpu_torch)."""
