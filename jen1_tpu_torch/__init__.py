"""jen1_tpu_torch: the PyTorch + CUDA port of jen1_tpu for NVIDIA Hopper.

The package mirrors `jen1_tpu/`'s file tree, so each module names its JAX
counterpart. It imports nothing of JAX or of `jen1_tpu`; tensors keep the
channels-last (B, L, C) layout at public functions. Entry points run on the
card (`device="cuda"`) unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
