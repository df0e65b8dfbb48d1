"""Audio evaluation metrics (port of jen1_tpu/eval/__init__.py)."""

from jen1_tpu_torch.eval.metrics import (  # noqa: F401
    frechet_audio_distance,
    frechet_distance,
    log_mel_embedding,
    signal_to_noise_ratio,
    spectral_convergence,
)
