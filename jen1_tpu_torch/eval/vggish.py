"""VGGish audio embedder, the canonical Fréchet Audio Distance embedding
(port of jen1_tpu/eval/vggish.py).

  * The VGGish input pipeline: 16 kHz mono, periodic-Hann 25 ms frames every
    10 ms, |rfft| at 512 points, the HTK mel matrix (64 bands, 125-7500 Hz,
    DC bin zeroed), log(mel + 0.01), non-overlapping 96-frame examples.
  * The VGG network as an `nn.Module` in torchvggish's layout
    (`features.{0,3,6,8,11,13}` 3x3 convs, `embeddings.{0,2,4}` Linear,
    ReLU after each, max-pool after convs 0, 1, 3, 5), so a local
    torchvggish state dict loads straight in (`convert_torch_vggish`). The
    pooled (B, 512, 6, 4) map is flattened in (H, W, C) order, as
    torchvggish and the JAX package's channels-last network flatten it.
  * Without weights the network is random from a seed, drawn with numpy in
    the JAX package's order (`init_vggish`), so both packages hold the same
    weights.
"""

from __future__ import annotations

import functools
import warnings
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from jen1_tpu_torch.ops.conv import fp32_precision

SAMPLE_RATE = 16_000
N_FFT = 512
WIN_LENGTH = 400  # 25 ms
HOP_LENGTH = 160  # 10 ms
NUM_MELS = 64
MEL_MIN_HZ = 125.0
MEL_MAX_HZ = 7500.0
LOG_OFFSET = 0.01
EXAMPLE_FRAMES = 96  # 0.96 s

_MEL_BREAK_HZ = 700.0
_MEL_HIGH_Q = 1127.0

_CONV_CHANNELS = (64, 128, 256, 256, 512, 512)
_POOL_AFTER = (0, 1, 3, 5)
# torchvggish's Sequential indices of the six convs and three Linears
_CONV_INDEX = (0, 3, 6, 8, 11, 13)
_FC_INDEX = (0, 2, 4)
_FC_DIMS = ((512 * 4 * 6, 4096), (4096, 4096), (4096, 128))


def _hertz_to_mel(f):
    return _MEL_HIGH_Q * np.log(1.0 + np.asarray(f, np.float64) / _MEL_BREAK_HZ)


@functools.lru_cache(maxsize=None)
def _mel_matrix() -> np.ndarray:
    """(spectrogram bins, mel bands): the band-slope HTK mel matrix with the
    DC bin zeroed."""
    num_bins = N_FFT // 2 + 1
    bins_mel = _hertz_to_mel(np.linspace(0.0, SAMPLE_RATE / 2.0, num_bins))
    edges_mel = np.linspace(_hertz_to_mel(MEL_MIN_HZ), _hertz_to_mel(MEL_MAX_HZ), NUM_MELS + 2)
    weights = np.empty((num_bins, NUM_MELS), np.float32)
    for i in range(NUM_MELS):
        lo, ctr, hi = edges_mel[i : i + 3]
        lower = (bins_mel - lo) / (ctr - lo)
        upper = (hi - bins_mel) / (hi - ctr)
        weights[:, i] = np.maximum(0.0, np.minimum(lower, upper))
    weights[0, :] = 0.0
    return weights


@fp32_precision()
def waveform_to_examples(audio: torch.Tensor) -> torch.Tensor:
    """16 kHz mono (B, T), or (B, T, ch) averaged -> (B * E, 96, 64) log-mel
    examples (no framing padding, non-overlapping 96-frame windows)."""
    audio = audio.float()
    if audio.dim() == 3:
        audio = audio.mean(dim=-1)
    b, t = audio.shape
    n_frames = 1 + (t - WIN_LENGTH) // HOP_LENGTH
    if n_frames < EXAMPLE_FRAMES:
        raise ValueError(f"audio too short for one VGGish example: {t} samples")
    # periodic Hann, as in mel_features (0.5 - 0.5 cos(2 pi n / N))
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(WIN_LENGTH) / WIN_LENGTH)
    frames = audio[:, : WIN_LENGTH + (n_frames - 1) * HOP_LENGTH].unfold(
        -1, WIN_LENGTH, HOP_LENGTH) * torch.from_numpy(window.astype(np.float32)).to(audio.device)
    mag = torch.fft.rfft(frames, n=N_FFT, dim=-1).abs()
    mel = mag @ torch.from_numpy(_mel_matrix()).to(audio.device)
    logmel = torch.log(mel + LOG_OFFSET)  # (B, F, 64)
    n_ex = n_frames // EXAMPLE_FRAMES
    return logmel[:, : n_ex * EXAMPLE_FRAMES].reshape(b * n_ex, EXAMPLE_FRAMES, NUM_MELS)


class VGGish(nn.Module):
    """(B, 96, 64) log-mel examples -> (B, 128) embeddings."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 1
        for i, cout in enumerate(_CONV_CHANNELS):
            layers += [nn.Conv2d(cin, cout, 3, padding=1), nn.ReLU()]
            if i in _POOL_AFTER:
                layers.append(nn.MaxPool2d(2, 2))
            cin = cout
        self.features = nn.Sequential(*layers)
        fcs = []
        for din, dout in _FC_DIMS:
            fcs += [nn.Linear(din, dout), nn.ReLU()]
        self.embeddings = nn.Sequential(*fcs)

    @fp32_precision()
    def forward(self, examples: torch.Tensor) -> torch.Tensor:
        x = self.features(examples.float()[:, None])  # (B, 512, 6, 4)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (H, W, C) order
        return self.embeddings(x)


def init_vggish(module: VGGish, seed: int = 0) -> VGGish:
    """Random weights from `seed`: numpy's U(+-1/sqrt(fan_in)) draws in the
    order and shapes of the JAX package's `init_vggish_params`."""
    rng = np.random.default_rng(seed)

    def draw(shape, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-bound, bound, size=shape).astype(np.float32)

    tree: Dict[str, Dict[str, np.ndarray]] = {}
    cin = 1
    for i, cout in enumerate(_CONV_CHANNELS):
        tree[f"conv{i}"] = {"kernel": draw((3, 3, cin, cout), cin * 9),
                            "bias": draw((cout,), cin * 9)}
        cin = cout
    for i, (din, dout) in enumerate(_FC_DIMS):
        tree[f"fc{i}"] = {"kernel": draw((din, dout), din), "bias": draw((dout,), din)}
    return load_vggish_tree(module, tree)


@torch.no_grad()
def load_vggish_tree(module: VGGish, params: Mapping) -> VGGish:
    """Load a parameter tree in the JAX package's layout (conv{i}: HWIO
    kernel and bias; fc{i}: (in, out) kernel and bias) into `module`."""
    sd = {}
    for i, ti in enumerate(_CONV_INDEX):
        sd[f"features.{ti}.weight"] = np.asarray(params[f"conv{i}"]["kernel"]).transpose(3, 2, 0, 1)
        sd[f"features.{ti}.bias"] = np.asarray(params[f"conv{i}"]["bias"])
    for i, ti in enumerate(_FC_INDEX):
        sd[f"embeddings.{ti}.weight"] = np.asarray(params[f"fc{i}"]["kernel"]).T
        sd[f"embeddings.{ti}.bias"] = np.asarray(params[f"fc{i}"]["bias"])
    module.load_state_dict({k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()})
    return module


@torch.no_grad()
def convert_torch_vggish(module: VGGish, state_dict) -> VGGish:
    """Load torchvggish's state dict (`features.{0,3,6,8,11,13}`,
    `embeddings.{0,2,4}`) into `module`; other keys (torchvggish's PCA
    buffers) are ignored, a missing one raises."""
    keys = [f"features.{i}.{n}" for i in _CONV_INDEX for n in ("weight", "bias")]
    keys += [f"embeddings.{i}.{n}" for i in _FC_INDEX for n in ("weight", "bias")]
    module.load_state_dict({k: torch.as_tensor(state_dict[k]).float() for k in keys})
    return module


class VGGishEmbedder:
    """FAD `embed_fn`: audio (B, T[, ch]) at `sample_rate` -> (N, 128).

    `weights_path`: a local torchvggish checkpoint (.pt/.pth). Without it
    the network is random from `seed`, with a UserWarning (relative FADs
    stay meaningful, absolute ones do not). Runs on `device`."""

    def __init__(self, weights_path: Optional[str] = None, sample_rate: int = 48_000,
                 seed: int = 0, *, device="cuda"):
        from jen1_tpu_torch.api.generation import resolve_device

        self.sample_rate = sample_rate
        self.device = resolve_device(device)
        model = VGGish()
        if weights_path is not None:
            from jen1_tpu_torch.ckpt.checkpoint import load_torch_file

            convert_torch_vggish(model, load_torch_file(weights_path, unwrap=True))
        else:
            warnings.warn(
                "jen1_tpu_torch: VGGishEmbedder without weights_path is RANDOM-initialized; "
                "absolute FAD values are not comparable to published numbers.",
                UserWarning, stacklevel=2)
            init_vggish(model, seed)
        self.model = model.to(self.device).eval()

    def _resample(self, audio: torch.Tensor) -> torch.Tensor:
        """Linear resample to 16 kHz along axis 1 (static gather indices)."""
        if self.sample_rate == SAMPLE_RATE:
            return audio
        t = audio.shape[1]
        pos = np.arange(int(t * SAMPLE_RATE / self.sample_rate)) * (self.sample_rate / SAMPLE_RATE)
        lo = np.clip(pos.astype(np.int64), 0, t - 1)
        hi = np.clip(lo + 1, 0, t - 1)
        frac = torch.from_numpy((pos - lo).astype(np.float32)).to(audio.device)[None, :]
        if audio.dim() == 3:
            frac = frac[..., None]
        lo, hi = torch.from_numpy(lo).to(audio.device), torch.from_numpy(hi).to(audio.device)
        return audio[:, lo] * (1.0 - frac) + audio[:, hi] * frac

    @torch.no_grad()
    def __call__(self, audio: torch.Tensor) -> torch.Tensor:
        audio = audio.to(self.device, torch.float32)
        return self.model(waveform_to_examples(self._resample(audio)))
