"""EnCodec-48k: SEANet encoder, RVQ and SEANet decoder with EnCodec's
segmentation (port of jen1_tpu/codec/model.py).

  encode_latent(audio)          - whole-clip encoder, then the RVQ's
                                  quantize-dequantize bottleneck: the
                                  reference's get_emb
  encode_latent_chunked(audio)  - 150-frame audio chunks with a 148-frame hop
                                  as one batched encoder call, triangular
                                  overlap-add in latent space, then the RVQ
  encode(audio) / decode(frames)- EnCodec's 1 s segments with 1 % overlap,
                                  per-segment volume normalisation, codes and
                                  scales per segment; decode overlap-adds
  encode_latent_segmented(audio)- the reference's latent pipeline: `encode`,
                                  the codes of every segment concatenated,
                                  dequantized
  decode_latent(latent)         - the decoder on the whole latent
  decode_latent_chunked(latent) - 150-frame latent chunks as one batched
                                  decoder call and triangular overlap-add,
                                  optionally with a cached bf16 decoder
Layout: audio (B, T, channels), latent (B, F, dimension), channels-last as in
the JAX package. Weights are random from a seeded generator, loaded from a
local torch EnCodec state dict (`make_codec`, `convert_torch_encodec`:
facebookresearch or HF layout) or from a JAX tree
(`ckpt/from_jax.py::load_encodec`). Every entry point runs without
autograd and with fp32 products in full fp32 (`fp32_precision`).
"""

from __future__ import annotations

import copy
import dataclasses
import math
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch
import torch.nn.functional as F
from torch import nn

from jen1_tpu_torch.codec.rvq import ResidualVectorQuantizer
from jen1_tpu_torch.codec.seanet import SEANetDecoder, SEANetEncoder, SLSTM
from jen1_tpu_torch.ops.conv import fp32_precision
from jen1_tpu_torch.ops.initializers import init_module


@dataclasses.dataclass
class EncodecConfig:
    sample_rate: int = 48_000
    channels: int = 2
    dimension: int = 128
    n_filters: int = 32
    ratios: Tuple[int, ...] = (8, 5, 4, 2)
    n_q: int = 16
    bins: int = 1024
    causal: bool = False
    norm: str = "time_group_norm"
    normalize: bool = True
    segment: Optional[float] = 1.0  # seconds
    overlap: float = 0.01

    @property
    def hop_length(self) -> int:
        return math.prod(self.ratios)

    @property
    def frame_rate(self) -> float:
        return self.sample_rate / self.hop_length


def encodec_48khz_config() -> EncodecConfig:
    return EncodecConfig()


def _triangle(n: int, device) -> torch.Tensor:
    """EnCodec's _linear_overlap_add weights over n samples."""
    t = torch.linspace(0.0, 1.0, n + 2, dtype=torch.float32, device=device)[1:-1]
    return 0.5 - (t - 0.5).abs()


def _linear_overlap_add(pieces: List[torch.Tensor], stride: int) -> torch.Tensor:
    """Triangular-window overlap-add of (B, l_i, C) pieces that start
    `stride` apart (jen1_tpu/codec/model.py:423-437), in fp32."""
    total = stride * (len(pieces) - 1) + pieces[-1].shape[1]
    b, _, c = pieces[0].shape
    device = pieces[0].device
    out = torch.zeros((b, total, c), dtype=torch.float32, device=device)
    norm = torch.zeros((total, 1), dtype=torch.float32, device=device)
    for i, piece in enumerate(pieces):
        n = piece.shape[1]
        w = _triangle(n, device)[:, None]
        out[:, i * stride : i * stride + n] += piece.float() * w
        norm[i * stride : i * stride + n] += w
    return out / norm.clamp_min(1e-12)


def _chunk_count(frames: int, chunk_frames: int, hop_frames: int) -> int:
    return max(1, math.ceil((frames - chunk_frames) / hop_frames) + 1)


class EncodecModel(nn.Module):
    """The whole codec on `device`: `encoder`, `decoder` and the RVQ's
    `codebooks` buffer (n_q, bins, dimension)."""

    def __init__(self, config: EncodecConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        seanet = dict(channels=config.channels, dimension=config.dimension,
                      n_filters=config.n_filters, ratios=config.ratios,
                      causal=config.causal, norm=config.norm)
        with torch.device(device):
            self.decoder = SEANetDecoder(**seanet)
            self.encoder = SEANetEncoder(**seanet)
            self.register_buffer(
                "codebooks", torch.empty(config.n_q, config.bins, config.dimension))
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(1)
        init_module(self, generator)
        with torch.no_grad():
            self.codebooks.normal_(generator=generator)
        # the bf16 decoder of decode_latent_chunked(dtype=bfloat16), built
        # once (a plain dict, so it is no submodule and not in state_dict)
        self._bf16_cache: dict = {}

    @property
    def quantizer(self) -> ResidualVectorQuantizer:
        return ResidualVectorQuantizer(self.codebooks, frame_rate=self.config.frame_rate)

    # ------------------------------------------------------------ direct

    @torch.no_grad()
    @fp32_precision()
    def encode_latent(self, audio: torch.Tensor, quantize: bool = True) -> torch.Tensor:
        """audio (B, T, ch) -> latent (B, ceil(T / hop), D): the whole-clip
        encoder, then (quantize=True) the RVQ bottleneck."""
        z = self.encoder(audio)
        return self.quantizer.quantize_latent(z) if quantize else z

    @torch.no_grad()
    @fp32_precision()
    def decode_latent(self, latent: torch.Tensor) -> torch.Tensor:
        """latent (B, F, D) -> audio (B, F * hop, ch), one decoder pass."""
        return self.decoder(latent)

    # --------------------------------------------------------- segmented

    def _segment_bounds(self, total: int) -> List[Tuple[int, int]]:
        """EnCodec iterates range(0, total, stride) with no early break: a
        trailing sub-stride remainder still yields a short segment, and a
        total of exactly seg_len yields two (jen1_tpu/codec/model.py:158-170)."""
        cfg = self.config
        if cfg.segment is None:
            return [(0, total)]
        seg_len = int(cfg.segment * cfg.sample_rate)
        stride = max(1, int((1.0 - cfg.overlap) * seg_len))
        return [(start, min(start + seg_len, total)) for start in range(0, total, stride)]

    @torch.no_grad()
    @fp32_precision()
    def encode(self, audio: torch.Tensor):
        """Full EnCodec semantics: per segment, (codes (B, n_q, F), scale
        (B, 1, 1) or None)."""
        frames = []
        for start, end in self._segment_bounds(audio.shape[1]):
            seg = audio[:, start:end]
            scale = None
            if self.config.normalize:
                mono = seg.mean(-1, keepdim=True)
                volume = mono.square().mean(1, keepdim=True).sqrt()
                scale = 1e-8 + volume
                seg = seg / scale
            frames.append((self.quantizer.encode(self.encoder(seg)), scale))
        return frames

    @torch.no_grad()
    @fp32_precision()
    def decode(self, frames) -> torch.Tensor:
        """Segment decode and linear overlap-add (EnCodec _linear_overlap_add)."""
        cfg = self.config
        pieces = []
        for codes, scale in frames:
            audio = self.decoder(self.quantizer.decode(codes))
            pieces.append(audio if scale is None else audio * scale)
        if len(pieces) == 1:
            return pieces[0]
        seg_len = int(cfg.segment * cfg.sample_rate)
        return _linear_overlap_add(pieces, max(1, int((1.0 - cfg.overlap) * seg_len)))

    def codes_to_latent(self, codes: torch.Tensor) -> torch.Tensor:
        return self.quantizer.decode(codes)

    def encode_latent_segmented(self, audio: torch.Tensor) -> torch.Tensor:
        """The reference's get_emb pipeline: `encode`, the codes of every
        segment concatenated along time (scales dropped), dequantized. The
        overlapping segments make this latent longer than the other
        encoders' (4545 frames for 30 s at 48 kHz)."""
        codes = torch.cat([c for c, _ in self.encode(audio)], dim=-1)
        return self.quantizer.decode(codes)

    # ----------------------------------------------------------- chunked

    def decoder_bf16(self) -> SEANetDecoder:
        """A bf16 copy of the decoder, built once: convs and GroupNorm's
        scale in bf16, the LSTM in fp32 holding bf16-rounded weights (the
        JAX package casts every decoder weight to bf16 and promotes the
        LSTM's to fp32, jen1_tpu/codec/model.py:209-218)."""
        if "decoder" not in self._bf16_cache:
            dec = copy.deepcopy(self.decoder).to(torch.bfloat16)
            for m in dec.modules():
                if isinstance(m, SLSTM):
                    m.float()
            self._bf16_cache["decoder"] = dec
        return self._bf16_cache["decoder"]

    @torch.no_grad()
    @fp32_precision()
    def decode_latent_chunked(
        self, latent: torch.Tensor, chunk_frames: int = 150, hop_frames: int = 148,
        dtype: Optional[torch.dtype] = None,
    ) -> torch.Tensor:
        """latent (B, F, D) -> audio (B, F * hop, ch) by overlapping latent
        chunks, decoded as one batch, and triangular overlap-add (EnCodec's
        1 s segments with 1 % overlap). dtype=torch.bfloat16 decodes with
        `decoder_bf16()`; a latent of at most one chunk takes the fp32
        whole-latent decoder either way, as in the JAX package."""
        if dtype is not None and dtype != torch.bfloat16:
            raise ValueError("decode_latent_chunked dtype must be None (fp32 weights) or "
                             f"torch.bfloat16, got {dtype}")
        b, f, d = latent.shape
        hop = self.config.hop_length
        if f <= chunk_frames:
            return self.decoder(latent)[:, : f * hop]
        n = _chunk_count(f, chunk_frames, hop_frames)
        latent = F.pad(latent, (0, 0, 0, (n - 1) * hop_frames + chunk_frames - f))
        decoder = self.decoder
        if dtype is not None:
            decoder, latent = self.decoder_bf16(), latent.to(dtype)
        chunks = latent.unfold(1, chunk_frames, hop_frames)  # (B, n, D, Fc)
        chunks = chunks.permute(0, 1, 3, 2).reshape(b * n, chunk_frames, d)
        seg_len = chunk_frames * hop
        audio = decoder(chunks)[:, :seg_len].reshape(b, n, seg_len, -1)
        out = _linear_overlap_add([audio[:, i] for i in range(n)], hop_frames * hop)
        return out[:, : f * hop]

    @torch.no_grad()
    @fp32_precision()
    def encode_latent_chunked(
        self, audio: torch.Tensor, chunk_frames: int = 150, hop_frames: int = 148,
        quantize: bool = True,
    ) -> torch.Tensor:
        """audio (B, T, ch) -> latent (B, T // hop, D) by overlapping audio
        chunks of chunk_frames * hop samples, encoded as one batch, and
        triangular overlap-add in latent space, then (quantize=True) the RVQ,
        which is frame-local (jen1_tpu/codec/model.py:286-330, 382-420). A
        clip of at most one chunk takes `encode_latent`."""
        b, t, ch = audio.shape
        hop = self.config.hop_length
        f = t // hop
        if f <= chunk_frames:
            return self.encode_latent(audio, quantize=quantize)
        n = _chunk_count(f, chunk_frames, hop_frames)
        # the sub-frame tail goes first, then whole frames of padding: padding
        # against the raw t would go negative when f lands on the chunk grid
        pad = ((n - 1) * hop_frames + chunk_frames - f) * hop
        audio = F.pad(audio[:, : f * hop], (0, 0, 0, pad))
        chunks = audio.unfold(1, chunk_frames * hop, hop_frames * hop)  # (B, n, ch, Ts)
        chunks = chunks.permute(0, 1, 3, 2).reshape(b * n, chunk_frames * hop, ch)
        z = self.encoder(chunks)[:, :chunk_frames].reshape(b, n, chunk_frames, -1)
        out = _linear_overlap_add([z[:, i] for i in range(n)], hop_frames)[:, :f]
        return self.quantizer.quantize_latent(out) if quantize else out


# ----------------------------------------------------------------- convert


def make_codec(weights_path: Optional[str] = None, config: Optional[EncodecConfig] = None,
               *, device="cuda", generator: Optional[torch.Generator] = None,
               warn_context: str = "inference") -> EncodecModel:
    """The 48 kHz codec on `device`, with the torch state dict at
    `weights_path` loaded, or random from `generator` with a warning: a
    random codec gives noise latents and audio
    (jen1_tpu/codec/model.py:443-468)."""
    config = config or encodec_48khz_config()
    codec = EncodecModel(config, device=device, generator=generator)
    if weights_path is not None:
        from jen1_tpu_torch.ckpt.from_jax import load_encodec

        load_encodec(codec, convert_torch_encodec(load_torch_encodec_state_dict(weights_path),
                                                  config))
    else:
        warnings.warn(
            f"jen1_tpu_torch: no codec weights configured for {warn_context}: the EnCodec "
            "codec is RANDOM-initialized, so latents and audio will be noise. Set "
            "config.codec_weights_path to the pretrained EnCodec-48k state_dict.",
            UserWarning, stacklevel=2)
    return codec.eval()


def load_torch_encodec_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A local EnCodec state dict (.pt/.pth/.bin) in the facebookresearch/
    encodec layout or the HF `transformers` EncodecModel layout, detected
    and remapped to the former (codec/hf_import.py). Torch >= 2.1 weight
    norm's `parametrizations.weight.original0/1` become `weight_g/weight_v`."""
    from jen1_tpu_torch.ckpt.checkpoint import load_torch_file
    from jen1_tpu_torch.codec.hf_import import hf_encodec_to_fb_state_dict, \
        is_hf_encodec_state_dict

    obj = load_torch_file(path, unwrap=True)
    if is_hf_encodec_state_dict(obj):
        return hf_encodec_to_fb_state_dict(obj)
    return {k.replace(".parametrizations.weight.original0", ".weight_g")
             .replace(".parametrizations.weight.original1", ".weight_v"): v
            for k, v in obj.items()}


class _RecordingDict:
    """Read-through mapping that records the keys a conversion read, so
    that every checkpoint key can be accounted for."""

    def __init__(self, d):
        self._d = dict(d)
        self.consumed = set()

    def __contains__(self, key):
        return key in self._d

    def __getitem__(self, key):
        self.consumed.add(key)
        return self._d[key]

    def keys(self):
        return self._d.keys()


def convert_torch_encodec(state_dict, config: EncodecConfig, strict: bool = True) -> dict:
    """The facebookresearch/encodec torch state dict as the JAX package's
    codec parameters ({"encoder", "decoder", "codebooks"} of numpy arrays,
    jen1_tpu/codec/model.py:495-668), which `ckpt/from_jax.py::load_encodec`
    loads into the port's codec. Weight-normalized convs (weight_g/weight_v)
    are fused into plain kernels. Every checkpoint key must be read or be a
    codebook buffer inference ignores (inited, cluster_size, embed_avg),
    else ValueError; `strict=False` converts anyway, so that
    `ckpt/verify_weights.py` can report the unread keys."""
    if not isinstance(state_dict, _RecordingDict):
        state_dict = _RecordingDict(state_dict)
    sd = state_dict

    def arr(t) -> np.ndarray:
        if hasattr(t, "detach"):
            t = t.detach().cpu().numpy()
        return np.asarray(t, dtype=np.float32)

    def fused(prefix: str) -> np.ndarray:
        """weight_norm(dim=0): g * v / ||v|| over all but the first axis."""
        if f"{prefix}.weight_v" in sd:
            v, g = arr(sd[f"{prefix}.weight_v"]), arr(sd[f"{prefix}.weight_g"])
            norm = np.sqrt((v**2).sum(axis=(1, 2), keepdims=True))
            return g * v / np.maximum(norm, 1e-12)
        return arr(sd[f"{prefix}.weight"])

    def with_norm(p: dict, prefix: str) -> dict:
        if f"{prefix}.norm.weight" in sd:
            p["norm"] = {"scale": arr(sd[f"{prefix}.norm.weight"]),
                         "bias": arr(sd[f"{prefix}.norm.bias"])}
        return p

    def sconv(prefix: str) -> dict:
        # torch conv weight (Cout, Cin, K) -> (K, Cin, Cout)
        pre = f"{prefix}.conv"
        return with_norm({"kernel": fused(f"{pre}.conv").transpose(2, 1, 0),
                          "bias": arr(sd[f"{pre}.conv.bias"])}, pre)

    def sconvtr(prefix: str) -> dict:
        # torch convtr weight (Cin, Cout, K) -> (K, Cin, Cout); weight_norm
        # reduces over (Cout, K) per input channel
        pre = f"{prefix}.convtr"
        return with_norm({"kernel": fused(f"{pre}.convtr").transpose(2, 0, 1),
                          "bias": arr(sd[f"{pre}.convtr.bias"])}, pre)

    def lstm(prefix: str) -> dict:
        p = {}
        for layer in range(2):
            for ours, theirs in (("w_ih", "weight_ih"), ("w_hh", "weight_hh")):
                p[f"l{layer}_{ours}"] = arr(sd[f"{prefix}.lstm.{theirs}_l{layer}"]).T
            for ours, theirs in (("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
                p[f"l{layer}_{ours}"] = arr(sd[f"{prefix}.lstm.{theirs}_l{layer}"])
        return p

    def resblock(prefix: str) -> dict:
        return {"conv1": sconv(f"{prefix}.block.1"), "conv2": sconv(f"{prefix}.block.3"),
                "shortcut": sconv(f"{prefix}.shortcut")}

    n = len(config.ratios)
    enc = {"conv_in": sconv("encoder.model.0")}
    for si in range(n):
        enc[f"stage{si}_res0"] = resblock(f"encoder.model.{1 + 3 * si}")
        enc[f"stage{si}_down"] = sconv(f"encoder.model.{3 + 3 * si}")
    enc["lstm"] = lstm(f"encoder.model.{1 + 3 * n}")
    enc["conv_out"] = sconv(f"encoder.model.{3 + 3 * n}")
    dec = {"conv_in": sconv("decoder.model.0"), "lstm": lstm("decoder.model.1")}
    for si in range(n):
        dec[f"stage{si}_up"] = sconvtr(f"decoder.model.{3 + 3 * si}")
        dec[f"stage{si}_res0"] = resblock(f"decoder.model.{4 + 3 * si}")
    dec["conv_out"] = sconv(f"decoder.model.{3 + 3 * n}")
    codebooks = np.stack([arr(sd[f"quantizer.vq.layers.{i}._codebook.embed"])
                          for i in range(config.n_q)])
    from jen1_tpu_torch.codec.torch_keys import expected_torch_keys

    _, ignorable = expected_torch_keys(n, config.n_q)
    leftovers = set(sd.keys()) - sd.consumed - ignorable
    if leftovers and strict:
        raise ValueError(
            f"convert_torch_encodec left {len(leftovers)} checkpoint key(s) unread "
            f"(layout mismatch?): {sorted(leftovers)[:8]}")
    return {"encoder": enc, "decoder": dec, "codebooks": codebooks}
