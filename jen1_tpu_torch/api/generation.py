"""Jen1 text-to-music inference API (port of jen1_tpu/api/generation.py).

`Jen1(...).generate(prompt, ...)` returns the waveform (B, channels,
samples) as a numpy array, like the JAX package, or the latent with
decode=False. It runs the three JEN-1 tasks: `text_guided`, `music_inpaint`
(regenerate `inpainting_scope` of `init_audio`) and `music_cont` (continue
`init_audio` to `seconds`, with the causal UNet), with the VDM sampler (the
default) or, with `use_gdm=True`, the GDM samplers (DDIM, DDPM,
`sampler_mode="dpm++"`). `init_audio` is encoded by the chunked, whole-clip
or segmented EnCodec encoder and starts the sampler as x_T + latent, as in
the JAX package; the decode is chunked (fp32 or bf16 weights) or whole.
`encoder_reuse > 1`, checkpoint loading, EMA and bf16 weights, LoRA and
`output_transport="device"` raise NotImplementedError naming their ROADMAP
Queue 1 item; `generate_long*`, `generate_tracks` and `save_audio` are not
ported yet.

The model runs on `device` ("cuda" by default; "cpu" only when asked).
Weights are random from `config.seed`, as in the JAX package without a
checkpoint; `ckpt/from_jax.py` loads JAX parameter trees into them. int8
weight-only inference is a property of the UNet's modules:
`attach_qweights(jen1.model, quantize_conv_params(jen1.model))`
(`ops/int8_matmul.py`) makes its large stride-1 convs run K4.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from jen1_tpu_torch.conditioning.conditioners import (
    assemble_conditioning,
    create_multi_conditioner,
)
from jen1_tpu_torch.config import ROADMAP_TRAINING, ROADMAP_WEIGHTS, Config, not_ported
from jen1_tpu_torch.data.audio_io import convert_audio
from jen1_tpu_torch.diffusion.gdm import create_gaussian_diffusion
from jen1_tpu_torch.diffusion.vdm import create_variational_diffusion
from jen1_tpu_torch.models.unet import unet_from_model_config
from jen1_tpu_torch.ops.conv import fp32_precision
from jen1_tpu_torch.ops.initializers import init_module

TASKS = ("text_guided", "music_inpaint", "music_cont")
ENCODE_MODES = ("chunked", "whole")
DECODE_MODES = ("chunked", "chunked_bf16", "whole")


def _warn(msg: str) -> None:
    warnings.warn(f"jen1_tpu_torch: {msg}", UserWarning, stacklevel=3)


def resolve_device(device) -> torch.device:
    """The requested device; a CUDA request without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "jen1_tpu_torch: device='cuda' requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


def latent_length(samples: int, hop: int, chunk_frames: int = 150) -> int:
    """Latent frames of a `samples`-long clip, as the JAX package's chunked
    encoder yields them: samples // hop, except that clips of at most one
    chunk take the whole-clip encoder, whose strided convs round up."""
    frames = samples // hop
    return frames if frames > chunk_frames else math.ceil(samples / hop)


class Jen1:
    def __init__(
        self,
        ckpt_path: Optional[str] = None,
        sample_rate: int = 48_000,
        cross_attn_cond_ids=("prompt",),
        global_cond_ids=(),
        input_concat_ids=("masked_input", "mask"),
        config: Optional[Config] = None,
        codec=None,
        conditioner=None,
        use_ema_params: bool = False,
        weights_dtype: Optional[str] = None,
        lora_path: Optional[str] = None,
        lora_scale: Optional[float] = None,
        *,
        device="cuda",
    ):
        if ckpt_path is not None:
            raise not_ported("checkpoint loading (ckpt_path)", ROADMAP_WEIGHTS)
        if use_ema_params or weights_dtype not in (None, "float32"):
            raise not_ported("use_ema_params and weights_dtype='bfloat16'", ROADMAP_WEIGHTS)
        if lora_path is not None or lora_scale is not None:
            raise not_ported("LoRA adapters (lora_path, lora_scale)", ROADMAP_TRAINING)
        self.device = resolve_device(device)
        self.sample_rate = sample_rate
        self.config = config or Config()
        self.cross_attn_cond_ids = tuple(cross_attn_cond_ids)
        self.global_cond_ids = tuple(global_cond_ids)
        self.input_concat_ids = tuple(input_concat_ids)
        seed = self.config.seed

        def gen(offset: int) -> torch.Generator:
            return torch.Generator(device=self.device).manual_seed(seed + offset)

        if conditioner is None:
            t5c = self.config.conditioner_config.t5_config
            if t5c.t5_model_name != "tiny-test":
                _warn("the T5 text encoder is RANDOM-initialized; prompts will not "
                      "steer generation.")
            conditioner = create_multi_conditioner(
                self.config.conditioner_config, device=self.device, generator=gen(1)
            )
        self.conditioner = conditioner
        if codec is None:
            from jen1_tpu_torch.codec.model import EncodecModel, encodec_48khz_config

            _warn("the EnCodec codec is RANDOM-initialized, so decoded audio "
                  "will be noise.")
            codec = EncodecModel(encodec_48khz_config(), device=self.device,
                                 generator=gen(2))
        self.codec = codec
        self.compute_dtype = (
            torch.bfloat16 if self.config.model_config.dtype == "bfloat16" else torch.float32
        )
        with torch.device(self.device):
            self.model = unet_from_model_config(self.config.model_config).eval()
        init_module(self.model, gen(0))
        self.diffusion = create_variational_diffusion(
            self.config.diffusion_config.variational_diffusion
        )
        self._gdm_cache: Dict[int, object] = {}
        # Phase walls of the last generate() call, in seconds. On the card
        # each phase ends with torch.cuda.synchronize(), so they are device
        # walls: prep / encode / conditioner / assemble / sampler / decode /
        # fetch.
        self.last_timings: Dict[str, float] = {}

    def _get_gdm(self, steps: int):
        """The GDM with `steps` sampling steps, built once per count
        (jen1_tpu/api/generation.py:295-307)."""
        if steps not in self._gdm_cache:
            self._gdm_cache[steps] = create_gaussian_diffusion(
                self.config.diffusion_config.gaussian_diffusion,
                sampling_steps=steps, device=self.device,
            )
        return self._gdm_cache[steps]

    def _model_fn(self, x, t, **kw):
        """The UNet at the compute dtype, fp32 at the sampler boundary."""
        dtype = self.compute_dtype
        kw["embedding"] = kw["embedding"].to(dtype)
        if kw.get("channels_list") is not None:
            kw["channels_list"] = [c.to(dtype) for c in kw["channels_list"]]
        return self.model(x.to(dtype), t, **kw).float()

    def _encoder(self, encode_mode: str):
        """The codec encoder generate() uses (jen1_tpu/api/generation.py:490-495):
        the reference's segmented pipeline when the config asks for it, else
        `encode_mode`'s."""
        if self.config.codec_segmented_latents:
            return self.codec.encode_latent_segmented
        if encode_mode == "chunked":
            return self.codec.encode_latent_chunked
        return self.codec.encode_latent

    def latent_frames(self, samples: int, encode_mode: str = "chunked") -> int:
        """Latent frames that generate()'s encoder yields for `samples`
        samples, without running it (text_guided without init_audio)."""
        hop = self.codec.config.hop_length
        if self.config.codec_segmented_latents:
            return sum(math.ceil((end - start) / hop)
                       for start, end in self.codec._segment_bounds(samples))
        if encode_mode == "chunked":
            return latent_length(samples, hop)
        return math.ceil(samples / hop)

    @staticmethod
    def _get_mask(sample_length: int, start_sec: float, end_sec: float, batch_size: int,
                  sr: int = 48_000) -> np.ndarray:
        """1 = keep, 0 = to generate, over waveform samples: (B, T, 1)
        (jen1_tpu/api/generation.py:923-938)."""
        mask = np.ones((sample_length,), np.float32)
        mask[int(math.floor(start_sec * sr)):int(math.ceil(end_sec * sr))] = 0.0
        return np.broadcast_to(mask[None, :, None], (batch_size, sample_length, 1)).copy()

    @staticmethod
    def latent_mask(mask: np.ndarray, latent_len: int) -> np.ndarray:
        """Nearest resize of a (B, T, 1) waveform mask to latent frames
        (jen1_tpu/api/generation.py:520-527)."""
        sample_length = mask.shape[1]
        idx = np.clip(
            (np.arange(latent_len) * (sample_length / latent_len)).astype(np.int64),
            0, sample_length - 1,
        )
        return mask[:, idx, :]

    def _task_inputs(self, task, init_audio, sample_length, seconds, batch_size,
                     inpainting_scope):
        """(waveform mask (B, T, 1), init audio (B, T, ch), causal) of a task
        (jen1_tpu/api/generation.py:452-482)."""
        sr = self.sample_rate
        if task == "text_guided":
            return self._get_mask(sample_length, 0.0, seconds, batch_size, sr), init_audio, False
        if task == "music_inpaint":
            assert inpainting_scope is not None, "music_inpaint needs inpainting_scope"
            mask = self._get_mask(sample_length, inpainting_scope[0], inpainting_scope[1],
                                  batch_size, sr)
            if init_audio.shape[1] < sample_length:
                pad = sample_length - init_audio.shape[1]
                init_audio = np.pad(init_audio, ((0, 0), (0, pad), (0, 0)))
            return mask, init_audio[:, :sample_length], False
        if task == "music_cont":
            cont_start = init_audio.shape[1]
            mask = self._get_mask(sample_length, cont_start / sr, seconds, batch_size, sr)
            # the reference multiplies its noise tail by the mask, which is 0
            # over the region to generate: the tail is zeros
            tail = np.zeros((batch_size, sample_length - cont_start, init_audio.shape[2]),
                            np.float32)
            return mask, np.concatenate([init_audio, tail], axis=1), True
        raise ValueError(f"unknown task: {task}")

    @torch.no_grad()
    def generate(
        self,
        prompt,  # str, or a sequence of batch_size per-example prompts
        seed: int = -1,
        steps: int = 100,
        batch_size: int = 1,
        seconds: float = 30,
        use_gdm: bool = False,
        task: str = "text_guided",
        init_audio=None,
        init_audio_sr: Optional[int] = None,
        inpainting_scope: Optional[Tuple[float, float]] = None,
        decode: bool = True,
        sampler_mode: str = "scan",
        decode_mode: str = "chunked",
        encode_mode: str = "chunked",
        encoder_reuse: int = 1,
        output_dtype: str = "float32",
        output_transport: str = "host",
    ) -> np.ndarray:
        """Waveform (B, channels, samples) float32, or int16 PCM with
        output_dtype="int16" (converted on the device); with decode=False
        the latent (B, dimension, frames).

        task: "text_guided", "music_inpaint" (needs `inpainting_scope`
        (start, end) in seconds; `init_audio` is padded or cropped to
        `seconds`) or "music_cont" (`init_audio` is the start of the clip,
        continued to `seconds` with the causal UNet). `init_audio` is
        (B, T, ch) or (T, ch), repeated over the batch, at `init_audio_sr`
        (default: the model's rate); each example is converted to the
        model's rate and channels. encode_mode "chunked" encodes it as
        batched 150-frame chunks with latent overlap-add, "whole" in one
        pass; `config.codec_segmented_latents` takes the reference's
        segmented pipeline instead. decode_mode "chunked" decodes batched
        latent chunks, "chunked_bf16" the same with bf16 decoder weights,
        "whole" in one pass.

        use_gdm=True samples with the GDM: DDIM over `steps` of the config's
        `steps` timesteps, or DDPM when `steps` equals them;
        sampler_mode="dpm++" runs DPM-Solver++(2M) instead. "scan" and
        "stepwise" are one loop here."""
        # the JAX package's checks (jen1_tpu/api/generation.py:403-411, 582-595)
        if output_dtype not in ("float32", "int16"):
            raise ValueError(f"output_dtype must be 'float32' or 'int16', got {output_dtype!r}")
        if output_transport not in ("host", "device"):
            raise ValueError(
                f"output_transport must be 'host' or 'device', got {output_transport!r}")
        if sampler_mode not in ("scan", "stepwise", "dpm++"):
            raise ValueError(
                f"sampler_mode must be 'scan', 'stepwise' or 'dpm++', got {sampler_mode!r}")
        if sampler_mode == "dpm++" and not use_gdm:
            raise ValueError("sampler_mode='dpm++' requires use_gdm=True")
        if encoder_reuse > 1 and not (use_gdm and sampler_mode in ("scan", "dpm++")):
            raise ValueError("encoder_reuse>1 (Faster-Diffusion encoder propagation) "
                             "requires use_gdm=True with sampler_mode 'scan' or 'dpm++'")
        if decode_mode not in DECODE_MODES:
            raise ValueError(f"decode_mode must be one of {DECODE_MODES}, got {decode_mode!r}")
        if encode_mode not in ENCODE_MODES:
            raise ValueError(f"encode_mode must be one of {ENCODE_MODES}, got {encode_mode!r}")
        if task not in TASKS:
            raise ValueError(f"unknown task: {task}")
        if encoder_reuse > 1:
            raise not_ported("encoder_reuse > 1 (the UNet encoder cache)",
                              "ROADMAP Queue 1, 'UNet encoder cache and encoder_reuse'")
        if output_transport == "device":
            raise not_ported("output_transport='device'", "ROADMAP Queue 1, 'Serving'")

        dev = self.device
        timings: Dict[str, float] = {}
        self.last_timings = timings
        t_prev = time.perf_counter()

        def mark(phase: str) -> None:
            nonlocal t_prev
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            timings[phase] = timings.get(phase, 0.0) + (now - t_prev)
            t_prev = now

        seed = seed if seed != -1 else int(np.random.randint(0, 2**31 - 1))
        cfg = self.codec.config
        sample_length = int(seconds * self.sample_rate)
        prompts = [prompt] * batch_size if isinstance(prompt, str) else list(prompt)
        if len(prompts) != batch_size:
            raise ValueError(f"{len(prompts)} prompts != batch_size {batch_size}")
        no_init = init_audio is None
        if no_init:
            init_audio = np.zeros((batch_size, sample_length, cfg.channels), np.float32)
        else:
            init_audio = np.asarray(init_audio, np.float32)
            if init_audio.ndim == 2:  # (T, ch) -> batch
                init_audio = np.repeat(init_audio[None], batch_size, axis=0)
            init_audio = np.stack([
                convert_audio(a, init_audio_sr or self.sample_rate, self.sample_rate,
                              cfg.channels)
                for a in init_audio
            ])
        mask, init_audio, causal = self._task_inputs(
            task, init_audio, sample_length, seconds, batch_size, inpainting_scope)
        mark("prep")

        if no_init and task == "text_guided":
            # the text_guided mask zeroes the whole clip, so the masked input
            # is zero: the encoder is not run, only its latent grid is needed
            frames = self.latent_frames(sample_length, encode_mode)
            init_emb = torch.zeros((batch_size, frames, cfg.dimension), device=dev)
        else:
            init_emb = self._encoder(encode_mode)(torch.from_numpy(init_audio).to(dev))
        mark("encode")
        latent_len = init_emb.shape[1]
        latent_mask = torch.from_numpy(self.latent_mask(mask, latent_len)).to(dev)
        masked_emb = init_emb * latent_mask

        cond = dict(self.conditioner([{"prompt": p} for p in prompts]))
        mark("conditioner")
        cond["masked_input"] = masked_emb.to(self.compute_dtype)
        cond["mask"] = latent_mask.to(self.compute_dtype)
        conditioning = assemble_conditioning(
            cond,
            cross_attn_cond_ids=self.cross_attn_cond_ids,
            global_cond_ids=self.global_cond_ids,
            input_concat_ids=self.input_concat_ids,
        )
        generator = torch.Generator(device=dev).manual_seed(seed)
        # the unmasked latent starts the sampler, as in the JAX package
        init_data = None if no_init else init_emb
        shape = (batch_size, latent_len, init_emb.shape[2])
        mark("assemble")

        with fp32_precision():
            if use_gdm:
                latents = self._get_gdm(steps).sample(
                    self._model_fn, shape, conditioning, generator, device=dev,
                    causal=causal, mode=sampler_mode, init_data=init_data,
                )
            else:
                latents = self.diffusion.p_sample_loop(
                    self._model_fn, shape, conditioning, generator, device=dev,
                    step=steps, causal=causal, init_data=init_data,
                )
            mark("sampler")
            if not decode:
                out = latents.cpu().numpy().transpose(0, 2, 1)  # (B, D, F)
                mark("fetch")
                return out
            if decode_mode == "whole":
                audio = self.codec.decode_latent(latents)
            else:
                audio = self.codec.decode_latent_chunked(
                    latents, dtype=torch.bfloat16 if decode_mode == "chunked_bf16" else None)
        if output_dtype == "int16":
            audio = (audio.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
        mark("decode")
        out = audio.cpu().numpy().transpose(0, 2, 1)  # (B, ch, T)
        mark("fetch")
        return out
