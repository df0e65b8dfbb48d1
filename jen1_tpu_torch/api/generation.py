"""Jen1 text-to-music inference API (port of jen1_tpu/api/generation.py).

`Jen1(...).generate(prompt, ...)` returns the waveform (B, channels,
samples) as a numpy array, like the JAX package. This slice runs
`task="text_guided"` with the VDM sampler and the chunked decode; other
tasks, GDM, checkpoint loading, `generate_long*`, `generate_tracks` and
`save_audio` are not ported yet and raise NotImplementedError.

The model runs on `device` ("cuda" by default; "cpu" only when asked).
Weights are random from `config.seed`, as in the JAX package without a
checkpoint; `ckpt/from_jax.py` loads JAX parameter trees into them.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from jen1_tpu_torch.config import Config
from jen1_tpu_torch.conditioning.conditioners import (
    assemble_conditioning,
    create_multi_conditioner,
)
from jen1_tpu_torch.diffusion.vdm import create_variational_diffusion
from jen1_tpu_torch.models.unet import unet_from_model_config
from jen1_tpu_torch.ops.initializers import init_module


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
        *,
        device="cuda",
    ):
        if ckpt_path is not None:
            raise NotImplementedError("checkpoint loading is not ported yet")
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
        # Phase walls of the last generate() call, in seconds. On the card
        # each phase ends with torch.cuda.synchronize(), so they are device
        # walls: prep / conditioner / assemble / sampler / decode / fetch.
        self.last_timings: Dict[str, float] = {}

    def _model_fn(self, x, t, **kw):
        """The UNet at the compute dtype, fp32 at the sampler boundary."""
        dtype = self.compute_dtype
        kw["embedding"] = kw["embedding"].to(dtype)
        if kw.get("channels_list") is not None:
            kw["channels_list"] = [c.to(dtype) for c in kw["channels_list"]]
        return self.model(x.to(dtype), t, **kw).float()

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
        decode: bool = True,
        decode_mode: str = "chunked",
        output_dtype: str = "float32",
    ) -> np.ndarray:
        """Waveform (B, channels, samples) float32, or int16 PCM with
        output_dtype="int16" (converted on the device)."""
        if output_dtype not in ("float32", "int16"):
            raise ValueError(f"output_dtype must be 'float32' or 'int16', got {output_dtype!r}")
        if use_gdm:
            raise NotImplementedError("use_gdm=True (GDM/DDIM) is not ported yet")
        if task != "text_guided" or init_audio is not None:
            raise NotImplementedError("only task='text_guided' without init_audio is ported")
        if not decode or decode_mode != "chunked":
            raise NotImplementedError("only decode_mode='chunked' is ported")

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
        # text_guided masks the whole clip, so the masked input is zero and
        # the codec encoder is not run: only the latent grid is needed.
        frames = latent_length(sample_length, cfg.hop_length)
        latent_mask = torch.zeros((batch_size, frames, 1), device=dev)
        masked_emb = torch.zeros((batch_size, frames, cfg.dimension), device=dev)
        prompts = [prompt] * batch_size if isinstance(prompt, str) else list(prompt)
        if len(prompts) != batch_size:
            raise ValueError(f"{len(prompts)} prompts != batch_size {batch_size}")
        mark("prep")

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
        mark("assemble")

        # fp32 products in full fp32 (no TF32), as the JAX package asks of
        # XLA with Precision.HIGHEST; bf16 compute is unaffected.
        with torch.backends.cudnn.flags(
            enabled=torch.backends.cudnn.enabled,
            benchmark=torch.backends.cudnn.benchmark,
            deterministic=torch.backends.cudnn.deterministic,
            allow_tf32=False,
        ):
            latents = self.diffusion.p_sample_loop(
                self._model_fn, (batch_size, frames, cfg.dimension), conditioning,
                generator, device=dev, step=steps, causal=False,
            )
            mark("sampler")
            audio = self.codec.decode_latent_chunked(latents)
        if output_dtype == "int16":
            audio = (audio.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
        mark("decode")
        out = audio.cpu().numpy().transpose(0, 2, 1)  # (B, ch, T)
        mark("fetch")
        return out
