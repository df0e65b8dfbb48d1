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
`generate_long` / `generate_long_stream` chain `music_cont` windows into a
clip of any length, and `save_audio` writes WAV or FLAC.

Weights. `ckpt_path` is a checkpoint directory of this package
(`ckpt/checkpoint.py`, written by the trainer; `use_ema_params` takes its
EMA) or a reference JEN-1 `.pth`/`.pt`/`.bin` (`ckpt/torch_import.py`);
without one the UNet is random from `config.seed`, as in the JAX package.
The T5 encoder and the codec load `conditioner_config.t5_config.
weights_path` and `codec_weights_path` (local torch state dicts) or are
random, with a warning. `weights_dtype="bfloat16"` stores the UNet's matrix
weights in bf16. `ckpt/from_jax.py` loads JAX parameter trees. int8
weight-only inference is a property of the UNet's modules:
`attach_qweights(jen1.model, quantize_conv_params(jen1.model))`
(`ops/int8_matmul.py`) makes its large stride-1 convs run K4.

Serving. `encoder_reuse=k` (GDM DDIM or DPM-Solver++) runs the UNet's
encoder on one step of every k and its decoder alone on the others, against
the cached encoder features (Faster-Diffusion encoder propagation).
`output_transport="device"` returns the result as a tensor on the model's
device, with no copy to the host and no synchronize after the decode: the
caller fetches it (`.cpu()`), as `jen1_tpu_torch.serve` does in its
completer threads. JAX's `rng_impl` and `compiler_options` are XLA knobs
with no counterpart here.

LoRA. `lora_path` names a checkpoint directory of a LoRA run
(`train/lora.py::LoRATrainer`); its adapter (the EMA one with
`use_ema_params`, where the run kept one) is merged into the UNet's weights
once at load, before the bf16 cast of `weights_dtype`, with the scale
`lora_scale` or `lora_config.alpha / rank`.

Composer. `generate_tracks` generates the n_tracks channel groups of a
multi-track config (`config.composer_config`), given any subset of tracks
as waveforms. The model runs on `device` ("cuda" by default; "cpu" only
when asked).
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
import warnings
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from jen1_tpu_torch.conditioning.conditioners import (
    assemble_conditioning,
    create_multi_conditioner,
)
from jen1_tpu_torch.ckpt.checkpoint import (
    CheckpointManager,
    has_checkpoints,
    unreadable_checkpoint,
)
from jen1_tpu_torch.config import Config
from jen1_tpu_torch.data.audio_io import convert_audio, write_wav
from jen1_tpu_torch.data.flac_write import write_flac
from jen1_tpu_torch.diffusion.gdm import create_gaussian_diffusion
from jen1_tpu_torch.diffusion.vdm import create_variational_diffusion
from jen1_tpu_torch.models.unet import unet_from_model_config
from jen1_tpu_torch.ops.conv import fp32_precision
from jen1_tpu_torch.ops.initializers import init_module

TASKS = ("text_guided", "music_inpaint", "music_cont")
REFERENCE_SUFFIXES = (".pth", ".pt", ".bin")
# the FiLM mapping head runs in fp32 before the compute-dtype cast
BF16_KEEP = ("to_time", "to_features", "to_mapping")
ENCODE_MODES = ("chunked", "whole")
DECODE_MODES = ("chunked", "chunked_bf16", "whole")


def _warn(msg: str) -> None:
    warnings.warn(f"jen1_tpu_torch: {msg}", UserWarning, stacklevel=3)


def cast_weights_bf16(model: torch.nn.Module) -> List[str]:
    """bf16 storage for the UNet's matrix weights; returns the names cast
    (jen1_tpu/api/generation.py:46-78). Floating parameters with ndim >= 2
    become bf16, except the FiLM mapping head's (`BF16_KEEP`), which run in
    fp32; vectors (biases, norm scales, Fourier weights) stay fp32. Every
    module casts its weight to the activation dtype at use, so under bf16
    compute the outputs equal fp32 storage's bit for bit while the weight
    bytes halve."""
    cast = []
    for name, p in model.named_parameters():
        if p.ndim >= 2 and p.is_floating_point() and not any(k in name for k in BF16_KEEP):
            p.data = p.data.to(torch.bfloat16)
            cast.append(name)
    return cast


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
        if weights_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(f"weights_dtype must be None, 'float32' or 'bfloat16', "
                             f"got {weights_dtype!r}")
        is_reference = ckpt_path is not None and str(ckpt_path).endswith(REFERENCE_SUFFIXES)
        if ckpt_path is not None and not is_reference and not has_checkpoints(ckpt_path):
            raise unreadable_checkpoint(ckpt_path)
        if lora_path is not None and not has_checkpoints(lora_path):
            raise unreadable_checkpoint(lora_path)
        self.config = config or Config()
        if ckpt_path is None and self.config.model_config.context_features is not None:
            # jen1_tpu's Jen1 initialises random weights without global
            # features and fails (jen1_tpu/api/generation.py:220-240 ->
            # models/unet.py:135); the port adds no feature it lacks
            raise ValueError(
                "model_config.context_features (global conditioning) needs ckpt_path: "
                "jen1_tpu's Jen1 cannot initialise such a model at random")
        self.device = resolve_device(device)
        self.sample_rate = sample_rate
        self.cross_attn_cond_ids = tuple(cross_attn_cond_ids)
        self.global_cond_ids = tuple(global_cond_ids)
        self.input_concat_ids = tuple(input_concat_ids)
        seed = self.config.seed

        # the reference ties the 1x1 conv before and after each Transformer1d
        # and trained on the segmented latent pipeline (generation.py:131-152);
        # switched on in a copy, so that the caller's config stays as it was
        if is_reference:
            self.config = copy.deepcopy(self.config)
            if not self.config.model_config.tie_transformer_projections:
                _warn("reference .pth checkpoint requires tie_transformer_projections=True; "
                      "enabling it.")
                self.config.model_config = dataclasses.replace(
                    self.config.model_config, tie_transformer_projections=True)
            if not self.config.codec_segmented_latents:
                _warn("reference .pth checkpoint was trained on the segmented (per-1s "
                      "volume-normalized) latent pipeline; enabling codec_segmented_latents.")
                self.config.codec_segmented_latents = True

        def gen(offset: int) -> torch.Generator:
            return torch.Generator(device=self.device).manual_seed(seed + offset)

        if conditioner is None:
            t5c = self.config.conditioner_config.t5_config
            if t5c.weights_path is None and t5c.t5_model_name != "tiny-test":
                _warn("T5 conditioner has no weights_path: the text encoder is "
                      "RANDOM-initialized and prompts will not steer generation. Set "
                      "config.conditioner_config.t5_config.weights_path to a FLAN-T5 "
                      "encoder state dict for real inference.")
            conditioner = create_multi_conditioner(
                self.config.conditioner_config, device=self.device, generator=gen(1)
            )
        self.conditioner = conditioner
        if codec is None:
            from jen1_tpu_torch.codec.model import encodec_48khz_config, make_codec

            codec = make_codec(self.config.codec_weights_path, encodec_48khz_config(),
                               device=self.device, generator=gen(2))
        self.codec = codec
        self.compute_dtype = (
            torch.bfloat16 if self.config.model_config.dtype == "bfloat16" else torch.float32
        )
        with torch.device(self.device):
            self.model = unet_from_model_config(self.config.model_config).eval()
        init_module(self.model, gen(0))
        if ckpt_path is not None:
            self._load_weights(ckpt_path, is_reference, use_ema_params)
        self.lora_scale = None
        if lora_path is not None:
            self.lora_scale = self._merge_lora(lora_path, lora_scale, use_ema_params)
        if weights_dtype == "bfloat16":
            cast_weights_bf16(self.model)
        self.diffusion = create_variational_diffusion(
            self.config.diffusion_config.variational_diffusion
        )
        self._gdm_cache: Dict[int, object] = {}
        # Phase walls of the last generate() call, in seconds. On the card
        # each phase ends with torch.cuda.synchronize(), so they are device
        # walls: prep / encode / conditioner / assemble / sampler / decode /
        # fetch.
        self.last_timings: Dict[str, float] = {}

    @torch.no_grad()
    def _load_weights(self, ckpt_path: str, is_reference: bool, use_ema_params: bool) -> None:
        """The UNet's weights from `ckpt_path` (jen1_tpu/api/generation.py:
        221-267): a reference file, or the latest step of a checkpoint
        directory, its `params` or, with use_ema_params, its `ema_params`."""
        if is_reference:
            from jen1_tpu_torch.ckpt.torch_import import load_reference_checkpoint

            load_reference_checkpoint(ckpt_path, self.model, self.config.model_config)
            return
        state, _ = CheckpointManager(ckpt_path).restore()
        prefix = "ema_params/" if use_ema_params else "params/"
        if use_ema_params and not any(k.startswith(prefix) for k in state):
            raise ValueError("use_ema_params=True but the checkpoint has no ema_params "
                             "(train with config.use_ema=True)")
        params = dict(self.model.named_parameters())
        saved = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
        if set(saved) != set(params):
            raise ValueError(
                f"{ckpt_path}: the checkpoint's {prefix[:-1]} do not fit this model "
                f"(missing {sorted(set(params) - set(saved))[:4]}, unexpected "
                f"{sorted(set(saved) - set(params))[:4]})")
        for name, p in params.items():
            p.copy_(saved[name])

    def _merge_lora(self, lora_path: str, lora_scale: Optional[float],
                    use_ema_params: bool) -> float:
        """Merge the adapter of the latest step of `lora_path` into the UNet
        (jen1_tpu/api/generation.py:268-290); returns the scale used."""
        from jen1_tpu_torch.train.lora import adapter_from_state, adapter_rank, merge_lora

        state, _ = CheckpointManager(lora_path).restore()
        use_ema = use_ema_params and any(k.startswith("ema_params/") for k in state)
        adapter = adapter_from_state(state, "ema_params/" if use_ema else "params/")
        scale = (lora_scale if lora_scale is not None
                 else self.config.lora_config.alpha / adapter_rank(adapter))
        merge_lora(self.model, adapter, scale)
        return scale

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
        """The UNet at the compute dtype, fp32 at the sampler boundary; with
        `return_encoder_cache` (output, cache), the cache at the compute
        dtype."""
        dtype = self.compute_dtype
        kw["embedding"] = kw["embedding"].to(dtype)
        if kw.get("channels_list") is not None:
            kw["channels_list"] = [c.to(dtype) for c in kw["channels_list"]]
        out = self.model(x.to(dtype), t, **kw)
        if kw.get("return_encoder_cache"):
            return out[0].float(), out[1]
        return out.float()

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
    ):
        """Waveform (B, channels, samples) float32, or int16 PCM with
        output_dtype="int16" (converted on the device); with decode=False
        the latent (B, dimension, frames). A numpy array, or with
        output_transport="device" the tensor on the model's device, returned
        without a synchronize after the decode (`last_timings` then ends at
        "decode" and has no "fetch").

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
        "stepwise" are one loop here. encoder_reuse=k > 1 (GDM, "scan" or
        "dpm++") runs the UNet's encoder on one step of each k-step block and
        its decoder alone on the others (`diffusion/gdm.py::reuse_schedule`)."""
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
        on_device = output_transport == "device"

        dev = self.device
        timings: Dict[str, float] = {}
        self.last_timings = timings
        t_prev = time.perf_counter()

        def mark(phase: str, sync: bool = True) -> None:
            nonlocal t_prev
            if sync and dev.type == "cuda":
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
                    encoder_reuse=int(encoder_reuse),
                )
            else:
                latents = self.diffusion.p_sample_loop(
                    self._model_fn, shape, conditioning, generator, device=dev,
                    step=steps, causal=causal, init_data=init_data,
                )
            mark("sampler")
            if not decode:
                if on_device:
                    return latents.transpose(1, 2)  # (B, D, F)
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
        mark("decode", sync=not on_device)
        if on_device:
            return audio.transpose(1, 2)  # (B, ch, T), still being computed
        out = audio.cpu().numpy().transpose(0, 2, 1)  # (B, ch, T)
        mark("fetch")
        return out

    def generate_long(self, prompt, total_seconds: float, **kw) -> np.ndarray:
        """A clip of `total_seconds` from chained windows, (B, channels,
        total_samples) (jen1_tpu/api/generation.py:687-724): the
        concatenated chunks of `generate_long_stream`, which takes the same
        keyword arguments."""
        return np.concatenate(list(self.generate_long_stream(prompt, total_seconds, **kw)),
                              axis=-1)

    def generate_long_stream(self, prompt, total_seconds: float, *,
                             window_seconds: float = 30.0, context_seconds: float = 10.0,
                             fade_seconds: float = 0.05, seed: int = -1, steps: int = 100,
                             batch_size: int = 1, use_gdm: bool = False,
                             sampler_mode: str = "scan", **gen_kw) -> Iterator[np.ndarray]:
        """Long-form output as a stream (jen1_tpu/api/generation.py:726-790).
        The first window is text_guided; each next one is `music_cont` on
        the last `context_seconds` of the audio so far, extending it by
        window_seconds - context_seconds, with seed + window index; window
        boundaries are joined by a linear crossfade of `fade_seconds`.
        Yields final (B, channels, n) float32 chunks as each window ends, so
        audio can be delivered after the first window: a window's fade
        region is held back until the next window has blended into it (or
        the stream ends), so the chunks concatenate exactly to
        `generate_long`'s output. Extra keyword arguments (decode_mode,
        encode_mode, ...) pass to every generate() call."""
        if context_seconds >= window_seconds:
            raise ValueError(f"context_seconds ({context_seconds}) must be < window_seconds "
                             f"({window_seconds})")
        seed = seed if seed != -1 else int(np.random.randint(0, 2**31 - 1))
        sr = self.sample_rate
        ctx_len = int(context_seconds * sr)
        fade = max(1, int(fade_seconds * sr))
        total = int(total_seconds * sr)
        common = dict(steps=steps, batch_size=batch_size, seconds=window_seconds,
                      use_gdm=use_gdm, sampler_mode=sampler_mode, **gen_kw)
        audio = self.generate(prompt, seed=seed, **common)  # (B, ch, T)
        emitted = 0  # samples yielded so far
        widx = 0
        while True:
            done = audio.shape[-1] >= total
            # every sample is final except the fade region the next window
            # blends into
            upto = min(audio.shape[-1] if done else audio.shape[-1] - fade, total)
            if upto > emitted:
                yield audio[..., emitted:upto]
                emitted = upto
            if done or emitted >= total:
                return
            widx += 1
            ctx = audio[..., -ctx_len:].transpose(0, 2, 1)  # (B, T, ch)
            out = self.generate(prompt, seed=seed + widx, task="music_cont", init_audio=ctx,
                                init_audio_sr=sr, **common)  # the first ctx_len are context
            new_tail = out[..., ctx_len - fade:]
            ramp = np.linspace(0.0, 1.0, fade, dtype=np.float32)
            head = audio[..., -fade:] * (1.0 - ramp) + new_tail[..., :fade] * ramp
            audio = np.concatenate([audio[..., :-fade], head, new_tail[..., fade:]], axis=-1)

    @torch.no_grad()
    def generate_tracks(self, prompt, *, seed: int = -1, steps: int = 100,
                        batch_size: int = 1, seconds: float = 30, use_gdm: bool = True,
                        context_tracks: Optional[Dict[int, np.ndarray]] = None,
                        context_tracks_sr: Optional[int] = None, decode: bool = True):
        """Multi-track generation (jen1_tpu/api/generation.py:792-922) with a
        Composer config (model_config.n_tracks > 1, the latent n_tracks
        channel groups of the codec's dimension). `context_tracks` maps a
        track index to a waveform (T, ch) or (B, T, ch) at
        `context_tracks_sr` (default: the model's rate), given as context and
        encoded chunked; the other tracks are generated, non-causally, with
        the GDM (DDIM over `steps`) or with use_gdm=False the VDM. Returns
        (B, n_tracks, channels, samples) float32, all tracks decoded as one
        batched chunked decode, or with decode=False the latent
        (B, n_tracks * track_dim, frames)."""
        from jen1_tpu_torch.models.composer import generate_tracks, split_tracks

        mc = self.config.model_config
        n_tracks = mc.n_tracks
        if n_tracks <= 1:
            raise ValueError("generate_tracks needs a composer config (model_config.n_tracks "
                             "> 1); see jen1_tpu_torch.config.composer_config")
        track_dim = mc.in_channels // n_tracks
        if track_dim != self.codec.config.dimension:
            raise ValueError(f"track_dim {track_dim} != codec latent dim "
                             f"{self.codec.config.dimension}")
        context_tracks = {int(ti): wav for ti, wav in (context_tracks or {}).items()}
        for ti in context_tracks:
            if not 0 <= ti < n_tracks:
                raise ValueError(f"track index {ti} out of range 0..{n_tracks - 1}")
        prompts = [prompt] * batch_size if isinstance(prompt, str) else list(prompt)
        if len(prompts) != batch_size:
            raise ValueError(f"{len(prompts)} prompts != batch_size {batch_size}")
        seed = seed if seed != -1 else int(np.random.randint(0, 2**31 - 1))
        dev = self.device
        channels = self.codec.config.channels
        sample_length = int(seconds * self.sample_rate)

        def encode_wave(wav) -> torch.Tensor:
            wav = np.asarray(wav, np.float32)
            if wav.ndim == 2:  # (T, ch) -> batch
                wav = np.repeat(wav[None], batch_size, axis=0)
            if context_tracks_sr and context_tracks_sr != self.sample_rate:
                wav = np.stack([convert_audio(a, context_tracks_sr, self.sample_rate, channels)
                                for a in wav])
            if wav.shape[1] < sample_length:
                wav = np.pad(wav, ((0, 0), (0, sample_length - wav.shape[1]), (0, 0)))
            return self.codec.encode_latent_chunked(
                torch.from_numpy(np.ascontiguousarray(wav[:, :sample_length])).to(dev))

        latents_in = {ti: encode_wave(wav) for ti, wav in context_tracks.items()}
        # the text conditioning; the track context's input_concat_cond
        # (masked_input, then one mask channel per track) comes from
        # models/composer.py::generate_tracks
        text_cond = assemble_conditioning(
            dict(self.conditioner([{"prompt": p} for p in prompts])),
            cross_attn_cond_ids=self.cross_attn_cond_ids,
            global_cond_ids=self.global_cond_ids,
            input_concat_ids=(),
        )
        diffusion = self._get_gdm(steps) if use_gdm else self.diffusion
        with fp32_precision():
            latents = generate_tracks(
                diffusion, self._model_fn, generator=torch.Generator(device=dev).manual_seed(seed),
                n_tracks=n_tracks, track_dim=track_dim,
                length=latent_length(sample_length, self.codec.config.hop_length),
                text_cond=text_cond, context_tracks=latents_in, batch=batch_size, device=dev,
                **({} if use_gdm else {"step": steps}))
            if not decode:
                return latents.cpu().numpy().transpose(0, 2, 1)  # (B, n * D, F)
            # every track in one batched decode: (n_tracks * B, F, D)
            audio = self.codec.decode_latent_chunked(
                torch.cat(split_tracks(latents, n_tracks), dim=0))
        audio = audio.cpu().numpy().reshape(n_tracks, batch_size, *audio.shape[1:])
        return audio.transpose(1, 0, 3, 2)  # (B, n_tracks, ch, T)


def save_audio(audio, file_path: str, sample_rate: int = 48_000) -> None:
    """Write (B, ch, T) (example 0) or (ch, T) float audio as 16-bit WAV, or
    as lossless 16-bit FLAC when file_path ends in .flac
    (jen1_tpu/api/generation.py:941-955)."""
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 3:
        audio = audio[0]
    if file_path.lower().endswith(".flac"):
        write_flac(file_path, audio.T, sample_rate)
    else:
        write_wav(file_path, audio.T, sample_rate)
