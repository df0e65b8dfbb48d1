"""Configuration dataclasses (port of jen1_tpu/config.py).

A copy of every field of the JAX `Config` tree, with the same names and
defaults, the JSON round trip of `jen1_tpu/config.py:318-381` (a JSON written
by the JAX `Config.to_json()` loads; keys that neither package knows are
ignored, as there) and the `longform_config()`, `tiny_test_config()`,
`composer_config()` and `tiny_composer_test_config()` presets. Every
field builds what the JAX package builds from it.

Beyond the JAX tree the port carries a second model family, Stable Audio
Open 1.0 (`stable_audio_open_config()`): `denoiser` "dit" builds
`models/dit.py` from `dit_config`, `codec_type` "oobleck" builds
`codec/oobleck.py` from `oobleck_config` (whose `sample_rate` is then the
waveform's), and `conditioner_config.number_start_config` the second
number conditioner (conditioning type "number_start"). Their defaults
build JEN-1 exactly as before. `weights_path` and
`codec_weights_path` name local torch state dicts that the T5 conditioner
and `Jen1`'s codec load. `compile_effort`, `use_fp16`,
`is_finetuning` and `mesh_axis_names` are carried for the round trip and
change nothing here (XLA's effort knob; read by no JAX module; the mesh is
refused by the trainer).
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass
class DataConfig:
    """jen1_tpu/config.py:17-46."""

    dataset_dir: str = ""
    sr: int = 48_000
    channels: int = 2
    min_duration: float = 0.0  # seconds
    max_duration: float = 300.0  # seconds
    sample_duration: float = 10.0  # seconds; sets the latent length (150 fps)
    aug_shift: bool = True
    batch_size: int = 3  # must be divisible by the number of tasks
    shuffle: bool = True
    train_test_split: float = 0.5
    durations_path: Optional[str] = None
    cumsum_path: Optional[str] = None
    audio_file_txt_path: Optional[str] = None
    latents_dir: Optional[str] = None  # precomputed <name>.npy latents
    num_workers: int = 0
    # host -> device dtype of the latent batch: 'float32' or 'bfloat16'
    latents_upload_dtype: str = "float32"


@dataclass
class GDMConfig:
    """Discrete Gaussian diffusion (jen1_tpu/config.py:49-78)."""

    steps: int = 1000
    noise_schedule: str = "linear"  # 'linear' | 'cosine'
    objective: str = "v"  # 'noise' | 'x0' | 'v'
    loss_type: str = "l2"  # 'l1' | 'l2'
    cfg_dropout_proba: float = 0.2
    embedding_scale: float = 0.8
    batch_cfg: bool = True
    scale_cfg: bool = True
    ddim_sampling_eta: float = 1.0
    uniform_noise_compat: bool = False
    dropout_during_sampling: bool = False
    sampling_timesteps: Optional[int] = None


@dataclass
class VDMConfig:
    """Continuous-time trig-schedule v-diffusion (jen1_tpu/config.py:82-94)."""

    loss_type: str = "l2"
    cfg_dropout_proba: float = 0.2
    embedding_scale: float = 0.8
    batch_cfg: bool = True
    scale_cfg: bool = True
    xt_target_compat: bool = False
    uniform_noise_compat: bool = False


@dataclass
class DiffusionConfig:
    gaussian_diffusion: GDMConfig = field(default_factory=GDMConfig)
    variational_diffusion: VDMConfig = field(default_factory=VDMConfig)


@dataclass
class ModelConfig:
    """1-D UNet denoiser (jen1_tpu/config.py:103-149)."""

    in_channels: int = 128
    channels: int = 128
    multipliers: Tuple[int, ...] = (1, 1, 1, 2, 2, 4, 4, 4, 8, 8)
    factors: Tuple[int, ...] = (1, 4, 4, 4, 2, 2, 2, 2, 2)
    num_blocks: Tuple[int, ...] = (1, 3, 3, 3, 3, 3, 3, 3, 1)
    attentions: Tuple[int, ...] = (0, 0, 0, 1, 1, 1, 1, 1, 1)
    patch_size: int = 1
    resnet_groups: int = 8
    use_context_time: bool = True
    kernel_multiplier_downsample: int = 2
    use_nearest_upsample: bool = False
    use_skip_scale: bool = True
    use_snake: bool = False
    use_stft: bool = False
    use_stft_context: bool = False
    use_xattn_time: bool = True
    out_channels: int = 128
    context_features: Optional[int] = None
    context_features_multiplier: int = 4
    context_channels: Tuple[int, ...] = (129,)  # masked_input(128) + mask(1)
    context_embedding_features: int = 1024
    context_embedding_max_length: int = 128
    attention_heads: int = 8
    attention_features: Optional[int] = None
    attention_multiplier: int = 1
    stft_num_fft: int = 1023
    stft_hop_length: int = 256
    n_tracks: int = 1  # Composer channel groups; 1 = single-track JEN-1
    dtype: str = "bfloat16"  # compute dtype; params are always fp32
    use_flash_attention: bool = True
    flash_min_seq_len: int = 1024
    tie_transformer_projections: bool = False
    # recompute each down block, the bottleneck and each up block in the
    # backward instead of storing their activations (torch.utils.checkpoint)
    remat: bool = False


@dataclass
class OptimizerConfig:
    """AdamW, clip and LinearLR warm-up (jen1_tpu/config.py:152-183)."""

    lr: float = 3e-5
    beta_1: float = 0.9
    beta_2: float = 0.95
    weight_decay: float = 0.1
    grad_clip: float = 0.7
    # torch LinearLR defaults: warm from lr*start_factor to lr*end_factor
    # over total_iters optimizer steps
    lr_start_factor: float = 1.0 / 3.0
    lr_end_factor: float = 1.0
    lr_total_iters: int = 5
    skip_nonfinite_updates: bool = True
    flatten_optimizer: bool = False
    fused_adamw: bool = True  # used when grad_accum_every == 1


@dataclass
class T5Config:
    id: str = "prompt"
    t5_model_name: str = "google/flan-t5-large"
    max_length: int = 128
    project_out: bool = True
    weights_path: Optional[str] = None  # a local HF T5EncoderModel state dict


@dataclass
class IntConfig:
    id: str = "seconds_start"
    min_val: int = 0
    max_val: int = 512


@dataclass
class NumberConfig:
    id: str = "seconds_total"
    min_val: float = 0
    max_val: float = 512


def _start_number_config() -> NumberConfig:
    return NumberConfig(id="seconds_start")


@dataclass
class ConditionerConfig:
    cond_dim: int = 1024
    default_keys: Dict[str, str] = field(default_factory=dict)
    conditioning_type: Tuple[str, ...] = ("t5",)
    t5_config: T5Config = field(default_factory=T5Config)
    int_config: IntConfig = field(default_factory=IntConfig)
    number_config: NumberConfig = field(default_factory=NumberConfig)
    # conditioning type "number_start": a second number conditioner
    # (Stable Audio Open's seconds_start); the port's own field
    number_start_config: NumberConfig = field(default_factory=_start_number_config)


@dataclass
class DiTConfig:
    """Stable Audio Open's DiT (stable-audio-tools `models/dit.py`,
    `DiffusionTransformer` with the "continuous_transformer" and
    `global_cond_type` "prepend"): io_channels latent channels in and out,
    `depth` pre-norm blocks of `num_heads` heads of embed_dim / num_heads,
    cross-attention to cond_token_dim-wide tokens (kv heads of the same
    head width over that width, each shared by num_heads / kv_heads query
    heads), a GLU feed-forward, the time and global embeddings summed into
    one token prepended to the sequence. Self-attention runs the flash
    kernel (K1) wherever `flash_attention_supported` holds (128 tokens or
    more)."""

    io_channels: int = 64
    embed_dim: int = 1536
    depth: int = 24
    num_heads: int = 24
    cond_token_dim: int = 768
    global_cond_dim: int = 1536
    dtype: str = "bfloat16"  # compute dtype; params are always fp32


@dataclass
class OobleckConfig:
    """Stable Audio Open's VAE decoder (stable-audio-tools
    `models/autoencoders.py::OobleckDecoder`): latent `dimension` to
    `channels` audio channels at `sample_rate`, upsampled by the product
    of `strides`."""

    sample_rate: int = 44_100
    channels: int = 2
    dimension: int = 64
    base_channels: int = 128
    c_mults: Tuple[int, ...] = (1, 2, 4, 8, 16)
    strides: Tuple[int, ...] = (2, 4, 4, 8, 8)

    @property
    def hop_length(self) -> int:
        return math.prod(self.strides)


@dataclass
class ParallelConfig:
    """Device-mesh layout (jen1_tpu/config.py:235-252), built by
    parallel/mesh.py over a torch.distributed process group: dp (-1: what
    tp * sp leave of the world), sp (the latent's length, parallel/sp.py),
    tp, and fsdp over dp."""

    dp: int = -1
    tp: int = 1
    sp: int = 1
    fsdp: bool = False
    mesh_axis_names: Tuple[str, ...] = ("dp", "sp", "tp")


@dataclass
class LoraConfig:
    """LoRA fine-tuning (jen1_tpu/config.py:255-270; train/lora.py); rank 0
    disables it. scale = alpha / rank; targets is a regex over the flax
    parameter paths (None: lora.DEFAULT_TARGETS); base_ckpt holds the
    frozen base (a checkpoint directory of this package or a reference
    .pth)."""

    rank: int = 0
    alpha: float = 16.0
    targets: Optional[str] = None
    base_ckpt: Optional[str] = None


@dataclass
class Config:
    """Root config: every field of jen1_tpu.config.Config."""

    save_dir: str = ""
    log_dir: str = ""
    # a local EnCodec-48k state dict, facebookresearch or HF layout
    codec_weights_path: Optional[str] = None
    # the reference's latent pipeline: per-1 s-segment volume normalisation
    # and RVQ codes concatenated across the 1 %-overlapping segments
    # (`EncodecModel.encode_latent_segmented`); generate() encodes with it
    codec_segmented_latents: bool = False
    compile_effort: Optional[float] = None
    use_fp16: bool = True
    use_ema: bool = False
    ema_decay: float = 0.999
    is_finetuning: bool = False
    seed: int = 4996
    tasks: Tuple[str, ...] = ("text_guided", "music_inpaint", "music_cont")
    num_epoch: int = 100
    eval_interval: int = 30
    grad_accum_every: int = 10
    diffusion_type: str = "gdm"  # 'gdm' | 'vdm'
    dataset_config: DataConfig = field(default_factory=DataConfig)
    diffusion_config: DiffusionConfig = field(default_factory=DiffusionConfig)
    model_config: ModelConfig = field(default_factory=ModelConfig)
    optimizer_config: OptimizerConfig = field(default_factory=OptimizerConfig)
    conditioner_config: ConditionerConfig = field(default_factory=ConditionerConfig)
    parallel_config: ParallelConfig = field(default_factory=ParallelConfig)
    lora_config: LoraConfig = field(default_factory=LoraConfig)
    # the port's own fields (module docstring): the model family
    denoiser: str = "unet"  # 'unet' (model_config) | 'dit' (dit_config)
    codec_type: str = "encodec"  # 'encodec' (48 kHz) | 'oobleck' (oobleck_config)
    dit_config: DiTConfig = field(default_factory=DiTConfig)
    oobleck_config: OobleckConfig = field(default_factory=OobleckConfig)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, path: Optional[str] = None) -> str:
        text = json.dumps(self.to_dict(), indent=2, default=str)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        return _dataclass_from_dict(cls, d)

    @classmethod
    def from_json(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def override(self, **dotted: Any) -> "Config":
        """Dotted-path overrides, e.g. override(**{"model_config.channels": 64})."""
        d = self.to_dict()
        for key, value in dotted.items():
            node = d
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            node[parts[-1]] = value
        return Config.from_dict(d)


def _dataclass_from_dict(cls, d):
    """Build `cls` from a dict: nested dataclasses recurse, JSON lists become
    tuples where the field is a tuple, keys that are no field are ignored
    (as the JAX package ignores them)."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        value = d[f.name]
        ftype = _resolve(f.type)
        if dataclasses.is_dataclass(ftype) and isinstance(value, dict):
            kwargs[f.name] = _dataclass_from_dict(ftype, value)
        elif isinstance(value, list) and str(f.type).startswith(("Tuple", "typing.Tuple")):
            kwargs[f.name] = tuple(value)
        else:
            kwargs[f.name] = value
    return cls(**kwargs)


def _resolve(tp):
    """A dataclass named by a string annotation (`from __future__ import
    annotations`), else the annotation itself."""
    if isinstance(tp, str):
        return globals().get(tp.split("[")[0], tp)
    return tp


def composer_config(n_tracks: int = 4) -> Config:
    """JEN-1-Composer-style multi-track preset (jen1_tpu/config.py:384-408):
    the default UNet with in/out = 128 * n_tracks channels, the channel-concat
    conditioning carrying each track's masked latent plus one mask channel
    per track, the track_gen task beside the three single-track ones, and
    batch 4."""
    cfg = Config()
    cfg.model_config = dataclasses.replace(
        cfg.model_config,
        in_channels=128 * n_tracks,
        out_channels=128 * n_tracks,
        context_channels=(128 * n_tracks + n_tracks,),
        n_tracks=n_tracks,
        use_flash_attention=True,
    )
    cfg.tasks = ("text_guided", "music_inpaint", "music_cont", "track_gen")
    cfg.dataset_config = dataclasses.replace(cfg.dataset_config, batch_size=4)
    return cfg


def longform_config() -> Config:
    """Long-form preset: attention at level 1 (downsample 4), where a 30 s
    clip attends over 4500 / 4 = 1125 frames, above `flash_min_seq_len`, so
    the flash-attention kernels run (jen1_tpu/config.py:413-433)."""
    cfg = Config()
    mc = cfg.model_config
    cfg.model_config = dataclasses.replace(
        mc,
        attentions=(0, 1, 0) + mc.attentions[3:],
        use_flash_attention=True,
    )
    return cfg


def tiny_test_config() -> Config:
    """Miniature config for fast hermetic tests (jen1_tpu/config.py:436-461)."""
    cfg = Config()
    cfg.model_config = ModelConfig(
        in_channels=8,
        channels=8,
        multipliers=(1, 2, 2, 4),
        factors=(2, 2, 2),
        num_blocks=(1, 1, 1),
        attentions=(0, 1, 1),
        resnet_groups=2,
        context_channels=(9,),
        context_embedding_features=16,
        context_embedding_max_length=6,
        attention_heads=2,
        attention_multiplier=1,
        out_channels=8,
        dtype="float32",
        use_flash_attention=False,
    )
    cfg.diffusion_config.gaussian_diffusion.steps = 8
    # the linear schedule overflows beta <= 1 at tiny step counts
    cfg.diffusion_config.gaussian_diffusion.noise_schedule = "cosine"
    cfg.conditioner_config.cond_dim = 16
    cfg.dataset_config.batch_size = 3
    cfg.grad_accum_every = 1
    return cfg


def tiny_composer_test_config(n_tracks: int = 2) -> Config:
    """Miniature Composer config: 4 latent channels per track on the
    tiny_test_config UNet (jen1_tpu/config.py:464-478)."""
    track_dim = 4
    cfg = tiny_test_config()
    cfg.model_config = dataclasses.replace(
        cfg.model_config,
        in_channels=track_dim * n_tracks,
        out_channels=track_dim * n_tracks,
        context_channels=(track_dim * n_tracks + n_tracks,),
        n_tracks=n_tracks,
    )
    cfg.tasks = ("text_guided", "music_inpaint", "music_cont", "track_gen")
    cfg.dataset_config = dataclasses.replace(cfg.dataset_config, batch_size=4)
    return cfg


def stable_audio_open_config() -> Config:
    """Stable Audio Open 1.0 at its published widths
    (huggingface.co/stabilityai/stable-audio-open-1.0, model_config.json):
    the 1.06 B-parameter DiT, T5-base (ReLU) text tokens of 768 with no
    projection, number conditioners for seconds_start and seconds_total
    (0-512 s) as cross-attention tokens and, concatenated, the global
    condition, the Oobleck VAE decoder at 44.1 kHz stereo; the v objective
    on the port's VDM sampler (the trigonometric schedule) with batch CFG
    at scale 7 and no rescale; bf16 compute over fp32 weights."""
    cfg = Config()
    cfg.denoiser = "dit"
    cfg.codec_type = "oobleck"
    cfg.diffusion_type = "vdm"
    vdm = cfg.diffusion_config.variational_diffusion
    vdm.embedding_scale = 7.0
    vdm.batch_cfg = True
    vdm.scale_cfg = False
    vdm.cfg_dropout_proba = 0.1
    cc = cfg.conditioner_config
    cc.cond_dim = 768
    cc.conditioning_type = ("t5", "number_start", "number")
    cc.t5_config = T5Config(id="prompt", t5_model_name="t5-base", max_length=128,
                            project_out=False)
    cc.number_start_config = NumberConfig(id="seconds_start", min_val=0, max_val=512)
    cc.number_config = NumberConfig(id="seconds_total", min_val=0, max_val=512)
    cfg.dataset_config = dataclasses.replace(cfg.dataset_config, sr=44_100,
                                             sample_duration=2_097_152 / 44_100)
    return cfg


def tiny_stable_audio_test_config() -> Config:
    """Stable Audio Open's structure at test widths: 2 blocks of 4 heads of
    64 (the published head width, so rotary covers half of each head), a
    128-wide context (2 kv heads, each shared by 2 query heads), the tiny
    T5 and a 3-block Oobleck decoder of hop 8, fp32 compute."""
    cfg = stable_audio_open_config()
    cfg.dit_config = DiTConfig(io_channels=8, embed_dim=256, depth=2, num_heads=4,
                               cond_token_dim=128, global_cond_dim=256, dtype="float32")
    cfg.oobleck_config = OobleckConfig(dimension=8, base_channels=8, c_mults=(1, 2, 4),
                                       strides=(2, 2, 2))
    cc = cfg.conditioner_config
    cc.cond_dim = 128
    cc.t5_config = T5Config(id="prompt", t5_model_name="tiny-test", max_length=8,
                            project_out=False)
    return cfg
