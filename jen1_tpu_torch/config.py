"""Configuration dataclasses (port of jen1_tpu/config.py).

A copy of the fields the generation slice reads, with the same names and
defaults as the JAX package, plus the `longform_config()` and
`tiny_test_config()` presets. JSON round-tripping is not ported yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass
class VDMConfig:
    """Continuous-time trig-schedule v-diffusion (jen1_tpu/config.py:82-94)."""

    embedding_scale: float = 0.8
    batch_cfg: bool = True
    scale_cfg: bool = True


@dataclass
class DiffusionConfig:
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
    dtype: str = "bfloat16"  # compute dtype; params are always fp32
    use_flash_attention: bool = True
    flash_min_seq_len: int = 1024
    tie_transformer_projections: bool = False


@dataclass
class T5Config:
    id: str = "prompt"
    t5_model_name: str = "google/flan-t5-large"
    max_length: int = 128
    project_out: bool = True


@dataclass
class ConditionerConfig:
    cond_dim: int = 1024
    default_keys: Dict[str, str] = field(default_factory=dict)
    conditioning_type: Tuple[str, ...] = ("t5",)
    t5_config: T5Config = field(default_factory=T5Config)


@dataclass
class Config:
    """Root config: the subset of jen1_tpu.config.Config that generation reads."""

    seed: int = 4996
    diffusion_config: DiffusionConfig = field(default_factory=DiffusionConfig)
    model_config: ModelConfig = field(default_factory=ModelConfig)
    conditioner_config: ConditionerConfig = field(default_factory=ConditionerConfig)


def longform_config() -> Config:
    """Long-form preset: attention at level 1 (downsample 4), where a 30 s
    clip attends over 4500 / 4 = 1125 frames, above `flash_min_seq_len`, so
    the flash-attention kernel runs (jen1_tpu/config.py:413-433)."""
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
    cfg.conditioner_config.cond_dim = 16
    return cfg
