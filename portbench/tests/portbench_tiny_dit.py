"""A tiny Stable Audio Open cell for CPU tests: the stable-audio-open
configuration at test widths (2 DiT blocks of 4 heads of 64, a 2-kv-head
context, the tiny T5, a 3-block Oobleck decoder of hop 8), written into a
copy of the benchmark's folder layout beside portbench_tiny.py's."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.harness.registry import ROOT


def tiny_dit_root(tmp: Path, dtype: str = "float32", limit=0.05, frames: int = 130) -> Path:
    """A cell "tiny" of `frames` latent frames (the default reaches the
    flash route from 128 tokens on), B=2, 3 steps, CFG 7."""
    root = Path(tmp) / "portbench"
    for d in ("drivers", "metrics"):
        shutil.copytree(ROOT / d, root / d)
    for d in ("configs", "traffic", "workloads"):
        (root / d).mkdir(parents=True)
    cfg = json.loads((ROOT / "configs" / "stable-audio-open.json").read_text())
    c = cfg["config"]
    c["dit_config"].update(io_channels=8, embed_dim=256, depth=2, num_heads=4,
                           cond_token_dim=128, global_cond_dim=256, dtype=dtype)
    c["oobleck_config"].update(dimension=8, base_channels=8, c_mults=[1, 2, 4],
                               strides=[2, 2, 2])
    c["conditioner_config"]["cond_dim"] = 128
    c["conditioner_config"]["t5_config"].update(t5_model_name="tiny-test", max_length=8)
    (root / "configs" / "tiny.json").write_text(json.dumps(cfg))
    mix = dict(driver="generate_dit", batch=2, samples=frames * 8, steps=3,
               caption_words=[2, 6], seconds_start=0, seconds_total=47, check_clips=2)
    (root / "traffic" / "tiny.json").write_text(json.dumps(mix))
    cell = dict(config="tiny", traffic="tiny", chips=1, why="CPU test",
                limits={"audio_rel_err": limit})
    (root / "workloads" / "tiny.json").write_text(json.dumps(cell))
    return root
