"""A tiny cell for CPU tests: the flagship configuration at test widths
(every kind of UNet level: factor 1 and 4, attention, the bottleneck's),
the tiny T5, the real codec decoder over 1.2 s clips (chunked), written
into a copy of the benchmark's folder layout."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.harness.registry import ROOT


def tiny_root(tmp: Path, dtype: str = "float32", limit=0.05,
              driver: str = "generate") -> Path:
    root = Path(tmp) / "portbench"
    for d in ("drivers", "metrics"):
        shutil.copytree(ROOT / d, root / d)
    for d in ("configs", "traffic", "workloads"):
        (root / d).mkdir(parents=True)
    cfg = json.loads((ROOT / "configs" / "flagship.json").read_text())
    cfg["config"]["model_config"].update(
        channels=8, multipliers=[1, 2, 2, 4], factors=[1, 4, 2], num_blocks=[1, 2, 1],
        attentions=[0, 1, 1], resnet_groups=2, attention_heads=2,
        context_embedding_features=16, context_embedding_max_length=8, dtype=dtype)
    cc = cfg["config"]["conditioner_config"]
    cc["cond_dim"] = 16
    cc["t5_config"].update(t5_model_name="tiny-test", max_length=8)
    (root / "configs" / "tiny.json").write_text(json.dumps(cfg))
    mix = dict(driver="generate", batch=2, seconds=1.2, steps=3, caption_words=[2, 6],
               check_batches=1)
    if driver == "train":
        mix = dict(driver="train", files=8, clip_seconds=0.6, caption_words=[2, 6],
                   check_steps=3, trace_steps=2)
        cfg["config"]["grad_accum_every"] = 4
    if driver == "serve":
        mix = dict(driver="serve", rate_per_s=4.0, clip_seconds=[0.6, 1.2], steps=3,
                   caption_words=[2, 6], max_batch=2, max_wait_ms=50, check_requests=3,
                   trace_from_s=0.2, trace_seconds=1)
    (root / "traffic" / "tiny.json").write_text(json.dumps(mix))
    limits = {"audio_rel_err": limit} if driver != "train" else limit
    cell = dict(config="tiny", traffic="tiny", chips=1, why="CPU test", limits=limits)
    (root / "workloads" / "tiny.json").write_text(json.dumps(cell))
    return root
