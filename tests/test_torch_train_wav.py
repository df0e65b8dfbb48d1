"""The training CLI of jen1_tpu_torch on the CPU from audio files: preprocess,
wav -> latent training, `--profile`, LoRA fine-tuning over a trained base,
and generation from the base and its adapter.

The corpus is six 1 s 48 kHz stereo WAV files with sidecar prompts; the
config is tiny_test_config with 128 latent channels (the EnCodec-48k
codec's, random here) and 0.5 s windows (75 latent frames).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from jen1_tpu_torch.api.generation import Jen1
from jen1_tpu_torch.ckpt.checkpoint import CheckpointManager
from jen1_tpu_torch.config import Config, tiny_test_config
from jen1_tpu_torch.data import preprocess
from jen1_tpu_torch.data.audio_io import write_wav
from jen1_tpu_torch.train import train as train_cli
from jen1_tpu_torch.utils import profiling
from torch_port_util import synthetic_clip

pytestmark = pytest.mark.filterwarnings("ignore:jen1_tpu_torch. no codec weights")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavs")
    (root / "audios").mkdir()
    (root / "metadata").mkdir()
    for i in range(6):
        write_wav(str(root / "audios" / f"take{i}.wav"), synthetic_clip(i, 1.0, 48_000), 48_000)
        (root / "metadata" / f"take{i}.json").write_text(json.dumps({"prompt": f"take {i}"}))
    cfg = tiny_test_config()
    cfg.model_config = dataclasses.replace(cfg.model_config, in_channels=128, out_channels=128,
                                           context_channels=(129,))
    cfg.conditioner_config.t5_config.t5_model_name = "tiny-test"
    cfg.conditioner_config.t5_config.max_length = cfg.model_config.context_embedding_max_length
    cfg.dataset_config.sample_duration = 0.5
    cfg.eval_interval = 2
    cfg.to_json(str(root / "cfg.json"))
    return root


def records(log_dir):
    return [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]


def test_wav_training_with_profile(corpus, tmp_path):
    """3 steps from --dataset-dir: each batch encoded (encode_time logged),
    finite losses, and --profile's trace of step 2 holds the annotations."""
    logs = tmp_path / "logs"
    train_cli.main(["--config", str(corpus / "cfg.json"), "--dataset-dir", str(corpus),
                    "--max-steps", "3", "--device", "cpu", "--log-dir", str(logs), "--profile"])
    train = [r for r in records(logs) if "loss/train" in r]
    assert [r["step"] for r in train] == [1, 2, 3]
    assert all(np.isfinite(r["loss/train"]) and r["encode_time"] > 0 for r in train)
    assert any("loss/val" in r for r in records(logs))
    traces = sorted(logs.glob("trace_*.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert {"train_step", "encode", "forward_backward", "optimizer"} <= names


def test_preprocess_train_lora_generate(corpus, tmp_path):
    """preprocess encode -> a base run on the latents -> a LoRA run from the
    wav files over that base (--lora-rank 4) -> Jen1(ckpt_path=base,
    lora_path=run) generates; the run's checkpoint holds the adapter alone."""
    latents = tmp_path / "latents"
    preprocess.main(["encode", "--dataset-dir", str(corpus), "--out", str(latents),
                     "--sample-duration", "0.5", "--device", "cpu"])
    assert len(list(latents.glob("take*_000[01].npy"))) == 12
    assert np.load(latents / "take0_0000.npy").shape == (75, 128)
    cfg = str(corpus / "cfg.json")
    base, run = tmp_path / "base", tmp_path / "run"
    train_cli.main(["--config", cfg, "--latents-dir", str(latents), "--max-steps", "2",
                    "--device", "cpu", "--log-dir", str(tmp_path / "l0"),
                    "--save-dir", str(base)])
    train_cli.main(["--config", cfg, "--dataset-dir", str(corpus), "--max-steps", "2",
                    "--device", "cpu", "--log-dir", str(tmp_path / "l1"), "--save-dir", str(run),
                    "--lora-rank", "4", "--lora-alpha", "8", "--lora-base-ckpt", str(base)])
    state, _ = CheckpointManager(str(run)).restore()
    params = [k for k in state if k.startswith("params/")]
    assert params and all(k.endswith((".kernel.a", ".kernel.b")) for k in params)
    config = Config.from_json(cfg)
    config.lora_config.alpha = 8.0
    jen1 = Jen1(str(base), config=config, lora_path=str(run), device="cpu")
    assert jen1.lora_scale == 2.0
    plain = Jen1(str(base), config=config, device="cpu")
    diffs = [float((p - q).detach().abs().max())
             for p, q in zip(jen1.model.parameters(), plain.model.parameters())]
    assert sum(d > 0 for d in diffs) == len(params) // 2
    out = jen1.generate("take 1", seed=0, steps=2, seconds=0.5)
    assert out.shape == (1, 2, 24_000) and np.isfinite(out).all()


def test_step_timer_and_trace_context(tmp_path):
    timer = profiling.StepTimer(warmup=1, device="cpu")
    for _ in range(3):
        with timer:
            torch.ones(8).sum()
    assert timer.stats()["steps"] == 2
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("region_x"):
            torch.ones(4) * 2
    (path,) = tmp_path.glob("trace_*.json")
    assert "region_x" in path.read_text()
    with pytest.raises(RuntimeError, match="no trace"):
        profiling.stop_trace()
