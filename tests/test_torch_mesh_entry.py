"""The port's device mesh (jen1_tpu_torch/parallel/) at its entry points,
on the CPU over gloo in two to four processes (tests/torch_mesh_ranks.py;
tests/test_torch_mesh.py holds the plan and training):

* `Jen1.mesh` with dp=2 against JAX's `Jen1` on a dp=2 mesh (the generate
  bar, 2e-2 / 2e-3) and against the unsharded port (tests/test_api.py's
  1e-4 / 1e-5), and with sp=4 against the unsharded port (1e-4 / 1e-5);
* `batch_generate --dp 2` against `--dp 1`;
* `train --distributed` on 2 ranks: one checkpoint, loadable by a
  single-process trainer.
"""

import json
import wave

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from jen1_tpu.parallel import mesh as jmesh
from torch_port_util import one_torch_thread


# ---------------------------------------------------------- generation


@pytest.fixture(scope="module")
def jen1_pair_1s():
    from torch_port_util import jen1_pair

    with one_torch_thread():
        yield jen1_pair()


def test_jen1_mesh_dp2_matches_jax_mesh_and_unsharded_port(jen1_pair_1s, tmp_path):
    """dp=2 against JAX's dp=2 mesh and the unsharded port; then the same
    request with int8 weights (replicated over dp) against the unsharded
    int8 request at a spread bar (the ground rule for int8 requests): each
    int8 conv rounds its input to bf16, so a request moves by whole bf16
    steps under a 1e-6 relative change of x_T; the mesh request stays
    within twice what that change does, in mean and max |diff|."""
    from jen1_tpu_torch.api.generation import latent_length
    from jen1_tpu_torch.diffusion import vdm as port_vdm
    from torch_port_util import vdm_initial_noise

    jj, pj = jen1_pair_1s
    kw = dict(prompt=["mesh parity", "second lane"], seed=9, steps=3, batch_size=2, seconds=1)
    jj.mesh = jmesh.make_mesh(dp=2, tp=1, devices=jax.devices()[:2])
    try:
        ref = jj.generate(**kw)
    finally:
        jj.mesh = None
    noise = torch.from_numpy(vdm_initial_noise(9, (2, latent_length(1600, 40), 8)))
    torch.save(noise, tmp_path / "noise.pt")
    torch.save(pj, tmp_path / "jen1.pt")
    saved = port_vdm.initial_noise
    port_vdm.initial_noise = lambda shape, generator, device: noise
    try:
        with one_torch_thread():
            single = pj.generate(**kw)
            quantized = torch.load(tmp_path / "jen1.pt", weights_only=False)
            ranks.quantize(quantized)
            single_int8 = quantized.generate(**kw)
            port_vdm.initial_noise = lambda shape, generator, device: noise * (1 + 1e-6)
            spread = np.abs(quantized.generate(**kw) - single_int8)
    finally:
        port_vdm.initial_noise = saved
    (out, out_int8), (out1, out1_int8) = ranks.spawn(
        ranks.mesh_generate, 2, tmp_path, str(tmp_path / "jen1.pt"), str(tmp_path / "noise.pt"),
        kw)
    assert out.shape == ref.shape == (2, 2, 1600)
    np.testing.assert_array_equal(out, out1)  # every rank returns the batch
    np.testing.assert_array_equal(out_int8, out1_int8)
    np.testing.assert_allclose(out, ref, rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(out, single, rtol=1e-4, atol=1e-5)
    assert np.isfinite(out_int8).all() and not np.array_equal(out_int8, out)
    diff = np.abs(out_int8 - single_int8)
    assert spread.max() > 0
    assert diff.mean() <= 2 * spread.mean() and diff.max() <= 2 * spread.max(), (
        diff.mean(), diff.max(), spread.mean(), spread.max())


def test_jen1_mesh_sp4_matches_unsharded_port(jen1_pair_1s, tmp_path):
    """sp=4: 1.6 s at 1600 Hz is 64 latent frames, 16 per rank (the tiny
    UNet's factor product is 8); 1 s (40 frames, 10 per rank) is refused.
    The UNet on int8 weights (its convs' halos taken before conv1d_int8w)
    sharded against whole at the quantized-UNet bar (rtol 1e-2 / atol
    1e-3): each int8 conv rounds its input to bf16, so the sharded
    GroupNorm's last-bit differences move whole bf16 steps."""
    _, pj = jen1_pair_1s
    kw = dict(prompt="sp parity", seed=11, steps=3, batch_size=1, seconds=1.6)
    with one_torch_thread():
        ref = pj.generate(**kw)
    torch.save(pj, tmp_path / "jen1.pt")
    outs = ranks.spawn(ranks.mesh_generate, 4, tmp_path, str(tmp_path / "jen1.pt"), None, kw,
                       4, dict(kw, seconds=1))
    for out, refused, (whole, sharded) in outs:
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
        assert "multiple of the UNet's factor product 8" in refused
        torch.testing.assert_close(sharded, whole, rtol=1e-2, atol=1e-3)


def test_jen1_mesh_refuses_uneven_batches(jen1_pair_1s):
    _, pj = jen1_pair_1s

    class Mesh(dict):
        def get_local_rank(self, axis):
            return 0

    pj.mesh = Mesh(dp=2, sp=1, tp=1)
    try:
        with pytest.raises(ValueError, match="not divisible by dp"):
            pj.generate(["a", "b", "c"], seed=1, steps=1, batch_size=3, seconds=1)
    finally:
        pj.mesh = None


def _cli_config(tmp_path, batch_size, channels=8, eval_interval=0):
    from jen1_tpu_torch.config import tiny_test_config

    cfg = tiny_test_config()
    cfg.conditioner_config.t5_config.t5_model_name = "tiny-test"
    cfg.conditioner_config.t5_config.max_length = cfg.model_config.context_embedding_max_length
    cfg.dataset_config.batch_size = batch_size
    cfg.eval_interval = eval_interval
    if channels != 8:
        import dataclasses

        cfg.model_config = dataclasses.replace(
            cfg.model_config, in_channels=channels, out_channels=channels,
            context_channels=(channels + 1,))
    path = tmp_path / "cfg.json"
    cfg.to_json(str(path))
    return path


def _wav(path):
    with wave.open(str(path)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def test_batch_generate_dp2_writes_what_dp1_writes(tmp_path):
    from jen1_tpu_torch.api import batch_generate

    cfg = _cli_config(tmp_path, 2, channels=128)
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("warm jazz\nsolo cello\nfast drums\n")
    argv = ["--prompts", str(prompts), "--config", str(cfg), "--seconds", "1", "--steps", "2",
            "--batch-size", "2", "--use-gdm", "--device", "cpu"]
    with one_torch_thread():
        batch_generate.main([*argv, "--out", str(tmp_path / "dp1")])
    ranks.spawn(ranks.cli_main, 2, tmp_path, "jen1_tpu_torch.api.batch_generate",
                [*argv, "--out", str(tmp_path / "dp2"), "--dp", "2"])
    one, two = tmp_path / "dp1", tmp_path / "dp2"
    assert sorted(p.name for p in two.iterdir()) == sorted(p.name for p in one.iterdir()) == [
        "00000.wav", "00001.wav", "00002.wav", "manifest.json"]
    assert json.loads((two / "manifest.json").read_text()) == json.loads(
        (one / "manifest.json").read_text())
    for name in ("00000.wav", "00001.wav", "00002.wav"):
        # int16 PCM: a row computed alone may round one sample the other way
        np.testing.assert_allclose(_wav(two / name), _wav(one / name), atol=1)


def test_train_cli_distributed_on_two_ranks_writes_one_checkpoint(tmp_path):
    """`train --distributed` over dp=2 with fsdp: one checkpoint, which
    loads into a single-process trainer."""
    from jen1_tpu_torch.ckpt.checkpoint import CheckpointManager
    from jen1_tpu_torch.config import Config

    cfg = _cli_config(tmp_path, 6, eval_interval=2)
    latents = tmp_path / "latents"
    latents.mkdir()
    g = np.random.default_rng(0)
    for i in range(14):
        np.save(latents / f"clip{i}.npy", g.standard_normal((48, 8)).astype(np.float32))
        (latents / f"clip{i}.json").write_text(json.dumps({"prompt": f"song {i}"}))
    ranks.spawn(ranks.cli_main, 2, tmp_path, "jen1_tpu_torch.train.train",
                ["--config", str(cfg), "--latents-dir", str(latents), "--max-steps", "2",
                 "--device", "cpu", "--distributed", "--fsdp", "--save-dir",
                 str(tmp_path / "ckpt")])
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assert ckpt.all_steps() == [2]
    saved, meta = ckpt.restore()
    assert np.isfinite(meta["loss"])
    config = Config.from_json(str(cfg))
    with one_torch_thread():
        trainer = ranks.build(config)
        state = trainer.load_state_dict(saved)
        assert state.step == 2
        back = trainer.state_dict(state)
    for k in saved:
        assert torch.equal(back[k], saved[k]), k
