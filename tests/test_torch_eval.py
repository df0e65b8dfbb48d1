"""Port parity of the eval package (`jen1_tpu_torch/eval`) against
jen1_tpu/eval on the CPU, fp32, on the same numpy audio.

Bars: feature maps (log-mel, VGGish examples), SNR and spectral
convergence rtol 1e-4 (fp32 FFTs of two libraries); Gaussian fits rtol
1e-4 / atol 1e-5; the VGGish embedding rtol 1e-4 / atol 1e-5 of its
largest entry (six fp32 convs and three GEMMs); the random VGGish weights
bit-equal (both draw them with numpy). The Fréchet distance goes through
two eigendecompositions (fp32 in JAX, fp64 in the port), whose small
eigenvalues carry each library's rounding: it is compared on mismatched
sets, where the distance is large against that noise, at rtol 1e-3.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jen1_tpu.eval import metrics as jm
from jen1_tpu.eval import run_eval as jax_run_eval
from jen1_tpu.eval import vggish as jv
from jen1_tpu_torch.data.audio_io import write_wav
from jen1_tpu_torch.eval import metrics as pm
from jen1_tpu_torch.eval import run_eval
from jen1_tpu_torch.eval import vggish as pv
from torch_port_util import assert_close, rng

FEATURE = dict(rtol=1e-4, atol=1e-5)
FAD = dict(rel=1e-3, abs=0.0)


def clips(seed, b, seconds, sr=48_000, channels=2):
    """(B, T, ch) tones and noise."""
    g = rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f = g.uniform(50.0, 0.3 * sr, (b, 1, channels))
    tone = np.sin(2 * np.pi * f * t[None, :, None] + g.uniform(0, 6, (b, 1, channels)))
    return (0.4 * tone + 0.1 * g.standard_normal((b, len(t), channels))).astype(np.float32)


def test_mel_filterbank_identical():
    np.testing.assert_array_equal(pm._mel_filterbank(64, 513, 48_000),
                                  jm._mel_filterbank(64, 513, 48_000))
    np.testing.assert_array_equal(pv._mel_matrix(), jv._mel_matrix())


@pytest.mark.parametrize("shape", [(2, 12_000), (2, 12_000, 2)], ids=["mono", "stereo"])
def test_log_mel_embedding_matches_jax(shape):
    x = clips(0, 2, 0.25)[..., 0] if len(shape) == 2 else clips(0, 2, 0.25)
    ref = jm.log_mel_embedding(jnp.asarray(x))
    out = pm.log_mel_embedding(torch.from_numpy(x))
    assert out.shape == ref.shape == (2 * 22, 64)
    assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_fit_gaussian_and_frechet_distance_match_jax():
    g = rng(1)
    a = g.standard_normal((300, 16)).astype(np.float32)
    b = (1.3 * g.standard_normal((300, 16)) + 0.5).astype(np.float32)
    (mu_a, s_a), (mu_b, s_b) = jm._fit_gaussian(jnp.asarray(a)), jm._fit_gaussian(jnp.asarray(b))
    (pmu_a, ps_a), (pmu_b, ps_b) = pm._fit_gaussian(torch.from_numpy(a)), \
        pm._fit_gaussian(torch.from_numpy(b))
    assert_close(pmu_a, mu_a, **FEATURE)
    assert_close(ps_b, s_b, **FEATURE)
    ref = float(jm.frechet_distance(mu_a, s_a, mu_b, s_b))
    out = float(pm.frechet_distance(pmu_a, ps_a, pmu_b, ps_b))
    assert ref > 5.0
    assert out == pytest.approx(ref, **FAD)
    # equal Gaussians: clamped at 0, not a small negative number
    assert float(pm.frechet_distance(pmu_a, ps_a, pmu_a, ps_a)) >= 0.0


def test_frechet_audio_distance_matches_jax():
    ref_audio, cand = clips(2, 3, 0.3), clips(3, 3, 0.3)
    ref = jm.frechet_audio_distance(jnp.asarray(ref_audio), jnp.asarray(cand))
    out = pm.frechet_audio_distance(torch.from_numpy(ref_audio), torch.from_numpy(cand))
    assert isinstance(out, float) and out == pytest.approx(ref, **FAD)
    same = pm.frechet_audio_distance(torch.from_numpy(ref_audio),
                                     torch.from_numpy(ref_audio))
    assert 0.0 <= same < 1e-2 * out


def test_snr_and_spectral_convergence_match_jax():
    ref_audio = clips(4, 3, 0.1)
    est = ref_audio + 0.05 * rng(5).standard_normal(ref_audio.shape).astype(np.float32)
    for jfn, pfn in ((jm.signal_to_noise_ratio, pm.signal_to_noise_ratio),
                     (jm.spectral_convergence, pm.spectral_convergence)):
        ref = jfn(jnp.asarray(ref_audio), jnp.asarray(est))
        out = pfn(torch.from_numpy(ref_audio), torch.from_numpy(est))
        assert out.shape == (3,)
        assert_close(out, ref, rtol=1e-4, atol=1e-6)


def test_waveform_to_examples_and_resample_match_jax():
    audio = clips(6, 2, 2.1, sr=48_000)
    emb = jv.VGGishEmbedder.__new__(jv.VGGishEmbedder)
    emb.sample_rate = 48_000
    ref16 = emb._resample(jnp.asarray(audio))
    port = pv.VGGishEmbedder.__new__(pv.VGGishEmbedder)
    port.sample_rate = 48_000
    out16 = port._resample(torch.from_numpy(audio))
    assert out16.shape == ref16.shape == (2, 33_600, 2)
    assert_close(out16, ref16, rtol=1e-6, atol=1e-6)
    ref = jv.waveform_to_examples(ref16)
    out = pv.waveform_to_examples(out16)
    assert out.shape == ref.shape == (4, 96, 64)
    assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def vggish_pair():
    with pytest.warns(UserWarning, match="RANDOM"):
        jemb = jv.VGGishEmbedder(sample_rate=48_000, seed=3)
    with pytest.warns(UserWarning, match="RANDOM"):
        pemb = pv.VGGishEmbedder(sample_rate=48_000, seed=3, device="cpu")
    return jemb, pemb


def test_random_vggish_weights_equal_jax(vggish_pair):
    jemb, pemb = vggish_pair
    again = pv.load_vggish_tree(pv.VGGish(), jv.jax.tree.map(np.asarray, jemb.params))
    for (name, a), b in zip(pemb.model.named_parameters(), again.parameters()):
        assert torch.equal(a, b), name


def test_vggish_embedding_matches_jax(vggish_pair):
    """The embedder (resample, examples, network) on 2 s stereo clips: the
    network flattens its (6, 4, 512) map in JAX's (H, W, C) order."""
    jemb, pemb = vggish_pair
    audio = clips(7, 2, 2.0)
    ref = np.asarray(jemb(jnp.asarray(audio)))
    out = pemb(torch.from_numpy(audio))
    assert out.shape == ref.shape == (4, 128)
    assert_close(out, ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())


def test_vggish_fad_of_few_clips_matches_jax(vggish_pair):
    """Three 2 s clips per set: 6 embeddings in 128 dimensions, so both
    covariances are rank-deficient and of a random network's small scale
    (~1e-8). JAX's fp32 eigh converges there; the port's fp64 one must
    give the same distance (torch's fp32 CPU eigh fails or returns NaN).
    Bar rel 5e-3: at this rank the square roots amplify fp32 rounding, and
    JAX's and the port's distances differ from an fp64 evaluation of JAX's
    embeddings by 2.3e-3 and 1.1e-3 (measured on these clips)."""
    jemb, pemb = vggish_pair
    ref_audio, cand = clips(12, 3, 2.0), clips(13, 3, 2.0)
    ref = jm.frechet_audio_distance(jnp.asarray(ref_audio), jnp.asarray(cand), embed_fn=jemb)
    out = pm.frechet_audio_distance(torch.from_numpy(ref_audio), torch.from_numpy(cand),
                                    embed_fn=pemb)
    assert np.isfinite(ref) and ref > 0
    assert out == pytest.approx(ref, rel=5e-3, abs=0.0)


def test_convert_torch_vggish(tmp_path):
    """A torchvggish-layout state dict (NCHW convs, (out, in) Linears and
    the PCA buffers the port ignores) through a file into the module: the
    same embedding as JAX's convert_torch_vggish of it."""
    g = rng(8)
    sd, cin = {}, 1
    for i, cout in zip(pv._CONV_INDEX, pv._CONV_CHANNELS):
        sd[f"features.{i}.weight"] = torch.from_numpy(
            (g.standard_normal((cout, cin, 3, 3)) / np.sqrt(9 * cin)).astype(np.float32))
        sd[f"features.{i}.bias"] = torch.from_numpy((0.01 * g.standard_normal(cout)).astype(
            np.float32))
        cin = cout
    for i, (din, dout) in zip(pv._FC_INDEX, pv._FC_DIMS):
        sd[f"embeddings.{i}.weight"] = torch.from_numpy(
            (g.standard_normal((dout, din)) / np.sqrt(din)).astype(np.float32))
        sd[f"embeddings.{i}.bias"] = torch.zeros(dout)
    sd["pproc._pca_matrix"] = torch.eye(128)
    path = str(tmp_path / "vggish.pth")
    torch.save(sd, path)
    pemb = pv.VGGishEmbedder(path, sample_rate=16_000, device="cpu")
    for name, value in pemb.model.state_dict().items():
        assert torch.equal(value, sd[name]), name
    ex = jv.waveform_to_examples(jnp.asarray(clips(9, 1, 1.0, sr=16_000)))
    ref = np.asarray(jv.vggish_forward(jv.convert_torch_vggish(sd), ex))
    out = pemb.model(torch.from_numpy(np.asarray(ex)))
    assert_close(out, ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())


def write_dir(path, audio, sr):
    os.makedirs(path)
    for i, clip in enumerate(audio):
        write_wav(os.path.join(path, f"clip{i}.wav"), clip, sr)
    return str(path)


def test_run_eval_cli_matches_jax(tmp_path, capsys):
    """Two dirs of three 0.5 s 48 kHz stereo WAVs: the port's JSON line has
    JAX's keys and values (FAD at the FAD bar, paired metrics at 1e-4)."""
    ref_dir = write_dir(tmp_path / "ref", clips(10, 3, 0.5), 48_000)
    cand_dir = write_dir(tmp_path / "cand", clips(11, 3, 0.5), 48_000)
    args = ["--reference-dir", ref_dir, "--candidate-dir", cand_dir, "--max-seconds", "0.4"]
    assert jax_run_eval.main(args) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert run_eval.main(args + ["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == set(ref) == {"fad", "fad_embedder", "n_reference", "n_candidate",
                                    "snr_db_mean", "spectral_convergence_mean"}
    assert (out["fad_embedder"], out["n_reference"], out["n_candidate"]) == (
        ref["fad_embedder"], ref["n_reference"], ref["n_candidate"])
    assert out["fad"] == pytest.approx(ref["fad"], **FAD)
    for key in ("snr_db_mean", "spectral_convergence_mean"):
        assert out[key] == pytest.approx(ref[key], rel=1e-4, abs=1e-5)


def test_run_eval_against_reference_is_refused():
    with pytest.raises(NotImplementedError, match="fad_reference"):
        run_eval.main(["--against-reference"])
