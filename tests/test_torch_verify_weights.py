"""The port's weight verification (jen1_tpu_torch/ckpt/verify_weights.py):
the cases of tests/test_weights_verify.py and
tests/test_verify_weights_families.py on weight files written from random
tiny models (the EnCodec torch mock, an HF-layout T5 state dict, a
reference-layout UNet .pth), on the CPU; the codec and T5 reports equal
jen1_tpu's on the same files (SNR to 0.05 dB, the T5 output rms to 1e-3).
"""

import dataclasses
import json
import wave

import numpy as np
import pytest
import torch

from jen1_tpu_torch.ckpt import verify_weights as vw
from jen1_tpu_torch.codec.model import (
    EncodecConfig, _RecordingDict, convert_torch_encodec,
)
from jen1_tpu_torch.codec.torch_keys import coverage_report, expected_torch_keys
from encodec_torch_mock import MockEncodec
from torch_port_util import hf_t5_state_dict, one_torch_thread, random_params, unet_shapes

CPU = dict(device="cpu")


def tiny_48k_style():
    cfg = EncodecConfig(sample_rate=1600, channels=2, dimension=8, n_filters=2,
                        ratios=(5, 4, 2), n_q=4, bins=16, causal=False,
                        norm="time_group_norm", normalize=True, segment=1.0, overlap=0.01)
    torch.manual_seed(0)
    mock = MockEncodec(sample_rate=cfg.sample_rate, channels=cfg.channels,
                       dimension=cfg.dimension, n_filters=cfg.n_filters, ratios=cfg.ratios,
                       n_q=cfg.n_q, bins=cfg.bins, norm=cfg.norm, causal=cfg.causal,
                       normalize=cfg.normalize, segment=cfg.segment,
                       overlap=cfg.overlap).eval()
    return cfg, mock


class TestPublicKeyLayout:
    def test_expected_keys_match_mock_time_group_norm(self):
        cfg, mock = tiny_48k_style()
        params, buffers = expected_torch_keys(n_stages=len(cfg.ratios), n_q=cfg.n_q,
                                              norm="time_group_norm")
        assert set(mock.state_dict().keys()) == params | buffers

    def test_expected_keys_match_mock_weight_norm(self):
        torch.manual_seed(1)
        mock = MockEncodec(sample_rate=1600, channels=1, dimension=8, n_filters=2,
                           ratios=(4, 2), n_q=2, bins=16, norm="weight_norm", causal=True,
                           normalize=False, segment=None).eval()
        params, buffers = expected_torch_keys(n_stages=2, n_q=2, norm="weight_norm")
        assert set(mock.state_dict().keys()) == params | buffers

    def test_converter_consumes_every_param_key(self):
        cfg, mock = tiny_48k_style()
        rec = _RecordingDict(mock.state_dict())
        convert_torch_encodec(rec, cfg)
        cov = coverage_report(rec.keys(), rec.consumed, n_stages=len(cfg.ratios), n_q=cfg.n_q)
        assert cov["unexplained"] == []
        assert cov["missing_vs_public_layout"] == []
        assert cov["unexpected_vs_public_layout"] == []
        assert len(cov["ignored_buffers"]) == 3 * cfg.n_q

    def test_strict_conversion_raises_on_unconsumed_key(self):
        cfg, mock = tiny_48k_style()
        sd = dict(mock.state_dict())
        sd["encoder.model.99.conv.conv.weight"] = torch.zeros(1)
        with pytest.raises(ValueError, match="unread"):
            convert_torch_encodec(sd, cfg)
        convert_torch_encodec(sd, cfg, strict=False)  # forced through

    def test_missing_key_raises(self):
        cfg, mock = tiny_48k_style()
        sd = dict(mock.state_dict())
        del sd["decoder.model.0.conv.conv.weight"]
        with pytest.raises(KeyError):
            convert_torch_encodec(sd, cfg)


@pytest.fixture(scope="module")
def codec_path(tmp_path_factory):
    cfg, mock = tiny_48k_style()
    path = tmp_path_factory.mktemp("w") / "encodec_tiny.pth"
    torch.save(mock.state_dict(), str(path))
    return cfg, str(path)


class TestVerifyCodec:
    def test_verify_codec_report(self, codec_path):
        """The mock's weights are random: the SNR gate is off, the
        structural gates pass and a finite SNR is reported."""
        cfg, path = codec_path
        with one_torch_thread():
            report = vw.verify_codec(path, min_snr_db=-1e9, sweep_seconds=0.5, config=cfg,
                                     **CPU)
        assert report["checks"]["key_coverage"] is True
        assert report["checks"]["param_coverage"] is True
        assert report["param_coverage"]["uninitialized"] == []
        assert report["param_coverage"]["shape_mismatch"] == []
        assert np.isfinite(report["round_trip"]["snr_db"])
        assert report["ok"] is True

    def test_verify_codec_snr_gate_fails_random_weights(self, codec_path):
        cfg, path = codec_path
        with one_torch_thread():
            report = vw.verify_codec(path, min_snr_db=3.0, sweep_seconds=0.5, config=cfg, **CPU)
        assert report["checks"]["snr"] is False
        assert report["ok"] is False

    def test_verify_codec_reports_unread_and_missing_keys(self, codec_path, tmp_path):
        cfg, path = codec_path
        sd = torch.load(path)
        sd["encoder.model.99.conv.conv.weight"] = torch.zeros(1)
        del sd["quantizer.vq.layers.0._codebook.inited"]
        bad = tmp_path / "extra.pth"
        torch.save(sd, str(bad))
        with one_torch_thread():
            report = vw.verify_codec(str(bad), min_snr_db=-1e9, sweep_seconds=0.5, config=cfg,
                                     **CPU)
        assert report["key_coverage"]["unexplained"] == ["encoder.model.99.conv.conv.weight"]
        assert report["checks"]["key_coverage"] is False and report["ok"] is False

    def test_codec_report_equals_jax(self, codec_path):
        from jen1_tpu.ckpt.verify_weights import verify_codec as jax_verify_codec
        from jen1_tpu.codec.model import EncodecConfig as JCodecConfig

        cfg, path = codec_path
        with one_torch_thread():
            port = vw.verify_codec(path, min_snr_db=-1e9, sweep_seconds=0.5, config=cfg, **CPU)
        ref = jax_verify_codec(path, min_snr_db=-1e9, sweep_seconds=0.5,
                               config=JCodecConfig(**dataclasses.asdict(cfg)))
        assert port["key_coverage"] == ref["key_coverage"]
        assert port["checks"] == ref["checks"]
        assert abs(port["round_trip"]["snr_db"] - ref["round_trip"]["snr_db"]) <= 0.05

    def test_verify_codec_accepts_hf_layout_checkpoint(self, tmp_path):
        transformers = pytest.importorskip("transformers")
        hf_cfg = transformers.EncodecConfig(
            sampling_rate=1600, audio_channels=2, hidden_size=8, num_filters=2,
            num_residual_layers=1, upsampling_ratios=[5, 4, 2], codebook_size=16,
            codebook_dim=8, target_bandwidths=[0.5], normalize=True, chunk_length_s=1.0,
            overlap=0.01, norm_type="time_group_norm", use_causal_conv=False,
        )
        torch.manual_seed(0)
        hf = transformers.EncodecModel(hf_cfg)
        path = tmp_path / "encodec_hf_tiny.pth"
        torch.save(hf.state_dict(), str(path))
        cfg = EncodecConfig(sample_rate=1600, channels=2, dimension=8, n_filters=2,
                            ratios=(5, 4, 2),
                            n_q=int(hf.quantizer.get_num_quantizers_for_bandwidth(0.5)),
                            bins=16, causal=False, norm="time_group_norm")
        with one_torch_thread():
            report = vw.verify_codec(str(path), min_snr_db=-1e9, sweep_seconds=0.5, config=cfg,
                                     **CPU)
        assert report["checks"]["key_coverage"] is True
        assert report["checks"]["param_coverage"] is True
        assert report["ok"] is True

    def test_cli_main_json_output(self, codec_path, tmp_path, monkeypatch):
        cfg, path = codec_path
        out = tmp_path / "report.json"
        real = vw.verify_codec
        monkeypatch.setattr(vw, "verify_codec", lambda p, **kw: real(p, config=cfg, **kw))
        with one_torch_thread():
            rc = vw.main(["--codec-weights", path, "--min-snr-db=-1e9", "--sweep-seconds",
                          "0.5", "--json", str(out), "--device", "cpu"])
        assert rc == 0
        assert json.loads(out.read_text())["ok"] is True


def tiny_hf_t5_state_dict(d_model=16, layers=2, d_ff=32, heads=2, d_kv=8, vocab=50,
                          buckets=8):
    """tests/test_verify_weights_families.py's synthetic HF T5 state dict."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return 0.05 * torch.randn(*shape, generator=g)

    sd = {"shared.weight": r(vocab, d_model)}
    for i in range(layers):
        pre = f"encoder.block.{i}.layer"
        inner = heads * d_kv
        for n in ("q", "k", "v"):
            sd[f"{pre}.0.SelfAttention.{n}.weight"] = r(inner, d_model)
        sd[f"{pre}.0.SelfAttention.o.weight"] = r(d_model, inner)
        if i == 0:
            sd[f"{pre}.0.SelfAttention.relative_attention_bias.weight"] = r(buckets, heads)
        sd[f"{pre}.0.layer_norm.weight"] = torch.ones(d_model)
        sd[f"{pre}.1.DenseReluDense.wi_0.weight"] = r(d_ff, d_model)
        sd[f"{pre}.1.DenseReluDense.wi_1.weight"] = r(d_ff, d_model)
        sd[f"{pre}.1.DenseReluDense.wo.weight"] = r(d_model, d_ff)
        sd[f"{pre}.1.layer_norm.weight"] = torch.ones(d_model)
    sd["encoder.final_layer_norm.weight"] = torch.ones(d_model)
    return sd


@pytest.fixture
def t5_path(tmp_path):
    path = tmp_path / "t5_tiny.pt"
    torch.save(tiny_hf_t5_state_dict(), path)
    return str(path)


class TestT5Family:
    def test_infer_config(self):
        cfg = vw.infer_t5_config(tiny_hf_t5_state_dict())
        assert (cfg.d_model, cfg.num_layers, cfg.d_ff, cfg.num_heads, cfg.d_kv,
                cfg.vocab_size, cfg.relative_attention_num_buckets) == (16, 2, 32, 2, 8, 50, 8)
        assert cfg.feed_forward_proj == "gated-gelu"

    def test_verify_t5_ok(self, t5_path):
        report = vw.verify_t5(t5_path, **CPU)
        assert report["ok"], report
        assert report["param_coverage"]["uninitialized"] == []
        assert report["checks"]["mask_invariance"]

    def test_verify_t5_catches_missing_layer(self, tmp_path):
        sd = tiny_hf_t5_state_dict()
        del sd["encoder.block.1.layer.1.DenseReluDense.wo.weight"]
        path = tmp_path / "t5_broken.pt"
        torch.save(sd, path)
        with pytest.raises(KeyError):
            vw.verify_t5(str(path), **CPU)

    def test_t5_report_equals_jax(self, t5_path):
        from jen1_tpu.ckpt.verify_weights import verify_t5 as jax_verify_t5

        port, ref = vw.verify_t5(t5_path, **CPU), jax_verify_t5(t5_path)
        assert port["inferred_config"] == ref["inferred_config"]
        assert port["checks"] == ref["checks"]
        assert port["forward"]["emb_rms"] == pytest.approx(ref["forward"]["emb_rms"], rel=1e-3)


def reference_pth(tmp_path, mc):
    """A reference-layout .pth of random weights for `mc` (tied transformer
    projections), written by the port's exporter."""
    from jen1_tpu.models.unet import unet_from_model_config as jax_unet
    from jen1_tpu_torch.ckpt.torch_export import save_reference_checkpoint

    params = random_params(unet_shapes(jax_unet(mc), mc), seed=8)
    path = tmp_path / "jen1_tiny.pth"
    save_reference_checkpoint(str(path), params, mc, epoch=3, learning_rate=1e-4)
    return str(path)


def tiny_configs(**model_kw):
    from jen1_tpu.config import tiny_test_config as jax_tiny
    from jen1_tpu_torch.config import tiny_test_config

    kw = dict(tie_transformer_projections=True, **model_kw)
    jcfg, pcfg = jax_tiny(), tiny_test_config()
    jcfg.model_config = dataclasses.replace(jcfg.model_config, **kw)
    pcfg.model_config = dataclasses.replace(pcfg.model_config, **kw)
    return jcfg, pcfg


class TestJen1Family:
    def test_verify_jen1_roundtrip(self, tmp_path):
        jcfg, pcfg = tiny_configs()
        report = vw.verify_jen1(reference_pth(tmp_path, jcfg.model_config), config=pcfg, **CPU)
        assert report["ok"], report
        assert report["epoch"] == 3
        assert report["param_coverage"]["uninitialized"] == []
        assert report["forward"]["finite"]

    def test_verify_jen1_reports_a_wrong_config(self, tmp_path):
        """The same file against a config with more channels: every
        mismatched shape is reported and the check fails, no forward runs."""
        jcfg, _ = tiny_configs()
        _, wide = tiny_configs(channels=32)
        report = vw.verify_jen1(reference_pth(tmp_path, jcfg.model_config), config=wide, **CPU)
        assert report["ok"] is False and report["param_coverage"]["shape_mismatch"]
        assert "forward" not in report


class TestCLI:
    def test_cli_t5_only(self, t5_path, capsys):
        assert vw.main(["--t5-weights", t5_path, "--device", "cpu"]) == 0
        assert '"ok": true' in capsys.readouterr().out

    def test_cli_requires_some_family(self):
        with pytest.raises(SystemExit):
            vw.main([])

    def test_cli_generate_needs_all_three(self, t5_path):
        with pytest.raises(SystemExit):
            vw.main(["--t5-weights", t5_path, "--generate-secs", "2", "--device", "cpu"])

    def test_generate_clip_from_three_files(self, tmp_path):
        """All three families from files (the EnCodec-48k mock, an HF T5 of
        the tiny geometry, a reference .pth of a tiny UNet with the codec's
        128 latent channels): a finite clip, written as WAV."""
        from jen1_tpu_torch.conditioning.t5 import T5EncoderConfig

        jcfg, pcfg = tiny_configs(in_channels=128, out_channels=128, context_channels=(129,))
        jen1_path = reference_pth(tmp_path, jcfg.model_config)
        torch.manual_seed(0)
        codec_file = tmp_path / "encodec_48k.pth"
        torch.save(MockEncodec().state_dict(), codec_file)
        t5_file = tmp_path / "t5.pt"
        torch.save(hf_t5_state_dict(0, dataclasses.replace(T5EncoderConfig.tiny_test(),
                                                           vocab_size=259), "shared.weight"),
                   t5_file)
        t5c = pcfg.conditioner_config.t5_config
        t5c.t5_model_name = "tiny-test"
        t5c.max_length = pcfg.model_config.context_embedding_max_length
        out_wav = tmp_path / "demo.wav"
        with one_torch_thread():
            report = vw.generate_clip(str(codec_file), str(t5_file), jen1_path, 1.0,
                                      str(out_wav), config=pcfg, **CPU)
        assert report["finite"] and report["ok"], report
        # a reference .pth turns on the segmented latent pipeline: 1 s with
        # its 1 % overlap decodes to 152 latent frames of 320 samples
        with wave.open(str(out_wav)) as w:
            assert (w.getnchannels(), w.getframerate(), w.getnframes()) == (2, 48_000, 152 * 320)
