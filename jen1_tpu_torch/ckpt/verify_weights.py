"""Offline checks that weight files load into the port's models (port of
jen1_tpu/ckpt/verify_weights.py).

    python -m jen1_tpu_torch.ckpt.verify_weights --codec-weights encodec_48khz.th
    python -m jen1_tpu_torch.ckpt.verify_weights --codec-weights ... \\
        --t5-weights hf_t5.pt --jen1-weights jen1.pth --generate-secs 10 --out-wav demo.wav

Codec (an EnCodec-48k torch state dict, facebookresearch or HF layout):
  1. key coverage: every key of the file is read by `convert_torch_encodec`
     or is a codebook buffer inference ignores, and the key set equals the
     public layout (`codec/torch_keys.py`);
  2. parameter coverage: the converted tree fills every parameter of the
     port's `EncodecModel`, at its shape, and nothing else;
  3. round trip: a logarithmic 20 Hz - 20 kHz sine sweep is encoded and
     decoded; its SNR must reach --min-snr-db (a real EnCodec-48k lands
     above 0 dB, a random or scrambled codec far below).
T5 (an HF T5EncoderModel state dict): the geometry is read from the state
dict, the converted weights must fill every parameter of the port's
`T5Encoder`, a forward must be finite, and tokens behind the padding mask
must not change the unmasked outputs.
JEN-1 UNet (a reference .pth): `ckpt/torch_import.py`'s conversion must
fill every parameter of the port's UNetCFG1d for the config, and a CFG
forward must be finite.
With all three files and --generate-secs, a clip is generated end to end.
The report is printed (and written with --json) as JSON; the exit code is
0 when every check passed, else 1. The models run on --device ("cuda" by
default).
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from typing import Dict, Mapping, Optional

import numpy as np
import torch


def sine_sweep(seconds: float = 3.0, sr: int = 48_000, f0: float = 20.0,
               f1: float = 20_000.0, channels: int = 2) -> np.ndarray:
    """(T, channels) float32 logarithmic sweep at -6 dBFS."""
    f1 = min(f1, 0.45 * sr)  # below Nyquist at small test rates
    t = np.arange(int(seconds * sr)) / sr
    k = np.log(f1 / f0) / seconds
    phase = 2 * np.pi * f0 * (np.exp(k * t) - 1) / k
    mono = 0.5 * np.sin(phase).astype(np.float32)
    return np.repeat(mono[:, None], channels, axis=1)


def _coverage(want: Dict[str, tuple], got: Dict[str, tuple]) -> dict:
    return {
        "n_params": len(want),
        "uninitialized": sorted(set(want) - set(got)),
        "extraneous": sorted(set(got) - set(want)),
        "shape_mismatch": sorted(p for p in set(want) & set(got) if want[p] != got[p]),
    }


def _coverage_ok(pc: dict) -> bool:
    return not (pc["uninitialized"] or pc["extraneous"] or pc["shape_mismatch"])


def _tree_shapes(module: torch.nn.Module, tree: Mapping) -> Dict[str, tuple]:
    """{torch parameter name: shape in torch layout} of the leaves of a
    JAX-layout parameter tree, as `ckpt/from_jax.py` would load them into
    `module`; a leaf with no submodule keeps its tree path."""
    from jen1_tpu_torch.ckpt.from_jax import _target, flatten

    out = {}
    for path, arr in flatten(tree).items():
        mod_path, leaf = path.rsplit(".", 1) if "." in path else ("", path)
        try:
            sub = module.get_submodule(mod_path)
        except AttributeError:
            out[path] = arr.shape
            continue
        name, value = _target(sub, leaf, arr)
        out[f"{mod_path}.{name}" if mod_path else name] = value.shape
    return out


def flax_tree_coverage(module: torch.nn.Module, tree: Mapping, prefix: str = "") -> dict:
    """Which parameters of `module` a JAX-layout tree would fill, without
    loading it: those it leaves unset, leaves with no parameter, and shape
    mismatches (in torch layout)."""
    return _coverage({prefix + n: tuple(p.shape) for n, p in module.named_parameters()},
                     {prefix + n: s for n, s in _tree_shapes(module, tree).items()})


def verify_codec(weights_path: str, min_snr_db: float = 0.0, sweep_seconds: float = 3.0,
                 config=None, device="cuda") -> dict:
    """The three codec checks; a JSON-able report with an 'ok' bool.
    `config` defaults to the 48 kHz release config."""
    from jen1_tpu_torch.ckpt.from_jax import load_encodec
    from jen1_tpu_torch.codec.model import (
        EncodecModel, _RecordingDict, convert_torch_encodec, encodec_48khz_config,
        load_torch_encodec_state_dict,
    )
    from jen1_tpu_torch.codec.torch_keys import coverage_report

    config = config or encodec_48khz_config()
    rec = _RecordingDict(load_torch_encodec_state_dict(weights_path))
    params = convert_torch_encodec(rec, config, strict=False)
    report: dict = {"weights_path": weights_path}

    cov = coverage_report(rec.keys(), rec.consumed, n_stages=len(config.ratios), n_q=config.n_q)
    report["key_coverage"] = {
        "n_keys": cov["n_keys"],
        "n_consumed": len(cov["consumed"]),
        "n_ignored_buffers": len(cov["ignored_buffers"]),
        "unexplained": cov["unexplained"],
        "missing_vs_public_layout": cov["missing_vs_public_layout"],
        "unexpected_vs_public_layout": cov["unexpected_vs_public_layout"],
        "norm": cov["norm"],
    }
    keys_ok = not cov["unexplained"] and not cov["missing_vs_public_layout"]

    model = EncodecModel(config, device=device)
    parts = [flax_tree_coverage(model.encoder, params["encoder"], "encoder."),
             flax_tree_coverage(model.decoder, params["decoder"], "decoder."),
             _coverage({"codebooks": tuple(model.codebooks.shape)},
                       {"codebooks": tuple(np.shape(params["codebooks"]))})]
    pc = {"n_params": sum(c["n_params"] for c in parts)}
    for key in ("uninitialized", "extraneous", "shape_mismatch"):
        pc[key] = sorted(k for c in parts for k in c[key])
    report["param_coverage"] = pc
    params_ok = _coverage_ok(pc)

    snr_db = float("-inf")
    if params_ok:
        load_encodec(model, params)
        audio = sine_sweep(sweep_seconds, config.sample_rate, channels=config.channels)[None]
        with torch.no_grad():
            latent = model.eval().encode_latent(torch.from_numpy(audio).to(device))
            decoded = model.decode_latent_chunked(latent).float().cpu().numpy()
        n = min(decoded.shape[1], audio.shape[1])
        err = decoded[:, :n] - audio[:, :n]
        snr_db = float(10 * np.log10((audio[:, :n] ** 2).mean() / max((err ** 2).mean(), 1e-12)))
    report["round_trip"] = {"sweep_seconds": sweep_seconds, "snr_db": round(snr_db, 2),
                            "min_snr_db": min_snr_db}
    snr_ok = snr_db >= min_snr_db
    report["checks"] = {"key_coverage": keys_ok, "param_coverage": params_ok, "snr": snr_ok}
    report["ok"] = keys_ok and params_ok and snr_ok
    return report


def infer_t5_config(sd: dict):
    """The T5 encoder's geometry from an HF T5EncoderModel state dict."""
    from jen1_tpu_torch.conditioning.t5 import T5EncoderConfig

    emb = sd.get("shared.weight", sd.get("encoder.embed_tokens.weight"))
    if emb is None:
        raise KeyError("no shared.weight/encoder.embed_tokens.weight")
    vocab, d_model = tuple(emb.shape)
    layers = 1 + max(int(m.group(1)) for k in sd
                     if (m := re.match(r"encoder\.block\.(\d+)\.", k)))
    gated = "encoder.block.0.layer.1.DenseReluDense.wi_0.weight" in sd
    ff_key = ("encoder.block.0.layer.1.DenseReluDense.wi_0.weight" if gated
              else "encoder.block.0.layer.1.DenseReluDense.wi.weight")
    inner = int(sd["encoder.block.0.layer.0.SelfAttention.q.weight"].shape[0])
    buckets, heads = (int(n) for n in
                      sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]
                      .shape)
    return T5EncoderConfig(
        vocab_size=int(vocab), d_model=int(d_model), d_kv=inner // heads, num_heads=heads,
        d_ff=int(sd[ff_key].shape[0]), num_layers=layers,
        relative_attention_num_buckets=buckets,
        feed_forward_proj="gated-gelu" if gated else "relu",
    )


def verify_t5(weights_path: str, device="cuda") -> dict:
    from jen1_tpu_torch.ckpt.checkpoint import load_torch_file
    from jen1_tpu_torch.conditioning.t5 import T5Encoder, convert_hf_t5_encoder

    sd = load_torch_file(weights_path, unwrap=True)
    cfg = infer_t5_config(sd)
    weights = convert_hf_t5_encoder(sd, cfg)
    report: dict = {
        "weights_path": weights_path,
        "inferred_config": {
            "d_model": cfg.d_model, "num_layers": cfg.num_layers, "d_ff": cfg.d_ff,
            "num_heads": cfg.num_heads, "vocab_size": cfg.vocab_size,
            "feed_forward_proj": cfg.feed_forward_proj,
        },
    }
    with torch.device(device):
        model = T5Encoder(cfg).eval()
    pc = _coverage({n: tuple(p.shape) for n, p in model.named_parameters()},
                   {n: tuple(w.shape) for n, w in weights.items()})
    report["param_coverage"] = pc
    params_ok = _coverage_ok(pc)
    finite_ok = mask_ok = False
    if params_ok:
        model.load_state_dict(weights)
        ids = torch.from_numpy(
            np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))).to(device)
        mask = torch.tensor([[True] * 12, [True] * 7 + [False] * 5], device=device)
        with torch.no_grad():
            out = model(ids, mask).float().cpu().numpy()
            # tokens behind the mask must not reach the unmasked outputs
            ids2 = ids.clone()
            ids2[1, 7:] = (ids2[1, 7:] + 1) % cfg.vocab_size
            out2 = model(ids2, mask).float().cpu().numpy()
        mask_ok = bool(np.array_equal(out[1, :7], out2[1, :7]))
        finite_ok = bool(np.isfinite(out).all())
        report["forward"] = {"finite": finite_ok, "mask_invariance": mask_ok,
                             "emb_rms": round(float(np.sqrt((out ** 2).mean())), 4)}
    report["checks"] = {"param_coverage": params_ok, "finite": finite_ok,
                        "mask_invariance": mask_ok}
    report["ok"] = params_ok and finite_ok and mask_ok
    return report


def verify_jen1(weights_path: str, config=None, device="cuda") -> dict:
    from jen1_tpu_torch.ckpt.checkpoint import load_torch_file, unwrap_state_dict
    from jen1_tpu_torch.ckpt.from_jax import load_flax_params
    from jen1_tpu_torch.ckpt.torch_import import convert_reference_unet
    from jen1_tpu_torch.config import Config
    from jen1_tpu_torch.models.unet import unet_from_model_config

    mc = (config or Config()).model_config
    obj = load_torch_file(weights_path)
    tree = convert_reference_unet(unwrap_state_dict(obj), mc)
    report: dict = {"weights_path": weights_path, "epoch": obj.get("epoch")}
    with torch.device(device):
        model = unet_from_model_config(mc).eval()
    pc = flax_tree_coverage(model, tree)
    report["param_coverage"] = pc
    params_ok = _coverage_ok(pc)
    finite_ok = False
    if params_ok:
        load_flax_params(model, tree)
        b, length, m = 1, 48, mc.context_embedding_max_length
        with torch.device(device), torch.no_grad():
            out = model(
                torch.zeros(b, length, mc.in_channels), torch.zeros(b),
                embedding=torch.zeros(b, m, mc.context_embedding_features),
                embedding_mask=torch.ones(b, m, dtype=torch.bool),
                channels_list=[torch.zeros(b, length, mc.in_channels + 1)],
                embedding_scale=0.8, batch_cfg=True, scale_cfg=True,
            ).float().cpu().numpy()
        finite_ok = bool(np.isfinite(out).all())
        report["forward"] = {"finite": finite_ok, "shape": list(out.shape)}
    report["checks"] = {"param_coverage": params_ok, "finite": finite_ok}
    report["ok"] = params_ok and finite_ok
    return report


def generate_clip(codec_path, t5_path, jen1_path, seconds, out_wav, config=None,
                  device="cuda") -> dict:
    """With all three families verified: one clip, end to end."""
    from jen1_tpu_torch.api.generation import Jen1
    from jen1_tpu_torch.codec.model import encodec_48khz_config, make_codec
    from jen1_tpu_torch.config import Config
    from jen1_tpu_torch.data.audio_io import write_wav

    ccfg = encodec_48khz_config()
    cfg = config or Config()
    cfg.conditioner_config.t5_config.weights_path = t5_path
    jen = Jen1(jen1_path, config=cfg, codec=make_codec(codec_path, ccfg, device=device),
               sample_rate=ccfg.sample_rate, device=device)
    audio = jen.generate("warm synth pads over a mellow beat", seconds=float(seconds), seed=0,
                         steps=100)
    finite = bool(np.isfinite(audio).all())
    rms = float(np.sqrt((audio.astype(np.float64) ** 2).mean()))
    if out_wav:
        write_wav(out_wav, audio[0].T, ccfg.sample_rate)
    return {"seconds": seconds, "rms": round(rms, 5), "finite": finite, "out_wav": out_wav,
            "ok": finite and rms > 1e-5}


def main(argv: Optional[list] = None) -> int:
    from jen1_tpu_torch.api.generation import resolve_device

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--codec-weights", default=None,
                   help="pretrained EnCodec-48k torch state dict (.pt/.th)")
    p.add_argument("--t5-weights", default=None,
                   help="HF T5EncoderModel torch state dict (.pt/.bin)")
    p.add_argument("--jen1-weights", default=None,
                   help="reference JEN-1 UNet .pth (script_util.py layout)")
    p.add_argument("--min-snr-db", type=float, default=0.0,
                   help="fail if the codec round-trip SNR is below this (random weights "
                        "land far below 0 dB)")
    p.add_argument("--sweep-seconds", type=float, default=3.0)
    p.add_argument("--generate-secs", type=float, default=0.0,
                   help="with all three families given: generate a clip of this length "
                        "end to end as the final check")
    p.add_argument("--out-wav", default=None,
                   help="write the generated clip here (with --generate-secs)")
    p.add_argument("--json", default=None, help="also write the report here")
    p.add_argument("--device", default="cuda", help="torch device of the models")
    args = p.parse_args(argv)
    if not (args.codec_weights or args.t5_weights or args.jen1_weights):
        p.error("give at least one of --codec-weights/--t5-weights/--jen1-weights")
    if args.generate_secs > 0 and not (args.codec_weights and args.t5_weights
                                       and args.jen1_weights):
        p.error("--generate-secs needs all three weight families")
    device = resolve_device(args.device)

    report: dict = {}
    if args.codec_weights:
        report["codec"] = verify_codec(args.codec_weights, min_snr_db=args.min_snr_db,
                                       sweep_seconds=args.sweep_seconds, device=device)
    if args.t5_weights:
        report["t5"] = verify_t5(args.t5_weights, device=device)
    if args.jen1_weights:
        report["jen1"] = verify_jen1(args.jen1_weights, device=device)
    ok = all(r["ok"] for r in report.values())
    if args.generate_secs > 0:
        if ok:
            report["generate"] = generate_clip(args.codec_weights, args.t5_weights,
                                               args.jen1_weights, args.generate_secs,
                                               args.out_wav, device=device)
            ok = ok and report["generate"]["ok"]
        else:
            report["generate"] = {"skipped": "family checks failed"}
    report["ok"] = ok
    text = json.dumps(report, indent=2)
    print(text)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
