"""Import EnCodec weights from the HuggingFace `transformers` layout (port
of jen1_tpu/codec/hf_import.py, the same remap; `transformers` itself is not
imported).

`transformers`' EncodecModel (facebook/encodec_24khz, facebook/encodec_32khz,
and the 48 kHz MusicGen variant) is an independent reimplementation of
facebookresearch/encodec whose checkpoints use another state_dict naming.
This module rewrites that layout into the facebookresearch one that
`convert_torch_encodec` reads, so `codec_weights_path` takes either
checkpoint family (`load_torch_encodec_state_dict` detects which).

Key correspondences:

  HF                                            facebookresearch
  ---------------------------------------------------------------------
  encoder.layers.N...                           encoder.model.N...
  <conv>.conv.weight                            <conv>.conv.conv.weight
  <conv>.conv.parametrizations.weight.original0 <conv>.conv.conv.weight_g
  <conv>.conv.parametrizations.weight.original1 <conv>.conv.conv.weight_v
  <conv>.conv.bias                              <conv>.conv.conv.bias
  <conv>.norm.{weight,bias}                     <conv>.conv.norm.{weight,bias}
  (decoder upsample convs use .convtr.convtr / .convtr.norm on the fb side)
  <lstm>.lstm.weight_ih_l0 ...                  <lstm>.lstm.weight_ih_l0 (1:1)
  quantizer.layers.i.codebook.X                 quantizer.vq.layers.i._codebook.X

HF keeps the fb nn.Sequential indices (ELU gaps included), so N maps 1:1.
Decoder transposed-conv indices are read off the key set itself: the
direct (non-resblock) decoder conv indices are conv_in, the upsamplers and
conv_out, in order.
"""

from __future__ import annotations

import re
from typing import Dict, Set


def is_hf_encodec_state_dict(state_dict) -> bool:
    # Gate on HF's layer-naming scheme ONLY ((encoder|decoder).layers. /
    # quantizer.layers.) — NOT on '.parametrizations.': a facebookresearch-
    # layout checkpoint re-saved under torch>=2.1 new-style weight_norm also
    # has parametrizations keys (under encoder.model.N...), and routing it
    # here would fail with a misleading 'unrecognized HF EnCodec key'. Those
    # keys are normalized fb-side in load_torch_encodec_state_dict.
    ks = state_dict.keys()
    return any(
        k.startswith("quantizer.layers.")
        or re.match(r"^(encoder|decoder)\.layers\.", k)
        for k in ks
    )


def _decoder_transpose_indices(keys) -> Set[int]:
    """Direct decoder conv layer indices, minus the first (conv_in) and
    last (conv_out) — everything between is an upsampling transposed conv."""
    direct = set()
    for k in keys:
        m = re.match(r"^decoder\.layers\.(\d+)\.(conv|norm)\.", k)
        if m:
            direct.add(int(m.group(1)))
    if len(direct) <= 2:
        return set()
    ordered = sorted(direct)
    return set(ordered[1:-1])


_CONV_SUFFIX = {
    "conv.parametrizations.weight.original0": ("conv", "weight_g"),
    "conv.parametrizations.weight.original1": ("conv", "weight_v"),
    "conv.weight": ("conv", "weight"),
    "conv.bias": ("conv", "bias"),
    "norm.weight": ("norm", "weight"),
    "norm.bias": ("norm", "bias"),
}


def hf_encodec_to_fb_state_dict(state_dict) -> Dict:
    """Rewrite a transformers EncodecModel state_dict into the
    facebookresearch/encodec layout. Values are passed through unchanged
    (torch tensors or arrays); unknown keys raise — a silent partial remap
    would produce a half-random codec."""
    tr_idx = _decoder_transpose_indices(state_dict.keys())
    out = {}
    for k, v in state_dict.items():
        m = re.match(r"^quantizer\.layers\.(\d+)\.codebook\.(\w+)$", k)
        if m:
            out[f"quantizer.vq.layers.{m.group(1)}._codebook.{m.group(2)}"] = v
            continue
        m = re.match(r"^(encoder|decoder)\.layers\.(\d+)\.(.*)$", k)
        if not m:
            raise KeyError(f"unrecognized HF EnCodec key: {k}")
        tower, idx, rest = m.group(1), int(m.group(2)), m.group(3)

        lm = re.match(r"^lstm\.(.+)$", rest)
        if lm:
            # fb SLSTM at index N holds nn.LSTM as `.lstm` — same depth as
            # HF's EncodecLSTM, so the key maps 1:1
            out[f"{tower}.model.{idx}.lstm.{lm.group(1)}"] = v
            continue

        # rest = "<inner path><conv-or-norm suffix>", inner path possibly
        # "block.1." / "shortcut." within a resblock (never transposed)
        for suffix, (kind, leaf) in _CONV_SUFFIX.items():
            if rest == suffix or rest.endswith("." + suffix):
                inner = rest[: -len(suffix)].rstrip(".")
                transposed = tower == "decoder" and idx in tr_idx and not inner
                mod = "convtr" if transposed else "conv"
                sub = mod if kind == "conv" else "norm"
                path = f"{tower}.model.{idx}"
                if inner:
                    path += f".{inner}"
                out[f"{path}.{mod}.{sub}.{leaf}"] = v
                break
        else:
            raise KeyError(f"unrecognized HF EnCodec key: {k}")
    return out
