"""Expected state_dict key layout of the public facebookresearch/encodec
release (port of jen1_tpu/codec/torch_keys.py, the same transcription),
written from the public module tree independently of
`convert_torch_encodec`:

  * encodec/modules/conv.py: SConv1d holds NormConv1d `conv`, which holds
    the raw nn.Conv1d `conv` (weight-normalized for the 24 kHz model:
    weight_g/weight_v; plain weight for 48 kHz) and `norm` (GroupNorm(1, C)
    for the 48 kHz model's norm='time_group_norm', Identity otherwise).
    SConvTranspose1d likewise: `convtr.convtr` + `convtr.norm`.
  * encodec/modules/seanet.py: SEANetEncoder.model is an nn.Sequential:
    idx 0 conv_in; per stage si: resblock at 1+3*si, ELU, downsample conv at
    3+3*si; SLSTM at 1+3*n; ELU; conv_out at 3+3*n. SEANetDecoder.model:
    idx 0 conv_in; SLSTM at 1; per stage: ELU, transposed conv at 3+3*si,
    resblock at 4+3*si; ELU; conv_out at 3+3*n. Resblocks (true_skip=False):
    block.1/block.3 convs + shortcut conv.
  * encodec/quantization/core_vq.py: EuclideanCodebook registers four
    buffers: inited, cluster_size, embed, embed_avg, at
    quantizer.vq.layers.{i}._codebook.*.

`convert_torch_encodec` holds a checkpoint's keys against this
layout, and `coverage_report` accounts for every key of a checkpoint.
"""

from __future__ import annotations

from typing import Iterable, Set, Tuple


def _norm_conv_keys(prefix: str, norm: str, transpose: bool = False) -> list:
    inner = "convtr" if transpose else "conv"
    keys = []
    if norm == "weight_norm":
        keys += [f"{prefix}.{inner}.weight_g", f"{prefix}.{inner}.weight_v"]
    else:
        keys += [f"{prefix}.{inner}.weight"]
    keys += [f"{prefix}.{inner}.bias"]
    if norm == "time_group_norm":
        keys += [f"{prefix}.norm.weight", f"{prefix}.norm.bias"]
    return keys


def _sconv_keys(path: str, norm: str) -> list:
    return _norm_conv_keys(f"{path}.conv", norm)


def _sconvtr_keys(path: str, norm: str) -> list:
    return _norm_conv_keys(f"{path}.convtr", norm, transpose=True)


def _resblock_keys(path: str, norm: str) -> list:
    # SEANetResnetBlock(true_skip=False): ELU, conv k=3 (block.1), ELU,
    # conv k=1 (block.3); shortcut conv k=1
    return (
        _sconv_keys(f"{path}.block.1", norm)
        + _sconv_keys(f"{path}.block.3", norm)
        + _sconv_keys(f"{path}.shortcut", norm)
    )


def _lstm_keys(path: str, num_layers: int = 2) -> list:
    keys = []
    for layer in range(num_layers):
        keys += [
            f"{path}.lstm.weight_ih_l{layer}",
            f"{path}.lstm.weight_hh_l{layer}",
            f"{path}.lstm.bias_ih_l{layer}",
            f"{path}.lstm.bias_hh_l{layer}",
        ]
    return keys


def expected_torch_keys(
    n_stages: int, n_q: int, norm: str = "time_group_norm"
) -> Tuple[Set[str], Set[str]]:
    """Return (parameter_keys, inference_irrelevant_buffer_keys) of the
    public EnCodec state_dict for a model with `n_stages` up/down stages and
    `n_q` RVQ layers. The 48 kHz release is n_stages=4 (ratios 8,5,4,2),
    n_q=16, norm='time_group_norm'."""
    n = n_stages
    keys: list = []
    # encoder.model: conv_in(0); per stage resblock(1+3si), down(3+3si);
    # lstm(1+3n); conv_out(3+3n)
    keys += _sconv_keys("encoder.model.0", norm)
    for si in range(n):
        keys += _resblock_keys(f"encoder.model.{1 + 3 * si}", norm)
        keys += _sconv_keys(f"encoder.model.{3 + 3 * si}", norm)
    keys += _lstm_keys(f"encoder.model.{1 + 3 * n}")
    keys += _sconv_keys(f"encoder.model.{3 + 3 * n}", norm)
    # decoder.model: conv_in(0); lstm(1); per stage up(3+3si),
    # resblock(4+3si); conv_out(3+3n)
    keys += _sconv_keys("decoder.model.0", norm)
    keys += _lstm_keys("decoder.model.1")
    for si in range(n):
        keys += _sconvtr_keys(f"decoder.model.{3 + 3 * si}", norm)
        keys += _resblock_keys(f"decoder.model.{4 + 3 * si}", norm)
    keys += _sconv_keys(f"decoder.model.{3 + 3 * n}", norm)
    # quantizer codebooks
    params = set(keys)
    buffers: Set[str] = set()
    for i in range(n_q):
        cb = f"quantizer.vq.layers.{i}._codebook"
        params.add(f"{cb}.embed")
        buffers |= {f"{cb}.inited", f"{cb}.cluster_size", f"{cb}.embed_avg"}
    return params, buffers


def coverage_report(
    state_dict_keys: Iterable[str], consumed: Set[str], n_stages: int, n_q: int
) -> dict:
    """Account for every key of a real checkpoint: consumed by the
    converter, ignorable EMA/statistics buffers, or UNEXPLAINED (a converter
    gap). Also reports keys the public layout predicts but the checkpoint
    lacks. Norm flavor is inferred from the keys present."""
    keys = set(state_dict_keys)
    norm = "weight_norm" if any(k.endswith("weight_g") for k in keys) else (
        "time_group_norm" if any(".norm.weight" in k for k in keys) else "none"
    )
    expected_params, expected_buffers = expected_torch_keys(n_stages, n_q, norm)
    return {
        "norm": norm,
        "n_keys": len(keys),
        "consumed": sorted(consumed & keys),
        "ignored_buffers": sorted(keys & expected_buffers),
        "unexplained": sorted(keys - consumed - expected_buffers),
        "missing_vs_public_layout": sorted(expected_params - keys),
        "unexpected_vs_public_layout": sorted(
            keys - expected_params - expected_buffers
        ),
    }
