"""Staged compute weights (jen1_tpu_torch/ops/staging.py) on the CPU.

A staged copy holds the values the cast at the call makes, in the same
layout, so a staged forward equals the per-call one bit for bit
(`torch.equal`): the UNet (batch CFG, and a causal forward) and the DiT at
bf16 compute. A weight written in place, rebound by a bf16 cast or merged
with a LoRA adapter between two requests reaches the second request, which
equals a fresh model's. The routes that must cast at the call do: a
gradient, an int8 kernel, a DTensor weight, sequence parallelism. The
copies stay out of `state_dict()`, and `weights_key` follows their
addresses.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch
from torch import nn

from jen1_tpu_torch.api.generation import Jen1, cast_weights_bf16, unet_at_dtype, weights_key
from jen1_tpu_torch.config import tiny_stable_audio_test_config, tiny_test_config
from jen1_tpu_torch.models.dit import DiffusionTransformer
from jen1_tpu_torch.models.unet import unet_from_model_config
from jen1_tpu_torch.ops import staging
from jen1_tpu_torch.ops.conv import OmniConv1d
from jen1_tpu_torch.ops.initializers import init_module
from jen1_tpu_torch.ops.linear import Linear
from jen1_tpu_torch.parallel import sp as seq

BF16 = torch.bfloat16


@pytest.fixture
def counters(monkeypatch):
    """The staging counters, zeroed for the test."""
    for name in staging.COUNTERS:
        monkeypatch.setattr(staging, name, 0)

    def read():
        return {name: getattr(staging, name) for name in staging.COUNTERS}

    return read


def reads(model: nn.Module) -> int:
    """Weights one forward reads through compute_weights: each module runs
    once a forward in these models."""
    return sum(module._parameters.get(name) is not None
               for module in model.modules() if hasattr(module, "staged_reads")
               for name, _ in module.staged_reads)


def built(kind: str, seed: int = 0) -> nn.Module:
    if kind == "dit":
        model = DiffusionTransformer(tiny_stable_audio_test_config().dit_config)
    else:
        model = unet_from_model_config(tiny_test_config().model_config)
    init_module(model, torch.Generator().manual_seed(seed))
    return model.eval()


def forward(kind: str, model: nn.Module) -> torch.Tensor:
    """One guided forward at bf16 compute, fp32 out, as the samplers call
    it."""
    g = torch.Generator().manual_seed(1)
    if kind == "dit":
        kw = dict(embedding=torch.randn(2, 12, 128, generator=g),
                  features=torch.randn(2, 256, generator=g), embedding_scale=7.0,
                  batch_cfg=True)
        x = torch.randn(2, 40, 8, generator=g)
    else:
        x = torch.randn(2, 48, 8, generator=g)
        kw = dict(embedding=torch.randn(2, 6, 16, generator=g),
                  channels_list=[torch.randn(2, 48, 9, generator=g)], embedding_scale=1.5,
                  batch_cfg=True, causal=kind == "unet-causal")
    return unet_at_dtype(model, BF16, x, torch.rand(2, generator=g), **kw)


@pytest.mark.parametrize("kind", ["unet-cfg", "unet-causal", "dit"])
def test_staged_forward_equals_per_call(kind, counters):
    model = built(kind)
    with torch.no_grad():
        per_call = forward(kind, model)
        before = counters()
        staging.stage(model, BF16)
        staged_counts = counters()
        staged = forward(kind, model)
    after = counters()
    n = reads(model)
    assert before["STAGED"] == 0 and before["CAST"] > 0
    assert staged_counts["RESTAGED"] > 0
    assert after["CAST"] == before["CAST"] and after["STAGED"] == n
    assert torch.equal(staged, per_call)


def tiny_jen1(codec=None, bf16_compute=True) -> Jen1:
    cfg = tiny_test_config()
    if bf16_compute:
        cfg.model_config = dataclasses.replace(cfg.model_config, dtype="bfloat16")
    cfg.conditioner_config.t5_config.t5_model_name = "tiny-test"
    cfg.conditioner_config.t5_config.max_length = cfg.model_config.context_embedding_max_length
    if codec is None:
        from jen1_tpu_torch.codec.model import EncodecConfig, EncodecModel

        codec = EncodecModel(EncodecConfig(sample_rate=1600, channels=2, dimension=8,
                                           n_filters=2, ratios=(5, 4, 2), n_q=4, bins=16),
                             device="cpu")
    return Jen1(sample_rate=1600, config=cfg, codec=codec, device="cpu")


def request(jen1: Jen1, use_gdm: bool = False):
    return jen1.generate("a tiny tune", seed=3, steps=2, seconds=0.5, decode=False,
                         use_gdm=use_gdm)


def lora_merge(model: nn.Module) -> None:
    from jen1_tpu_torch.train.lora import init_lora, merge_lora

    adapter = init_lora(model, 2, generator=torch.Generator().manual_seed(4))
    for ab in adapter.values():
        ab["b"].normal_(generator=torch.Generator().manual_seed(5))
    merge_lora(model, adapter, 0.5)


WRITES = {
    "load_state_dict": lambda jen1: jen1.model.load_state_dict(built("unet", 7).state_dict()),
    "cast_weights_bf16": lambda jen1: cast_weights_bf16(jen1.model),
    "lora_merge": lambda jen1: lora_merge(jen1.model),
}


@pytest.mark.parametrize("write", sorted(WRITES))
@pytest.mark.parametrize("use_gdm", [False, True])
def test_a_weight_write_reaches_the_next_request(write, use_gdm, counters):
    """Between two requests the weights change; the second request equals a
    fresh Jen1's (same weights, staged at its own first request). Written
    in place, the copies are refilled at their addresses and the cached
    sampler is kept; rebound, they are made anew under a new key."""
    jen1 = tiny_jen1()
    first = request(jen1, use_gdm)
    assert counters()["RESTAGED"] == reads(jen1.model)
    (entry,) = jen1._sample_cache.values()
    WRITES[write](jen1)
    second = request(jen1, use_gdm)
    fresh = tiny_jen1(codec=jen1.codec)
    if write == "cast_weights_bf16":
        cast_weights_bf16(fresh.model)
    fresh.model.load_state_dict(jen1.model.state_dict())
    assert torch.equal(torch.from_numpy(second), torch.from_numpy(request(fresh, use_gdm)))
    assert not torch.equal(torch.from_numpy(second), torch.from_numpy(first)) \
        or write == "cast_weights_bf16"
    kept = list(jen1._sample_cache.values()) == [entry]
    assert kept == (write != "cast_weights_bf16")
    assert counters()["CAST"] == 0


def test_grad_route_casts_per_call(counters):
    """Under grad mode a weight that requires grad is cast at the call: the
    gradients equal an unstaged twin's, and nothing is served staged."""
    staged, twin = built("unet-cfg"), built("unet-cfg")
    staging.stage(staged, BF16)
    grads, casts = [], []
    for model in (staged, twin):
        before = counters()["CAST"]
        forward("unet-cfg", model).square().mean().backward()
        casts.append(counters()["CAST"] - before)
        grads.append([p.grad for p in model.parameters()])
    assert counters()["STAGED"] == 0 and casts[0] == casts[1] > 0
    for a, b in zip(*grads):
        assert (a is None and b is None) or torch.equal(a, b)


def test_state_dict_keys_unchanged():
    model, twin = built("unet-cfg"), built("unet-cfg")
    staging.stage(model, BF16)
    assert any(staging.staged_copies(m) for m in model.modules())
    assert list(model.state_dict()) == list(twin.state_dict())
    twin.load_state_dict(model.state_dict(), strict=True)


def test_weights_key_follows_the_copies():
    """A copy refilled in place keeps the key; a copy made anew (its old one
    still held, so the address cannot be reused) changes it."""
    model = built("unet-cfg")
    staging.stage(model, BF16)
    key = weights_key(model)
    assert sum(":staged" in name for name, *_ in key) == sum(
        len(staging.staged_copies(m)) for m in model.modules())
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(2.0)
    staging.stage(model, BF16)
    assert weights_key(model) == key
    conv = next(m for m in model.modules() if isinstance(m, OmniConv1d))
    held = conv.__dict__.pop("_staged")
    staging.stage(model, BF16)
    assert weights_key(model) != key and held


def test_int8_route_stages_no_weight(counters):
    """A stride-1 conv with an int8 kernel reads the kernel, not its weight:
    no copy, nothing counted; cleared, it is staged again."""
    from jen1_tpu_torch.ops.int8_matmul import attach_qweights, clear_qweights, \
        quantize_conv_params

    conv = OmniConv1d(16, 8, 3)
    init_module(conv, torch.Generator().manual_seed(0))
    staging.stage(conv, BF16)
    assert len(staging.staged_copies(conv)) == 2
    q = quantize_conv_params(conv, min_weight_bytes=0, min_weight_bytes_k1=0)
    assert attach_qweights(conv, q) == 1
    staging.stage(conv, BF16)
    assert staging.staged_copies(conv) == []
    x = torch.randn(2, 10, 16).to(BF16)
    with torch.no_grad():
        conv(x)
    assert counters()["STAGED"] == counters()["CAST"] == 0
    clear_qweights(conv)
    staging.stage(conv, BF16)
    assert len(staging.staged_copies(conv)) == 2


@pytest.fixture
def one_rank_group():
    import torch.distributed as dist

    if dist.is_initialized():
        pytest.skip("a process group is up already")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def distribute(linear):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    mesh = init_device_mesh("cpu", (1,))
    for name in ("weight", "bias"):
        t = getattr(linear, name).detach()
        setattr(linear, name, nn.Parameter(distribute_tensor(t, mesh, [Replicate()])))


@pytest.mark.parametrize("route", ["sp", "dtensor"])
def test_routes_that_cast_per_call(route, counters, monkeypatch, request):
    """A staged Linear under sequence parallelism, or holding DTensor
    weights (the mesh), casts at the call; the output is the staged one's."""
    import contextlib

    from torch.distributed.tensor.experimental import implicit_replication

    linear = Linear(16, 8)
    init_module(linear, torch.Generator().manual_seed(0))
    x = torch.randn(3, 16).to(BF16)
    staging.stage(linear, BF16)
    with torch.no_grad():
        want = linear(x)
    assert counters()["STAGED"] == 2
    ctx = contextlib.nullcontext()
    if route == "dtensor":
        request.getfixturevalue("one_rank_group")
        distribute(linear)
        staging.stage(linear, BF16)
        assert staging.staged_copies(linear) == []
        ctx = implicit_replication()
    else:
        monkeypatch.setattr(seq, "active", lambda: object())
    with torch.no_grad(), ctx:
        out = linear(x)
    if route == "dtensor":
        out = out.full_tensor()
    assert counters()["CAST"] == 2 and counters()["STAGED"] == 2
    assert torch.equal(out, want)
