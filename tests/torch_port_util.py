"""Helpers shared by the `tests/test_torch_*.py` parity tests: the same numpy
inputs and weights go through a JAX function and its counterpart in
`jen1_tpu_torch`, which runs on the CPU with its plain kernels."""

from __future__ import annotations

import dataclasses
import math

import jax
import numpy as np
import torch

from jen1_tpu_torch.ckpt.from_jax import load_encodec, load_flax_params

# The tiny codec of tests/test_api.py: 1600 Hz, a 40-sample hop, so 13 s are
# 520 latent frames (four 150-frame chunks); a 2-stage RVQ of 16 entries.
TINY_CODEC = dict(sample_rate=1600, channels=2, dimension=8, n_filters=2, ratios=(5, 4, 2),
                  n_q=2, bins=16)


def np_tree(tree):
    """A flax parameter tree as nested dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def load(module: torch.nn.Module, flax_params) -> torch.nn.Module:
    """Load a flax parameter tree into a port module (strict) and return it."""
    load_flax_params(module, np_tree(flax_params))
    return module.eval()


def random_params(shape_tree, seed: int):
    """A parameter tree of the shapes of `shape_tree` (e.g. from
    `jax.eval_shape(model.init, ...)`), drawn with numpy: U(+-1/sqrt(fan_in))
    kernels and biases, norm scales near 1, N(0, 1) embeddings and Fourier
    weights. Cheaper than compiling the JAX init."""
    g = rng(seed)

    def draw(name, shape):
        if name == "scale":
            return (1.0 + 0.1 * g.standard_normal(shape)).astype(np.float32)
        if name in ("kernel", "bias"):
            fan_in = int(np.prod(shape[:-1])) if name == "kernel" else shape[0]
            b = 1.0 / np.sqrt(max(fan_in, 1))
            return g.uniform(-b, b, shape).astype(np.float32)
        return g.standard_normal(shape).astype(np.float32)

    def walk(tree):
        return {
            k: walk(v) if hasattr(v, "items") else draw(k, tuple(v.shape))
            for k, v in tree.items()
        }

    return walk(shape_tree)


def jen1_pair(codec_config=TINY_CODEC, ckpt_path=None, configs=None, param_fn=None):
    """A jen1_tpu `Jen1` and a jen1_tpu_torch `Jen1(device="cpu")` with the
    same UNet (flash path engaged, `flash_model_configs`, unless `configs`
    gives the (JAX, port) pair), T5 and codec (encoder, decoder and RVQ)
    weights: tests/test_api.py's tiny model. With `ckpt_path` both load their
    UNet from it; else both get the same random UNet weights, passed through
    `param_fn` when given."""
    from jen1_tpu.api.generation import Jen1 as JJen1
    from jen1_tpu.codec.model import EncodecConfig as JCodecConfig, EncodecModel as JCodec
    from jen1_tpu.conditioning import conditioners as jcond
    from jen1_tpu_torch.api.generation import Jen1
    from jen1_tpu_torch.codec.model import EncodecConfig, EncodecModel
    from jen1_tpu_torch.conditioning import conditioners as pcond

    jcfg, pcfg = configs or flash_model_configs()
    mc = jcfg.model_config
    jcodec = JCodec(JCodecConfig(**codec_config))
    jt5 = jcond.T5Conditioner(output_dim=mc.context_embedding_features,
                              t5_model_name="tiny-test",
                              max_length=mc.context_embedding_max_length)
    jj = JJen1(ckpt_path=ckpt_path, sample_rate=codec_config["sample_rate"], config=jcfg,
               codec=jcodec, conditioner=jcond.MultiConditioner({"prompt": jt5}))
    if ckpt_path is None:
        params = random_params(unet_shapes(jj.model, mc), seed=1)
        if param_fn is not None:
            params = param_fn(params)
        jj._params = params  # the weights generate() samples with

    pcodec = EncodecModel(EncodecConfig(**codec_config), device="cpu")
    load_encodec(pcodec, np_tree(jcodec.params))
    pt5 = pcond.T5Conditioner(mc.context_embedding_features, "tiny-test",
                              mc.context_embedding_max_length, device="cpu")
    load(pt5, {"encoder": jt5.params["encoder"], "proj": jt5.params["proj"]})
    pj = Jen1(ckpt_path, sample_rate=codec_config["sample_rate"], config=pcfg,
              codec=pcodec.eval(), conditioner=pcond.MultiConditioner({"prompt": pt5}),
              device="cpu")
    if ckpt_path is None:
        load(pj.model, params)
    return jj, pj


def unet_shapes(jmodel, mc):
    """The parameter shapes of a JAX UNet (jax.eval_shape of its init)."""
    import jax.numpy as jnp

    return jax.eval_shape(lambda r: jmodel.init(
        r, jnp.zeros((1, 40, mc.in_channels)), jnp.zeros((1,)),
        embedding=jnp.zeros((1, mc.context_embedding_max_length,
                             mc.context_embedding_features)),
        channels_list=[jnp.zeros((1, 40, mc.context_channels[0]))],
    ), jax.random.PRNGKey(0))


def synthetic_clip(seed: int, seconds: float, sr: int, channels: int = 2) -> np.ndarray:
    """A seeded test clip (T, channels): two sines per channel plus noise."""
    g = rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    freqs = g.uniform(40.0, 0.4 * sr, (channels, 2))
    tones = sum(np.sin(2 * np.pi * freqs[:, i] * t[:, None] + g.uniform(0, 6.3))
                for i in range(2))
    return (0.3 * tones + 0.05 * g.standard_normal((len(t), channels))).astype(np.float32)


def hf_t5_state_dict(seed: int, cfg, embed_key: str):
    """A random HF T5EncoderModel state dict for `cfg`."""
    g = rng(seed)

    def w(*shape, scale=0.3):
        return torch.from_numpy(scale * randn(g, *shape))

    inner = cfg.num_heads * cfg.d_kv
    sd = {embed_key: w(cfg.vocab_size, cfg.d_model, scale=1.0)}
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}.layer"
        for n in ("q", "k", "v"):
            sd[f"{pre}.0.SelfAttention.{n}.weight"] = w(inner, cfg.d_model)
        sd[f"{pre}.0.SelfAttention.o.weight"] = w(cfg.d_model, inner)
        if i == 0:
            sd[f"{pre}.0.SelfAttention.relative_attention_bias.weight"] = w(
                cfg.relative_attention_num_buckets, cfg.num_heads)
        names = ("wi_0", "wi_1") if cfg.feed_forward_proj == "gated-gelu" else ("wi",)
        for n in names:
            sd[f"{pre}.1.DenseReluDense.{n}.weight"] = w(cfg.d_ff, cfg.d_model)
        sd[f"{pre}.1.DenseReluDense.wo.weight"] = w(cfg.d_model, cfg.d_ff)
        sd[f"{pre}.0.layer_norm.weight"] = 1.0 + w(cfg.d_model, scale=0.1)
        sd[f"{pre}.1.layer_norm.weight"] = 1.0 + w(cfg.d_model, scale=0.1)
    sd["encoder.final_layer_norm.weight"] = 1.0 + w(cfg.d_model, scale=0.1)
    return sd


class one_torch_thread:
    """Run a block with one intra-op torch thread, then restore the count.

    A tiny codec's LSTM steps one frame at a time; on a CPU shared by
    several test workers each step's parallel region waits for threads the
    other workers hold (minutes for a 520-step LSTM at 8 threads under
    load, milliseconds at one thread)."""

    def __enter__(self):
        self.threads = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.threads)


def rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def randn(g: np.random.Generator, *shape) -> np.ndarray:
    return g.standard_normal(shape).astype(np.float32)


def assert_close(port, ref, rtol: float, atol: float) -> None:
    if isinstance(port, torch.Tensor):
        port = port.detach().cpu().numpy()
    np.testing.assert_allclose(
        np.asarray(port, np.float32), np.asarray(ref, np.float32), rtol=rtol, atol=atol
    )


def tiny_model_configs(**model_kw):
    """The JAX and port tiny_test_config() with the model_config fields
    `model_kw`."""
    from jen1_tpu.config import tiny_test_config as jax_tiny
    from jen1_tpu_torch.config import tiny_test_config as port_tiny

    jcfg, pcfg = jax_tiny(), port_tiny()
    jcfg.model_config = dataclasses.replace(jcfg.model_config, **model_kw)
    pcfg.model_config = dataclasses.replace(pcfg.model_config, **model_kw)
    return jcfg, pcfg


def with_alphas(params, seed: int = 0):
    """`params` with every Snake `alpha` leaf drawn from U(0.5, 1.5), as a
    trained Snake keeps it (random_params draws N(0, 1))."""
    g = rng(seed)

    def walk(tree):
        return {k: walk(v) if hasattr(v, "items")
                else (g.uniform(0.5, 1.5, v.shape).astype(np.float32) if k == "alpha" else v)
                for k, v in tree.items()}

    return walk(params)


def flash_model_configs(flash_min_seq_len: int = 128):
    """The JAX and port tiny_test_config() with the flash path engaged."""
    from jen1_tpu.config import tiny_test_config as jax_tiny
    from jen1_tpu_torch.config import tiny_test_config as port_tiny

    kw = dict(use_flash_attention=True, flash_min_seq_len=flash_min_seq_len)
    jcfg, pcfg = jax_tiny(), port_tiny()
    jcfg.model_config = dataclasses.replace(jcfg.model_config, **kw)
    pcfg.model_config = dataclasses.replace(pcfg.model_config, **kw)
    return jcfg, pcfg


def vdm_initial_noise(seed: int, shape) -> np.ndarray:
    """The JAX Jen1.generate VDM stream: fold_in(key(seed), 2), split, and
    the first half drawn as N(0, 1) (generation.py:429,648; vdm.py:157-158)."""
    rng_init, _ = jax.random.split(jax.random.fold_in(jax.random.key(seed), 2))
    return np.array(jax.random.normal(rng_init, shape, jax.numpy.float32))


def gdm_draws(key, shape, fold_values):
    """The draws of the JAX `GaussianDiffusion.sample(..., rng=key)`: split
    the key, x_T from the first half; the step that folds `v` into the
    second half draws its noise from split(fold_in(rng_loop, v))[1]
    (gdm.py:318-332, :454-473). DDIM folds the step index, DDPM the
    timestep. Returns (x_T, [noise per fold value])."""
    rng_init, rng_loop = jax.random.split(key)
    x_t = np.array(jax.random.normal(rng_init, shape, jax.numpy.float32))
    noises = [
        np.array(jax.random.normal(jax.random.split(jax.random.fold_in(rng_loop, v))[1],
                                   shape, jax.numpy.float32))
        for v in fold_values
    ]
    return x_t, noises


def inject_gdm_draws(monkeypatch, x_t, noises) -> None:
    """Make jen1_tpu_torch's GDM samplers take x_T and step i's noise from
    the given arrays instead of their generator."""
    from jen1_tpu_torch.diffusion import gdm

    monkeypatch.setattr(gdm, "initial_noise",
                        lambda shape, generator, device: torch.from_numpy(x_t).to(device))
    monkeypatch.setattr(gdm, "step_noise",
                        lambda x, generator, index, uniform=False:
                        torch.from_numpy(noises[index]).to(x.device))


# Plain-PyTorch emulations of the arithmetic of the tensor-core (bf16) routes
# of K1, K2 and K3 (jen1_tpu_torch/csrc/flash_attention_{fwd,bwd}.cu), for
# the tests only: the kernels run on the card alone, these show on the CPU
# that their design meets the card's bars against the Pallas kernels. Inputs
# are bf16 (B*H, N, D); every product takes bf16 operands (exact in fp32)
# into an fp32 sum, as mma.sync does; P, dS and dS^T enter their products as bf16
# hi + lo (hi the fp32's upper 16 bits, lo = bf16(x - hi): flash_mma.cuh
# `split`), or as one rounded bf16 copy with `split=False`.
FLASH_TILE = 64
LOG2E = 1.4426950408889634


def _bf16_parts(x: torch.Tensor, split: bool):
    if not split:
        return (x.to(torch.bfloat16).float(),)
    hi = (x.view(torch.int32) & -65536).view(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).float()


def flash_fwd_mma_emulation(q, k, v, causal: bool, split: bool = True):
    """K1's bf16 route: 64-key tiles in order, the running max in log2
    units with sm_scale*log2(e) folded into the exponent, alpha-rescaled
    sum and accumulator, O = acc * (1 / max(l, 1e-30)) rounded to bf16,
    lse = m ln 2 + log(l). -> (o bf16, lse fp32 (B*H, N))."""
    bh, n, d = q.shape
    scale_log2 = d**-0.5 * LOG2E
    qf, kf, vf = q.float(), k.float(), v.float()
    rows = torch.arange(n)[:, None]
    m = torch.full((bh, n), float("-inf"))
    l = torch.zeros(bh, n)
    acc = torch.zeros(bh, n, d)
    for k0 in range(0, n, FLASH_TILE):
        kt, vt = kf[:, k0:k0 + FLASH_TILE], vf[:, k0:k0 + FLASH_TILE]
        s = qf @ kt.transpose(-1, -2)
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[1])[None, :]
            s = s.masked_fill(cols > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
        m_use = torch.where(m_new == float("-inf"), torch.zeros(()), m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(s * scale_log2 - m_use[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None]
        for part in _bf16_parts(p, split):
            acc = acc + part @ vt
        m = m_new
    l_safe = l.clamp_min(1e-30)
    o = (acc * (1.0 / l_safe)[..., None]).to(torch.bfloat16)
    return o, m * math.log(2.0) + torch.log(l_safe)


def flash_bwd_dkv_mma_emulation(q, k, v, do, lse, delta, causal: bool, split: bool = True):
    """K3's bf16 route: 64-query tiles in order, P^T = 2^(S^T sm_scale
    log2(e) - lse log2(e)) with the causal mask, dS^T = P^T (dP^T - delta),
    dV += P^T dO and dK += dS^T Q in fp32, dK times sm_scale, both rounded
    to bf16 at the end. lse and delta are fp32 (B*H, N). -> (dk, dv) bf16."""
    bh, n, d = q.shape
    sm_scale = d**-0.5
    scale_log2 = sm_scale * LOG2E
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    keys = torch.arange(n)[:, None]
    dk = torch.zeros(bh, n, d)
    dv = torch.zeros(bh, n, d)
    for q0 in range(0, n, FLASH_TILE):
        qt, dot = qf[:, q0:q0 + FLASH_TILE], dof[:, q0:q0 + FLASH_TILE]
        lt = lse[:, None, q0:q0 + FLASH_TILE] * LOG2E
        dlt = delta[:, None, q0:q0 + FLASH_TILE]
        p = torch.exp2(kf @ qt.transpose(-1, -2) * scale_log2 - lt)
        if causal:
            queries = torch.arange(q0, q0 + qt.shape[1])[None, :]
            p = p.masked_fill(keys > queries, 0.0)
        ds = p * (vf @ dot.transpose(-1, -2) - dlt)
        for part in _bf16_parts(p, split):
            dv = dv + part @ dot
        for part in _bf16_parts(ds, split):
            dk = dk + part @ qt
    return (dk * sm_scale).to(torch.bfloat16), dv.to(torch.bfloat16)


def flash_bwd_dq_mma_emulation(q, k, v, do, lse, delta, causal: bool, split: bool = True):
    """K2's bf16 route: 64-key tiles in order, P = 2^(S sm_scale log2(e) -
    lse log2(e)) with the causal mask, dS = P (dP - delta), dq += dS K in
    fp32, dq times sm_scale and rounded to bf16 at the end. lse and delta are
    fp32 (B*H, N). -> dq bf16."""
    bh, n, d = q.shape
    sm_scale = d**-0.5
    scale_log2 = sm_scale * LOG2E
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    rows = torch.arange(n)[:, None]
    lt, dlt = lse[..., None] * LOG2E, delta[..., None]
    dq = torch.zeros(bh, n, d)
    for k0 in range(0, n, FLASH_TILE):
        kt, vt = kf[:, k0:k0 + FLASH_TILE], vf[:, k0:k0 + FLASH_TILE]
        p = torch.exp2(qf @ kt.transpose(-1, -2) * scale_log2 - lt)
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[1])[None, :]
            p = p.masked_fill(cols > rows, 0.0)
        ds = p * (dof @ vt.transpose(-1, -2) - dlt)
        for part in _bf16_parts(ds, split):
            dq = dq + part @ kt
    return (dq * sm_scale).to(torch.bfloat16)


def int8_as_bf16_magic(w8: torch.Tensor) -> torch.Tensor:
    """K4's int8 -> bf16 conversion (csrc/int8_matmul.cu `int8_pair_to_bf16`)
    as the same bit operations: byte ^ 0x80 under the fp32 exponent of 2^23
    (0x4B0000xx), minus 2^23 + 128, then the fp32's upper 16 bits as a bf16
    (the lower 16 are cut). Returns the bf16 values as fp32."""
    u = (w8.to(torch.int32) & 0xFF) ^ 0x80
    f = (u | 0x4B000000).view(torch.float32) - 8388736.0
    return (f.view(torch.int32) & -65536).view(torch.float32)


def int8w_mma_emulation(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor):
    """K4's partition and summation order (csrc/int8_matmul.cu): K split
    into `split_k`'s ranges, one per block of a cluster; within a range,
    128-row tiles in order, each warp adding 32-row products of bf16(x) and
    the converted weights into its fp32 sum; the blocks' partial sums then
    added in rank order, and times the scale. -> (M, N) fp32."""
    from jen1_tpu_torch.ops.int8_matmul import BLOCK_K, split_k

    m, k = x.shape
    n = w8.shape[1]
    xb, wb = x.to(torch.bfloat16).float(), int8_as_bf16_magic(w8)
    splits, chunk = split_k(m, k, n)
    chunk *= BLOCK_K
    out = torch.zeros(m, n)
    for z in range(splits):
        part = torch.zeros(m, n)
        end = min(k, (z + 1) * chunk)
        for k0 in range(z * chunk, end, 32):
            part += xb[:, k0:min(end, k0 + 32)] @ wb[k0:min(end, k0 + 32)]
        out = out + part
    return out * scale.float()
