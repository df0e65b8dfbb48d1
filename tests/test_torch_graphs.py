"""The port's samplers on static buffers (`diffusion/gdm.py::StaticSampler`:
`VDMSampler`, `DDIMSampler`), whose steps are CUDA graphs on the card, and
`Jen1._sample_cache`, on the CPU, where every step runs eagerly:

* bit for bit (`torch.equal`) the eager loops they replaced, kept below as
  `reference_vdm` and `reference_ddim`: VDM and DDIM at encoder_reuse 1 and
  2, "scan" and "stepwise", a text_guided request (x_T alone) and a
  music_cont one (causal, x_T + the init latent), and CFG dropout during
  sampling, whose bits the samplers draw before the loop in the loop's
  order;
* jen1_tpu's mode="scan" (its `lax.scan` run as a Python loop around a UNet
  jitted once per call signature, as tests/test_torch_reuse.py runs it) and
  mode="stepwise" (JAX's own host loop over one jitted step), with the JAX
  draws injected, at the sampler-trajectory bar rtol 2e-2 / atol 2e-3;
* the cache keys of a tiny Jen1, the cache's bound and lock, nothing
  captured on the CPU, and `disable_graphs()`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jen1_tpu.config import VDMConfig as JVDMConfig
from jen1_tpu.diffusion.vdm import create_variational_diffusion as jax_vdm
from jen1_tpu_torch.api.generation import SAMPLE_CACHE_ENTRIES
from jen1_tpu_torch.config import VDMConfig
from jen1_tpu_torch.diffusion import gdm as port_gdm
from jen1_tpu_torch.diffusion import vdm as port_vdm
from jen1_tpu_torch.utils.cuda_graphs import StepProgram, disable_graphs, graphs_enabled
from test_torch_reuse import (  # noqa: F401 - the module's JAX fixtures
    SAMPLER_LENGTH, diffusions, jitted_unet, python_scan, sampler_cond, unets,
)
from torch_port_util import assert_close, gdm_draws, inject_gdm_draws, one_torch_thread

TRAJECTORY = dict(rtol=2e-2, atol=2e-3)
STEPS = 4
SEED = 29


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    with one_torch_thread():
        yield


# ------------------------------------------------ the replaced eager loops


def reference_vdm(vdm, model_fn, shape, conditioning, generator, *, step, causal=False,
                  init_data=None):
    """VDM.p_sample_loop before its steps moved onto static buffers."""
    batch = shape[0]
    audio = port_gdm.with_init_data(port_vdm.initial_noise(shape, generator, "cpu"), init_data)
    steps = np.linspace(1.0, 0.0, step + 1, dtype=np.float32)
    dropout = {}
    if vdm.dropout_during_sampling:
        dropout = dict(embedding_mask_proba=vdm.cfg_dropout_proba, generator=generator)
    for t, t_next in zip(steps[:-1], steps[1:]):
        time_cond = torch.full((batch,), float(t), dtype=torch.float32)
        v_pred = vdm._call_model(model_fn, audio, time_cond, conditioning, causal=causal,
                                 **dropout).float()
        alpha, sigma = (float(a) for a in port_vdm.alpha_sigma(t))
        alpha_next, sigma_next = (float(a) for a in port_vdm.alpha_sigma(t_next))
        x_pred = alpha * audio - sigma * v_pred
        noise_pred = sigma * audio + alpha * v_pred
        audio = alpha_next * x_pred + sigma_next * noise_pred
    return audio


def reference_ddim(gdm, model_fn, shape, conditioning, generator, *, causal=False,
                   init_data=None, encoder_reuse=1):
    """GaussianDiffusion.ddim_sample before its steps moved onto static
    buffers."""
    batch = shape[0]
    acp = gdm.alphas_cumprod_host
    eta = np.float32(gdm.ddim_sampling_eta)
    one = np.float32(1.0)
    audio = port_gdm.with_init_data(port_gdm.initial_noise(shape, generator, "cpu"), init_data)
    pairs = port_gdm.time_pairs(gdm.num_timesteps, gdm.sampling_timesteps)
    whole = port_gdm.reuse_schedule(len(pairs), encoder_reuse, final_full=True)
    cache = None
    for i, (time, time_next) in enumerate(pairs):
        time_cond = torch.full((batch,), time, dtype=torch.long)
        if encoder_reuse > 1:
            pred_noise, x_start, cache = gdm.cached_predictions(
                model_fn, audio, time_cond, conditioning, cache=None if whole[i] else cache,
                causal=causal, generator=generator)
        else:
            pred_noise, x_start = gdm.model_predictions(
                model_fn, audio, time_cond, conditioning, clip_x_start=True, causal=causal,
                generator=generator)
        alpha, alpha_next = acp[time], acp[max(time_next, 0)]
        sigma = eta * np.sqrt((one - alpha / alpha_next) * (one - alpha_next) / (one - alpha))
        c = np.sqrt(one - alpha_next - sigma * sigma)
        noise = port_gdm.step_noise(audio, generator, i)
        if time_next < 0:
            audio = x_start
        else:
            audio = (x_start * float(np.sqrt(alpha_next)) + float(c) * pred_noise
                     + float(sigma) * noise)
    return audio


# ------------------------------------------------------------- the cases


def port_cond(mc):
    return {k: torch.from_numpy(v) for k, v in sampler_cond(mc).items()}


def init_latent(mc):
    """A music_cont start: an encoded clip's first half, zeros after."""
    g = np.random.default_rng(SEED)
    lat = g.standard_normal((1, SAMPLER_LENGTH, mc.in_channels)).astype(np.float32)
    lat[:, SAMPLER_LENGTH // 2:] = 0.0
    return torch.from_numpy(lat)


def port_vdm_diffusion(dropout=False):
    vdm = port_vdm.create_variational_diffusion(VDMConfig())
    if dropout:
        vdm.dropout_during_sampling, vdm.cfg_dropout_proba = True, 0.5
    return vdm


def run_port(sampler, pmodel, mc, mode, task, generator, dropout=False):
    """The port's sampler on static buffers, eagerly: sampler 'vdm', or
    'ddim1' / 'ddim2' (DDIM at encoder_reuse 1 / 2)."""
    shape = (1, SAMPLER_LENGTH, mc.in_channels)
    causal, init = (True, init_latent(mc)) if task == "music_cont" else (False, None)
    model_fn = lambda x, t, **kw: pmodel(x, t, **kw)  # noqa: E731
    if sampler == "vdm":
        return port_vdm_diffusion(dropout).p_sample_loop(
            model_fn, shape, port_cond(mc), generator, device="cpu", step=STEPS,
            causal=causal, init_data=init, mode=mode)
    _, pdiff = diffusions(STEPS)
    pdiff.dropout_during_sampling = dropout
    return pdiff.sample(model_fn, shape, port_cond(mc), generator, device="cpu",
                        causal=causal, init_data=init, mode=mode,
                        encoder_reuse=2 if sampler == "ddim2" else 1)


def run_reference(sampler, pmodel, mc, task, generator, dropout=False):
    shape = (1, SAMPLER_LENGTH, mc.in_channels)
    causal, init = (True, init_latent(mc)) if task == "music_cont" else (False, None)
    model_fn = lambda x, t, **kw: pmodel(x, t, **kw)  # noqa: E731
    with torch.no_grad():
        if sampler == "vdm":
            return reference_vdm(port_vdm_diffusion(dropout), model_fn, shape, port_cond(mc),
                                 generator, step=STEPS, causal=causal, init_data=init)
        _, pdiff = diffusions(STEPS)
        pdiff.dropout_during_sampling = dropout
        return reference_ddim(pdiff, model_fn, shape, port_cond(mc), generator, causal=causal,
                              init_data=init, encoder_reuse=2 if sampler == "ddim2" else 1)


EQUAL_CASES = [(s, m, t) for s in ("vdm", "ddim1", "ddim2") for m in ("scan", "stepwise")
               for t in ("text_guided", "music_cont") if not (s == "ddim2" and m == "stepwise")]


@pytest.mark.parametrize("sampler,mode,task", EQUAL_CASES)
def test_static_sampler_equals_the_eager_loop(unets, sampler, mode, task):
    """The steps on static buffers, with the per-step scalars read from a
    device table through the step index, give the old loop's bits."""
    _, _, pmodel, mc = unets
    out = run_port(sampler, pmodel, mc, mode, task, torch.Generator().manual_seed(SEED))
    ref = run_reference(sampler, pmodel, mc, task, torch.Generator().manual_seed(SEED))
    assert torch.equal(out, ref)


@pytest.mark.parametrize("sampler", ["vdm", "ddim1", "ddim2"])
def test_dropout_bits_are_drawn_in_the_loops_order(unets, sampler):
    """With dropout_during_sampling every step's CFG bits (and DDIM's step
    noise) come from the request's generator before the loop, in the order
    the old loop drew them inside the UNet: the same bits, the same audio."""
    _, _, pmodel, mc = unets
    gen = torch.Generator().manual_seed(SEED)
    out = run_port(sampler, pmodel, mc, "scan", "text_guided", gen, dropout=True)
    ref_gen = torch.Generator().manual_seed(SEED)
    ref = run_reference(sampler, pmodel, mc, "text_guided", ref_gen, dropout=True)
    assert torch.equal(out, ref)
    assert torch.equal(gen.get_state(), ref_gen.get_state())  # as many draws


# ------------------------------------------------------- against jen1_tpu


def jax_vdm_diffusion():
    return jax_vdm(dataclasses.replace(JVDMConfig()))


@pytest.fixture(scope="module")
def jax_refs(unets, jitted_unet):
    """jen1_tpu's trajectories: (sampler, mode, task) -> (ref, x_T, step
    noises). 'scan' runs the JAX sampler's lax.scan as a Python loop around
    `jitted_unet`; 'stepwise' is JAX's host loop over its jitted step, the
    weights an argument of the jit."""
    jmodel, params, _, mc = unets
    shape = (1, SAMPLER_LENGTH, mc.in_channels)
    cond = sampler_cond(mc)
    key = jax.random.key(SEED)
    init = np.asarray(init_latent(mc))
    refs = {}
    for sampler, mode, task in [("vdm", "scan", "text_guided"), ("vdm", "stepwise", "text_guided"),
                                ("vdm", "scan", "music_cont"), ("ddim1", "scan", "text_guided"),
                                ("ddim1", "stepwise", "text_guided"),
                                ("ddim2", "scan", "text_guided")]:
        causal = task == "music_cont"
        kw = dict(causal=causal, init_data=jnp.asarray(init) if causal else None, mode=mode)
        diff = jax_vdm_diffusion() if sampler == "vdm" else diffusions(STEPS)[0]
        if sampler == "vdm":
            kw["step"] = STEPS
        if sampler == "ddim2":
            kw["encoder_reuse"] = 2
        if mode == "stepwise":
            out = diff.sample(lambda p, x, t, **a: jmodel.apply(p, x, t, **a), shape, cond, key,
                              model_params=params, **kw)
        else:
            with pytest.MonkeyPatch.context() as patch:
                patch.setattr(jax.lax, "scan", python_scan)
                out = diff.sample(jitted_unet, shape, cond, key, **kw)
        x_t = np.array(jax.random.normal(jax.random.split(key)[0], shape, jnp.float32))
        noises = None if sampler == "vdm" else gdm_draws(key, shape, range(STEPS))[1]
        refs[sampler, mode, task] = (np.asarray(out), x_t, noises)
    return refs


@pytest.mark.parametrize("sampler,mode,task", [
    ("vdm", "scan", "text_guided"), ("vdm", "stepwise", "text_guided"),
    ("vdm", "scan", "music_cont"), ("ddim1", "scan", "text_guided"),
    ("ddim1", "stepwise", "text_guided"), ("ddim2", "scan", "text_guided"),
])
def test_static_sampler_matches_jax_modes(unets, jax_refs, monkeypatch, sampler, mode, task):
    _, _, pmodel, mc = unets
    ref, x_t, noises = jax_refs[sampler, mode, task]
    if sampler == "vdm":
        monkeypatch.setattr(port_vdm, "initial_noise",
                            lambda shape, generator, device: torch.from_numpy(x_t))
    else:
        inject_gdm_draws(monkeypatch, x_t, noises)
    out = run_port(sampler, pmodel, mc, mode, task, torch.Generator().manual_seed(0))
    assert torch.isfinite(out).all()
    assert_close(out, ref, **TRAJECTORY)


# ---------------------------------------------------------- Jen1's cache


@pytest.fixture(scope="module")
def tiny_jen1():
    """tests/test_torch_serve.py's tiny model: tiny_test_config, the tiny
    T5, a 1600 Hz codec with a 40-sample hop."""
    from jen1_tpu_torch.api.generation import Jen1
    from jen1_tpu_torch.codec.model import EncodecConfig, EncodecModel
    from test_torch_serve import SR, tiny_config

    cfg = tiny_config()
    codec = EncodecModel(EncodecConfig(sample_rate=SR, channels=2,
                                       dimension=cfg.model_config.in_channels, n_filters=2,
                                       ratios=(5, 4, 2), n_q=4, bins=16), device="cpu")
    return Jen1(sample_rate=SR, config=cfg, codec=codec, device="cpu")


def request(jen1, **kw):
    args = dict(seed=3, steps=2, seconds=0.5, decode=False)
    args.update(kw)
    return jen1.generate("a tiny tune", **args)


def test_sample_cache_keys(tiny_jen1, monkeypatch):
    """One entry per key; steps, shape, causal, task, use_gdm and mode each
    make another; on the CPU nothing is captured. The bound is raised for
    the test, so that every key stays (test_sample_cache_is_bounded)."""
    from jen1_tpu_torch.api import generation

    monkeypatch.setattr(generation, "SAMPLE_CACHE_ENTRIES", 16)
    jen1 = tiny_jen1
    jen1._sample_cache.clear()
    first = request(jen1)
    np.testing.assert_array_equal(request(jen1), first)
    assert len(jen1._sample_cache) == 1
    clip = np.random.default_rng(0).standard_normal((800, 2)).astype(np.float32) * 0.1
    for n, kw in enumerate([dict(steps=3), dict(seconds=0.75),
                            dict(task="music_cont", init_audio=clip[:400]),
                            dict(task="music_inpaint", init_audio=clip,
                                 inpainting_scope=(0.1, 0.3)),
                            dict(use_gdm=True), dict(sampler_mode="stepwise")], start=2):
        request(jen1, **kw)
        assert len(jen1._sample_cache) == n, kw
        request(jen1, **kw)
        assert len(jen1._sample_cache) == n, kw
    causal = [k for k in jen1._sample_cache if k[3]]
    assert len(causal) == 1 and causal[0][4] == "music_cont"
    assert (jen1.graphs.captures, jen1.graphs.replays) == (0, 0)
    assert all(p.graph is None for s in jen1._sample_cache.values() for p in s.programs)
    jen1._sample_cache.clear()


def test_sample_cache_is_bounded(tiny_jen1):
    """Requests of more distinct (seconds, steps) keys than the bound keep
    the most recently used SAMPLE_CACHE_ENTRIES; a hit makes its entry the
    most recent."""
    jen1 = tiny_jen1
    jen1._sample_cache.clear()
    keys = [dict(steps=1 + i % 3, seconds=(0.5, 0.75)[i // 3]) for i in range(6)]
    assert len(keys) > SAMPLE_CACHE_ENTRIES
    entries = []
    for kw in keys:
        request(jen1, **kw)
        assert len(jen1._sample_cache) <= SAMPLE_CACHE_ENTRIES, kw
        entries.append(list(jen1._sample_cache.values())[-1])
    assert list(jen1._sample_cache.values()) == entries[-SAMPLE_CACHE_ENTRIES:]
    oldest = entries[-SAMPLE_CACHE_ENTRIES]
    request(jen1, **keys[-SAMPLE_CACHE_ENTRIES])  # a hit: now the most recent
    request(jen1, **keys[0])  # a miss: drops the least recently used
    kept = list(jen1._sample_cache.values())
    assert len(kept) == SAMPLE_CACHE_ENTRIES and kept[-2] is oldest
    assert entries[-SAMPLE_CACHE_ENTRIES + 1] not in kept
    jen1._sample_cache.clear()


def test_threads_share_a_cache_entry_one_request_at_a_time(tiny_jen1):
    """Two threads calling generate() with one key share one sampler and
    its static buffers; the sampler lock keeps every answer the one a lone
    call gives."""
    import threading

    jen1 = tiny_jen1
    jen1._sample_cache.clear()
    refs = {seed: request(jen1, seed=seed) for seed in (3, 4)}
    got = {3: [], 4: []}

    def worker(seed):
        for _ in range(3):
            got[seed].append(request(jen1, seed=seed))

    threads = [threading.Thread(target=worker, args=(seed,)) for seed in refs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(jen1._sample_cache) == 1
    for seed, outs in got.items():
        assert len(outs) == 3
        for out in outs:
            np.testing.assert_array_equal(out, refs[seed])
    jen1._sample_cache.clear()


def test_a_pickled_jen1_starts_an_empty_cache(tiny_jen1):
    """Pickling leaves the samplers, their graphs and the lock behind; the
    copy samples as the original does."""
    import pickle

    jen1 = tiny_jen1
    jen1._sample_cache.clear()
    ref = request(jen1)
    copy = pickle.loads(pickle.dumps(jen1))
    assert len(jen1._sample_cache) == 1 and copy._sample_cache == {}
    assert copy._sample_lock is not jen1._sample_lock and copy.graphs is not jen1.graphs
    np.testing.assert_array_equal(request(copy), ref)
    jen1._sample_cache.clear()


def test_sample_cache_follows_the_weights(tiny_jen1):
    """A weight load in place is read by the cached sampler; rebound
    weights (int8 kernels attached and cleared, a bf16 cast) make a new
    key, and the old weights' entries are dropped."""
    from jen1_tpu_torch.api.generation import cast_weights_bf16, weights_key
    from jen1_tpu_torch.ops.int8_matmul import (
        attach_qweights, clear_qweights, quantize_conv_params,
    )

    jen1 = tiny_jen1
    jen1._sample_cache.clear()
    saved = {n: p.detach().clone() for n, p in jen1.model.named_parameters()}
    try:
        before = request(jen1, use_gdm=True)
        (entry,) = jen1._sample_cache.values()
        with torch.no_grad():
            for p in jen1.model.parameters():
                p.mul_(1.01)
        loaded = request(jen1, use_gdm=True)
        assert list(jen1._sample_cache.values()) == [entry]
        assert not np.array_equal(loaded, before)

        q = quantize_conv_params(jen1.model, min_weight_bytes=0, min_weight_bytes_k1=0)
        assert attach_qweights(jen1.model, q) > 0
        int8 = request(jen1, use_gdm=True)
        (int8_entry,) = jen1._sample_cache.values()
        assert int8_entry is not entry and not np.array_equal(int8, loaded)
        clear_qweights(jen1.model)
        np.testing.assert_array_equal(request(jen1, use_gdm=True), loaded)
        assert int8_entry not in jen1._sample_cache.values()

        key = weights_key(jen1.model)
        cast_weights_bf16(jen1.model)
        assert weights_key(jen1.model) != key
        request(jen1, use_gdm=True)
        ((k, _),) = jen1._sample_cache.items()
        assert k[-1] == weights_key(jen1.model)
    finally:
        with torch.no_grad():
            for n, p in jen1.model.named_parameters():
                p.data = saved[n]
        jen1._sample_cache.clear()


# ------------------------------------------------- programs on the CPU


def test_step_program_runs_eagerly_on_the_cpu():
    from jen1_tpu_torch.utils.cuda_graphs import GraphSet

    x = torch.zeros(3)
    for graphs in (None, GraphSet()):
        program = StepProgram("cpu", graphs)
        for _ in range(3):
            program(lambda: x.add_(1.0))
        assert program.graph is None
    assert torch.equal(x, torch.full((3,), 6.0))


def test_a_dropped_sampler_or_jen1_is_freed_at_once(tiny_jen1):
    """A sampler holds its programs, which hold no step function, and the
    UNet, not its Jen1: no reference cycle keeps an evicted entry's buffers
    and graphs, or a dropped Jen1's weights, alive until a garbage
    collection."""
    import gc
    import weakref

    from jen1_tpu_torch.api.generation import Jen1

    gc.collect()
    gc.disable()
    try:
        tiny_jen1._sample_cache.clear()
        request(tiny_jen1, use_gdm=True, encoder_reuse=2, steps=3)
        (sampler,) = tiny_jen1._sample_cache.values()
        ref = weakref.ref(sampler)
        del sampler
        tiny_jen1._sample_cache.clear()
        assert ref() is None
        other = Jen1(sample_rate=tiny_jen1.sample_rate, config=tiny_jen1.config,
                     codec=tiny_jen1.codec, conditioner=tiny_jen1.conditioner, device="cpu")
        request(other)
        refs = [weakref.ref(other), weakref.ref(next(iter(other._sample_cache.values())))]
        del other
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


def test_disable_graphs_nests_and_restores():
    assert graphs_enabled()
    with disable_graphs():
        assert not graphs_enabled()
        with pytest.raises(RuntimeError):
            with disable_graphs():
                assert not graphs_enabled()
                raise RuntimeError("inner")
        assert not graphs_enabled()
    assert graphs_enabled()
