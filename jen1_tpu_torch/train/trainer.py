"""Unified multi-task trainer (port of jen1_tpu/train/trainer.py:49-567,
without a device mesh).

Each batch splits into one sub-batch per task (batch % n_tasks == 0); each
sub-batch gets its task's latent mask and causal flag. Tasks that share a
causal flag are concatenated into one batched UNet forward, so a step makes
at most two forwards (one causal, one not); the per-task losses are the
means of their slices of the per-example loss, and their sum is the loss
that takes one gradient step (fused AdamW when grad_accum_every == 1, else
the optax-semantics chain with MultiSteps accumulation), with optional EMA.

Random draws. text_guided's causal flag is a coin from the host's
`np.random.Generator` (`rng_host.integers(0, 2)`, as in JAX, so both draw
the same coin from the same seed). Every device draw of a step - mask
lengths and starts, GDM timesteps or VDM times, noise, CFG dropout bits -
comes from `draw_randoms`, seeded by the step's torch.Generator; a test can
replace it with draws rebuilt from JAX's keys.

Precision. Parameters, gradients and optimizer state are fp32. The UNet
runs at `model_config.dtype` (x_t, the conditioning and the text embedding
are cast to it at the model boundary, the weights at each use) and
returns fp32 to the loss. The JAX trainer hands its model an fp32 x_t (its
q_sample promotes the bf16 latents) and the flax modules cast to their
compute dtype inside; in fp32 the two agree (tests/test_torch_train.py).

Checkpoints. `state_dict(state)` flattens the parameters, the optimizer
state (fused AdamW, or the chain with its MultiSteps accumulator, one
vector per field under `flatten_optimizer`), the step and the EMA into one
{name: tensor} dict, the format of `ckpt/checkpoint.py`; `load_state_dict`
restores it onto the trainer's device.

Composer. With n_tracks > 1 the masks carry one channel per track and the
`track_gen` task hides a drawn subset of tracks (`StepDraws.track_bits`).

LoRA. `train/lora.py::LoRATrainer` trains an adapter over a frozen base
through the same steps: its `params` are the adapter's leaves. Not ported
yet: the mesh (dp/tp/fsdp/sp).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from jen1_tpu_torch.conditioning.conditioners import assemble_conditioning
from jen1_tpu_torch.models.composer import composer_conditioning, draw_track_bits
from jen1_tpu_torch.ops.conv import fp32_precision
from jen1_tpu_torch.ops.embeddings import rand_bool
from jen1_tpu_torch.train.fused_optim import fused_adamw_apply, fused_adamw_init
from jen1_tpu_torch.train.optim import global_norm, make_lr_schedule, make_optimizer
from jen1_tpu_torch.train.tasks import draw_mask_region, task_is_causal, task_mask
from jen1_tpu_torch.utils.profiling import annotate

# the state_dict name of a flat (flatten_optimizer) optimizer-state vector
FLAT_NAME = "__flat__"


@dataclasses.dataclass
class TrainState:
    opt_state: Any
    step: int = 0
    ema_params: Optional[List[torch.Tensor]] = None


@dataclasses.dataclass
class StepDraws:
    """The device random draws of one step. Per task: the hidden region's
    length and start (absent where the task draws none), track_gen's
    keep-bits (n_tracks,) and, for GDM, the timesteps (sub,). Per causal
    group (the concatenated same-flag tasks, in task order): fp32 noise
    (B_g, L, C), VDM times (B_g,) and the CFG dropout bits (B_g, 1, 1)."""

    mask_len: Dict[str, Any]
    mask_start: Dict[str, Any]
    t: Dict[str, torch.Tensor]
    noise: Dict[bool, torch.Tensor]
    times: Dict[bool, torch.Tensor]
    cfg_bits: Dict[bool, torch.Tensor]
    track_bits: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


def step_generator(device, seed: int, index: int) -> torch.Generator:
    """The torch.Generator of step (or eval batch) `index` of a run seeded
    with `seed`."""
    state = int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(state)


class UnifiedMultiTaskTrainer:
    def __init__(
        self,
        config,
        model: torch.nn.Module,
        diffusion,
        conditioner=None,
        *,
        device="cuda",
        cross_attn_cond_ids: Sequence[str] = ("prompt",),
        global_cond_ids: Sequence[str] = (),
        input_concat_ids: Sequence[str] = ("masked_input", "mask"),
    ):
        self.config = config
        self.model = model
        self.diffusion = diffusion
        self.conditioner = conditioner
        self.device = torch.device(device)
        self.tasks = tuple(config.tasks)
        self.cross_attn_cond_ids = tuple(cross_attn_cond_ids)
        self.global_cond_ids = tuple(global_cond_ids)
        self.input_concat_ids = tuple(input_concat_ids)
        self.is_gdm = config.diffusion_type == "gdm"
        oc = config.optimizer_config
        self._use_fused = oc.fused_adamw and config.grad_accum_every == 1
        self.optimizer = (
            None if self._use_fused else make_optimizer(oc, config.grad_accum_every)
        )
        self.use_ema = config.use_ema
        self.ema_decay = config.ema_decay
        self.n_tracks = max(1, config.model_config.n_tracks)
        self.track_dim = config.model_config.in_channels // self.n_tracks
        self.compute_dtype = (
            torch.bfloat16 if config.model_config.dtype == "bfloat16" else torch.float32
        )

    # ------------------------------------------------------------- state

    @property
    def params(self) -> List[torch.nn.Parameter]:
        return list(self.model.parameters())

    def init_state(self) -> TrainState:
        """Optimizer state (and the EMA copy) over the model's parameters,
        whose values the caller has set (seeded init or loaded weights)."""
        params = self.params
        opt_state = fused_adamw_init(params) if self._use_fused else self.optimizer.init(params)
        ema = [p.detach().clone() for p in params] if self.use_ema else None
        return TrainState(opt_state=opt_state, step=0, ema_params=ema)

    def _names(self) -> List[str]:
        return [name for name, _ in self.model.named_parameters()]

    def state_dict(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """`state` and the model's parameters as one flat {name: tensor}
        dict: params/<name>; ema_params/<name> with an EMA; opt/<field>/<name>
        for each per-parameter list of the optimizer state (mu, nu and the
        MultiSteps `acc`) and opt/<field> for its counters; step. Tensors
        are the live ones, not copies."""
        names = self._names()
        out = {f"params/{n}": p.detach() for n, p in zip(names, self.params)}
        if state.ema_params is not None:
            out.update({f"ema_params/{n}": t for n, t in zip(names, state.ema_params)})
        for f in dataclasses.fields(state.opt_state):
            value = getattr(state.opt_state, f.name)
            if isinstance(value, list):
                out.update({f"opt/{f.name}/{n}": t
                            for n, t in zip(self._opt_names(names), value)})
            elif value is not None:
                out[f"opt/{f.name}"] = torch.tensor(int(value), dtype=torch.int64)
        out["step"] = torch.tensor(int(state.step), dtype=torch.int64)
        return out

    @torch.no_grad()
    def load_state_dict(self, flat: Dict[str, torch.Tensor]) -> TrainState:
        """The inverse of `state_dict`: copies the saved parameters into the
        model and returns the TrainState, every tensor on the trainer's
        device. The names must be exactly those `state_dict` gives for this
        trainer's model and optimizer."""
        state = self.init_state()
        want = set(self.state_dict(state))
        if set(flat) != want:
            flat_saved = any(k.endswith(f"/{FLAT_NAME}") for k in flat)
            if flat_saved != self._flat_optimizer:
                raise ValueError(
                    "checkpoint's optimizer state was written with flatten_optimizer="
                    f"{flat_saved}, this trainer has flatten_optimizer={self._flat_optimizer}: "
                    "the two layouts are not interchangeable")
            missing, extra = sorted(want - set(flat)), sorted(set(flat) - want)
            raise ValueError(f"checkpoint does not fit this trainer: missing {missing[:4]}, "
                             f"unexpected {extra[:4]}")
        names = self._names()

        def copy_list(prefix: str, dst: List[torch.Tensor], keys=names) -> None:
            for n, t in zip(keys, dst):
                t.copy_(flat[f"{prefix}/{n}"])

        copy_list("params", [p.data for p in self.params])
        if state.ema_params is not None:
            copy_list("ema_params", state.ema_params)
        for f in dataclasses.fields(state.opt_state):
            value = getattr(state.opt_state, f.name)
            if isinstance(value, list):
                copy_list(f"opt/{f.name}", value, self._opt_names(names))
            elif value is not None:
                setattr(state.opt_state, f.name, int(flat[f"opt/{f.name}"]))
        state.step = int(flat["step"])
        return state

    @property
    def _flat_optimizer(self) -> bool:
        return self.optimizer is not None and self.optimizer.flatten

    def _opt_names(self, names: List[str]) -> List[str]:
        """Names of the optimizer state's per-parameter lists: one flat
        vector under flatten_optimizer."""
        return [FLAT_NAME] if self._flat_optimizer else names

    # ----------------------------------------------------------- draws

    def _groups(self, causal_flags: Tuple[bool, ...]) -> Dict[bool, List[str]]:
        groups: Dict[bool, List[str]] = {}
        for task, causal in zip(self.tasks, causal_flags):
            groups.setdefault(causal, []).append(task)
        return groups

    def draw_randoms(
        self, generator: torch.Generator, causal_flags: Tuple[bool, ...],
        latents_shape: Sequence[int],
    ) -> StepDraws:
        """Every device draw of one step, from `generator`."""
        b, length, channels = latents_shape
        sub = b // len(self.tasks)
        dev = self.device
        draws = StepDraws({}, {}, {}, {}, {}, {})
        for task in self.tasks:
            if task == "track_gen":
                draws.track_bits[task] = draw_track_bits(generator, self.n_tracks, dev)
            mask_len, start = draw_mask_region(task, length, generator, dev)
            if mask_len is not None:
                draws.mask_len[task] = mask_len
            if start is not None:
                draws.mask_start[task] = start
            if self.is_gdm:
                draws.t[task] = torch.randint(
                    0, self.diffusion.num_timesteps, (sub,), generator=generator, device=dev
                )
        noise_fn = torch.rand if self.diffusion.uniform_noise_compat else torch.randn
        for causal, tasks in sorted(self._groups(causal_flags).items()):
            nb = sub * len(tasks)
            draws.noise[causal] = noise_fn((nb, length, channels), generator=generator, device=dev)
            if not self.is_gdm:
                draws.times[causal] = torch.rand((nb,), generator=generator, device=dev)
            draws.cfg_bits[causal] = rand_bool(
                generator, (nb, 1, 1), self.diffusion.cfg_dropout_proba, dev
            )
        return draws

    # ---------------------------------------------------------- internals

    def _model_fn(self, x, t, **kw):
        """The UNet at the compute dtype, fp32 out."""
        dtype = self.compute_dtype
        kw["embedding"] = kw["embedding"].to(dtype)
        if kw.get("channels_list") is not None:
            kw["channels_list"] = [c.to(dtype) for c in kw["channels_list"]]
        return self.model(x.to(dtype), t, **kw).float()

    def _multi_task_loss(
        self, batch: Dict[str, torch.Tensor], draws: StepDraws,
        causal_flags: Tuple[bool, ...],
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Per-task sub-batches, grouped by causal flag into at most two
        batched forwards (trainer.py:221-322)."""
        latents, text_emb, text_mask = batch["latents"], batch["text_emb"], batch["text_mask"]
        n_tasks = len(self.tasks)
        b, length, _ = latents.shape
        if b % n_tasks:
            raise ValueError(f"batch size {b} is not divisible by the {n_tasks} tasks")
        sub = b // n_tasks
        cd = self.compute_dtype
        pieces = {}
        for i, task in enumerate(self.tasks):
            s = slice(i * sub, (i + 1) * sub)
            sub_lat = latents[s]
            mask = task_mask(task, sub, length, draws.mask_len.get(task),
                             draws.mask_start.get(task), self.n_tracks, latents.device,
                             track_bits=draws.track_bits.get(task))
            masked_input, mask = composer_conditioning(sub_lat, mask, self.track_dim)
            cond = {
                "prompt": (text_emb[s], text_mask[s]),
                "masked_input": masked_input.to(cd),
                "mask": mask.to(cd),
            }
            pieces[task] = (sub_lat.to(cd), assemble_conditioning(
                cond,
                cross_attn_cond_ids=self.cross_attn_cond_ids,
                global_cond_ids=self.global_cond_ids,
                input_concat_ids=self.input_concat_ids,
            ))

        total = 0.0
        per_task: Dict[str, torch.Tensor] = {}
        for causal, tasks in sorted(self._groups(causal_flags).items()):
            x0 = torch.cat([pieces[t][0] for t in tasks], dim=0)
            keys = pieces[tasks[0]][1]
            conditioning = {
                key: None if keys[key] is None
                else torch.cat([pieces[t][1][key] for t in tasks], dim=0)
                for key in keys
            }
            common = dict(noise=draws.noise[causal], cfg_bits=draws.cfg_bits[causal],
                          causal=causal, reduce="none")
            if self.is_gdm:
                t = torch.cat([draws.t[task] for task in tasks], dim=0)
                per_ex = self.diffusion.training_losses(
                    self._model_fn, x0, t, conditioning, **common)
            else:
                per_ex = self.diffusion.training_losses(
                    self._model_fn, x0, conditioning, times=draws.times[causal], **common)
            for j, task in enumerate(tasks):
                loss = per_ex[j * sub:(j + 1) * sub].mean()
                per_task[task] = loss
                total = total + loss
        return total, per_task

    def _apply_optimizer(self, state: TrainState) -> torch.Tensor:
        """One optimizer update from the parameters' .grad; returns the
        global norm of the gradient."""
        params = self.params
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if self._use_fused:
            oc = self.config.optimizer_config
            state.opt_state, gnorm = fused_adamw_apply(
                grads, state.opt_state, params,
                lr=make_lr_schedule(oc), b1=oc.beta_1, b2=oc.beta_2, eps=1e-8,
                weight_decay=oc.weight_decay,
                clip=oc.grad_clip if oc.grad_clip else float(np.finfo(np.float32).max),
            )
            return gnorm
        gnorm = global_norm(grads)
        state.opt_state = self.optimizer.update(grads, state.opt_state, params)
        return gnorm

    def _causal_flags(self, rng_host) -> Tuple[bool, ...]:
        """text_guided's flag is a host coin (trainer.py:442-446)."""
        tg = bool(rng_host.integers(0, 2)) if "text_guided" in self.tasks else False
        return tuple(task_is_causal(t, tg) for t in self.tasks)

    # ------------------------------------------------------------ public

    def train_step(
        self, state: TrainState, batch: Dict[str, torch.Tensor],
        generator: torch.Generator, rng_host,
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One multi-task step: loss, backward, optimizer, EMA. Updates the
        model's parameters and `state` in place and returns both with the
        metrics (device tensors: loss/train, grad_norm, loss_<task>/train)."""
        flags = self._causal_flags(rng_host)
        draws = self.draw_randoms(generator, flags, batch["latents"].shape)
        self.model.train()
        for p in self.params:
            p.grad = None
        with fp32_precision(), annotate("forward_backward"):
            total, per_task = self._multi_task_loss(batch, draws, flags)
            total.backward()
        with annotate("optimizer"):
            gnorm = self._apply_optimizer(state)
        if state.ema_params is not None:
            d = self.ema_decay
            with torch.no_grad():
                torch._foreach_mul_(state.ema_params, d)
                torch._foreach_add_(state.ema_params, self.params, alpha=1.0 - d)
        state.step += 1
        metrics = {
            "loss/train": total.detach(),
            "grad_norm": gnorm,
            **{f"loss_{k}/train": v.detach() for k, v in per_task.items()},
        }
        return state, metrics

    @torch.no_grad()
    def eval_step(
        self, state: TrainState, batch: Dict[str, torch.Tensor],
        generator: torch.Generator, text_guided_causal: bool = False,
    ) -> Dict[str, torch.Tensor]:
        flags = tuple(task_is_causal(t, text_guided_causal) for t in self.tasks)
        draws = self.draw_randoms(generator, flags, batch["latents"].shape)
        self.model.eval()
        with fp32_precision():
            total, per_task = self._multi_task_loss(batch, draws, flags)
        return {"loss/val": total, **{f"loss_{k}/val": v for k, v in per_task.items()}}

    def prepare_batch(self, latents, metadata) -> Dict[str, torch.Tensor]:
        """Run the frozen conditioner over the metadata prompts and put the
        step's inputs on the device. latents: (B, L, C) channels-last."""
        if self.conditioner is None:
            raise ValueError("prepare_batch needs a conditioner")
        text_emb, text_mask = self.conditioner(metadata)["prompt"]
        up = self.config.dataset_config.latents_upload_dtype
        dtype = torch.bfloat16 if up == "bfloat16" else torch.float32
        latents = torch.as_tensor(np.asarray(latents, np.float32)).to(dtype)
        return {
            "latents": latents.to(self.device),
            "text_emb": text_emb.to(self.device, self.compute_dtype),
            "text_mask": text_mask.to(self.device),
        }

    def evaluate(self, state: TrainState, batches: Iterable, seed: int) -> Dict[str, float]:
        """Mean validation losses over `batches` (trainer.py:539-567). With
        text_guided, both of its causal variants run on every batch with the
        same draws and are reported separately."""
        sums: Dict[str, float] = {}
        count = 0
        eval_both = "text_guided" in self.tasks
        for i, (latents, metadata) in enumerate(batches):
            batch = self.prepare_batch(latents, metadata)
            metrics = dict(self.eval_step(state, batch, step_generator(self.device, seed, i)))
            if eval_both:
                causal_m = self.eval_step(state, batch, step_generator(self.device, seed, i),
                                          text_guided_causal=True)
                metrics["loss_text_guided_bidir/val"] = metrics["loss_text_guided/val"]
                metrics["loss_text_guided_causal/val"] = causal_m["loss_text_guided/val"]
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            count += 1
        return {k: v / max(count, 1) for k, v in sums.items()}
