"""Plain fp32 multi-task GDM loss of JEN-1 training, and the draws of a
step, in plain PyTorch and NumPy.

A batch of B latents splits into one sub-batch per task (text_guided,
music_inpaint, music_cont). Each task hides part of its latents: all of
them (text_guided), a contiguous region of 0.2-0.8 of the length at a
drawn start (music_inpaint), or the last such region (music_cont); the
visible latents and the mask are concatenated to the UNet's input. Tasks
with one causal flag (music_cont causal, music_inpaint not, text_guided by
a coin) run as one forward. The loss is the v-objective's mean square over
each example, its mean over each task's examples, summed over the tasks;
the UNet runs with CFG dropout (the text replaced by the null embedding
where a Bernoulli(p) bit is set) and the batched guidance of sampling.

The draws follow the seeded protocol the JEN-1 trainers share: the coin
from numpy's default_rng((seed, step)); every other draw from one
torch.Generator per step (seeded by numpy's SeedSequence([seed, step])),
in this order: per task, the hidden length and (music_inpaint) start, then
its timesteps; then per causal group, False first, its noise and its
dropout bits.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

TASKS = ("text_guided", "music_inpaint", "music_cont")


def gdm_tables(timesteps: int = 1000, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """(sqrt(alpha_bar), sqrt(1 - alpha_bar)) of the linear schedule, fp32."""
    scale = 1000 / timesteps
    betas = np.linspace(scale * 1e-4, scale * 0.02, timesteps,
                        dtype=np.float64).astype(np.float32).astype(np.float64)
    acp = np.cumprod(1.0 - betas)
    return (torch.as_tensor(np.sqrt(acp).astype(np.float32), device=device),
            torch.as_tensor(np.sqrt(1.0 - acp).astype(np.float32), device=device))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    state = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(state)


def causal_flags(seed: int, step: int) -> Dict[str, bool]:
    coin = bool(np.random.default_rng((seed, step)).integers(0, 2))
    return {"text_guided": coin, "music_inpaint": False, "music_cont": True}


def draws(seed: int, step: int, batch: int, length: int, channels: int, timesteps: int,
          drop_p: float, device) -> Dict:
    """Every random draw of one step (module docstring)."""
    g = step_generator(seed, step, device)
    sub = batch // len(TASKS)
    flags = causal_flags(seed, step)
    lo = max(int(0.2 * length), 1)
    hi = max(int(0.8 * length), lo + 1)
    out: Dict = {"flags": flags, "mask": {}, "t": {}, "noise": {}, "drop": {}}
    for task in TASKS:
        idx = torch.arange(length, device=device)[:, None]
        if task == "text_guided":
            mask = torch.zeros((length, 1), device=device)
        else:
            hidden_len = torch.randint(lo, hi + 1, (), generator=g, device=device)
            if task == "music_inpaint":
                u = torch.rand((), generator=g, device=device)
                span = length - hidden_len + 1
                start = torch.minimum((u * span).long(), span - 1)
                mask = (~((idx >= start) & (idx < start + hidden_len))).float()
            else:
                mask = (~(idx >= length - hidden_len)).float()
        out["mask"][task] = mask[None].expand(sub, length, 1)
        out["t"][task] = torch.randint(0, timesteps, (sub,), generator=g, device=device)
    for causal in (False, True):
        n = sub * sum(flags[t] == causal for t in TASKS)
        if n:
            out["noise"][causal] = torch.randn((n, length, channels), generator=g,
                                               device=device)
            out["drop"][causal] = torch.rand((n, 1, 1), generator=g, device=device) < drop_p
    return out


def multitask_loss(unet, latents: torch.Tensor, text_emb: torch.Tensor,
                   text_mask: torch.Tensor, d: Dict, tables) -> Tuple[torch.Tensor, Dict]:
    """(summed loss, per-task losses) of one step on (B, L, C) latents."""
    sqrt_acp, sqrt_1m = tables
    sub = latents.shape[0] // len(TASKS)
    parts = {}
    for i, task in enumerate(TASKS):
        s = slice(i * sub, (i + 1) * sub)
        lat, mask = latents[s], d["mask"][task]
        parts[task] = (lat, torch.cat([lat * mask, mask], dim=-1), text_emb[s], text_mask[s])
    total, per_task = 0.0, {}
    for causal in (False, True):
        tasks = [t for t in TASKS if d["flags"][t] == causal]
        if not tasks:
            continue
        x0, concat, emb, emask = (torch.cat([parts[t][k] for t in tasks]) for k in range(4))
        t = torch.cat([d["t"][task] for task in tasks])
        noise = d["noise"][causal]
        a, s_ = sqrt_acp[t][:, None, None], sqrt_1m[t][:, None, None]
        out = unet(a * x0 + s_ * noise, t.float(), emb, emask, concat, causal=causal,
                   drop=d["drop"][causal])
        per_ex = (out - (a * noise - s_ * x0)).square().mean(dim=(1, 2))
        for j, task in enumerate(tasks):
            per_task[task] = per_ex[j * sub:(j + 1) * sub].mean()
            total = total + per_task[task]
    return total, per_task


def leaf_gap(program: Dict[str, float], reference: Dict[str, float],
             floor: float = 1e-3) -> float:
    """The worst leaf's gap between two sets of per-leaf norms, over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger; leaves whose reference norm is under `floor` of the median
    leaf's move by round-off alone and are left out."""
    ref = np.array([reference[k] for k in reference])
    med = float(np.median(ref))
    worst = 0.0
    for k, r in reference.items():
        if r < floor * med:
            continue
        p = program.get(k, 0.0)
        worst = max(worst, abs(p - r) / max(r, med))
    return worst



def first_update(params: Dict[str, torch.Tensor], grad_mean: Dict[str, torch.Tensor],
                 oc: Dict) -> Dict[str, float]:
    """Per-leaf norms of the parameters' change made by the first update of
    the optimizer chain: the accumulated mean gradient clipped to the
    global norm `grad_clip`, one AdamW step (bias-corrected moments, eps
    1e-8, decoupled weight decay) at the warm-up's first rate."""
    norm = torch.sqrt(sum(g.square().sum() for g in grad_mean.values()))
    factor = 1.0 if norm < oc["grad_clip"] else oc["grad_clip"] / norm
    lr = oc["lr"] * (oc["lr_start_factor"] if oc["lr_total_iters"] > 0 else oc["lr_end_factor"])
    b1, b2 = oc["beta_1"], oc["beta_2"]
    out = {}
    for name, g in grad_mean.items():
        g = g * factor
        m, v = (1 - b1) * g / (1 - b1), (1 - b2) * g * g / (1 - b2)
        upd = m / (v.sqrt() + 1e-8) + oc["weight_decay"] * params[name]
        out[name] = float((lr * upd).norm())
    return out
