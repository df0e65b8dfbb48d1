"""Multi-task latent masks (port of jen1_tpu/train/tasks.py:32-87).

  text_guided   -> all-zero mask (masked_input fully hidden); its causal flag
                   is a coin the trainer draws per step on the host
  music_inpaint -> a contiguous region of length in [0.2L, 0.8L] at a random
                   start is hidden; bidirectional
  music_cont    -> the last region of length in [0.2L, 0.8L] is hidden; causal

One mask is shared across a task's sub-batch. `task_mask` builds a mask
from its drawn length and start, which may be Python ints or 0-d tensors on
the mask's device (so drawing them needs no host sync); `random_task_mask`
draws them from a torch.Generator and builds. `track_gen` (Composer) is not
ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

TASKS = ("text_guided", "music_inpaint", "music_cont")

Scalar = Union[int, torch.Tensor]


def mask_length_bounds(length: int) -> Tuple[int, int]:
    """Inclusive [lo, hi] of a hidden region's length (tasks.py:48-49)."""
    lo = max(int(0.2 * length), 1)
    hi = max(int(0.8 * length), lo + 1)
    return lo, hi


def draw_mask_region(
    task: str, length: int, generator: Optional[torch.Generator], device=None
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(mask_len, start) as 0-d int64 tensors on `device`: mask_len uniform
    on [lo, hi], start uniform on [0, length - mask_len]. None where the
    task draws none (text_guided; music_cont has no start)."""
    if task == "text_guided":
        return None, None
    _check_task(task)
    lo, hi = mask_length_bounds(length)
    mask_len = torch.randint(lo, hi + 1, (), generator=generator, device=device)
    if task == "music_cont":
        return mask_len, None
    u = torch.rand((), generator=generator, device=device)
    span = length - mask_len + 1  # starts 0 .. length - mask_len
    start = torch.minimum((u * span).long(), span - 1)
    return mask_len, start


def task_mask(
    task: str, batch: int, length: int, mask_len: Optional[Scalar] = None,
    start: Optional[Scalar] = None, n_tracks: int = 1, device=None,
) -> torch.Tensor:
    """Mask (batch, length, n_tracks) float32; 1 = keep, 0 = hidden."""
    _check_task(task)
    idx = torch.arange(length, device=device)[:, None]  # (L, 1)
    if task == "text_guided":
        mask = torch.zeros((length, 1), device=device)
    elif task == "music_inpaint":
        hidden = (idx >= start) & (idx < start + mask_len)
        mask = (~hidden).float()
    else:  # music_cont
        mask = (~(idx >= length - mask_len)).float()
    return mask[None].expand(batch, length, n_tracks)


def random_task_mask(
    generator: Optional[torch.Generator], batch: int, length: int, task: str,
    n_tracks: int = 1, device=None,
) -> torch.Tensor:
    """Draw the task's region from `generator` and build its mask."""
    mask_len, start = draw_mask_region(task, length, generator, device)
    return task_mask(task, batch, length, mask_len, start, n_tracks, device)


def task_is_causal(task: str, text_guided_causal: bool) -> bool:
    """Causal flag per task (tasks.py:69-80)."""
    if task == "text_guided":
        return text_guided_causal
    if task == "music_inpaint":
        return False
    if task == "music_cont":
        return True
    if task == "track_gen":
        return False
    raise ValueError(f"unknown task: {task}")


def apply_mask(latents: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked_input, mask) pair for the channel-concat conditioning path."""
    return latents * mask.to(latents.dtype), mask


def _check_task(task: str) -> None:
    if task == "track_gen":
        raise NotImplementedError(
            "the track_gen task needs Composer, which is not ported yet "
            "(ROADMAP Queue 1, 'Rest of training')"
        )
    if task not in TASKS:
        raise ValueError(f"unknown task: {task}")
