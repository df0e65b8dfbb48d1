"""Checkpoint lifecycle in a torch format (port of jen1_tpu/ckpt/checkpoint.py,
which is Orbax-backed).

One directory per step under the manager's directory:

    <directory>/<step>/state.pt    the state, a flat {name: tensor} dict
                                   written by torch.save
    <directory>/<step>/meta.json   {"loss", "learning_rate", **extra_meta}

A step is written under a temporary name and `os.replace`d into place, so a
save that dies half-way leaves no half-checkpoint: the steps before it stay
readable. A step is read memory-mapped, so a caller that keeps some of its
tensors (Jen1 keeps `params/` or `ema_params/`) reads only those.
`load_torch_file` is the port's one loader of local torch files, with
`weights_only=True` (tensors and plain containers only): checkpoint steps,
the reference .pth, and the T5 and EnCodec state dicts.

Retention follows the JAX manager's Orbax options: with `keep_best` the
`max_to_keep` lowest-loss steps stay (Orbax's BestN, ties kept in step
order), else the `max_to_keep` most recent (LatestN); `best_step` is the
lowest-loss step, or the latest without `keep_best`. A JAX (Orbax) run
directory is not readable here.

Under torch.distributed every rank calls `save` with the same (gathered,
full) state: rank 0 writes and a barrier holds the others until the step
is in place. Every rank reads.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

STATE_FILE = "state.pt"
META_FILE = "meta.json"
_TMP_PREFIX = ".tmp-"


def unwrap_state_dict(obj: Any) -> Any:
    """The state dict inside `obj`: a `{"state_dict": ...}` wrapper
    (jen1_tpu/conditioning/conditioners.py:300-306) and then a
    `{"model": ...}` one (a reference training checkpoint) are stepped
    through."""
    for key in ("state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    return obj


def load_torch_file(path: str, map_location="cpu", *, unwrap: bool = False,
                    mmap: bool = False) -> Any:
    """The object `torch.save` wrote to the local file `path`, read with
    weights_only=True (tensors, numbers and plain containers only). With
    `unwrap`, the state dict inside it (`unwrap_state_dict`). With `mmap`
    the file is memory-mapped, so a tensor's bytes are read when it is
    used; that needs torch's zip format, which `CheckpointManager.save`
    writes."""
    obj = torch.load(path, map_location=map_location, weights_only=True, mmap=mmap)
    return unwrap_state_dict(obj) if unwrap else obj


def is_step_dir(path: str) -> bool:
    """True for a step directory this module wrote."""
    name = os.path.basename(os.path.normpath(path))
    return (name.isdigit() and os.path.isfile(os.path.join(path, STATE_FILE))
            and os.path.isfile(os.path.join(path, META_FILE)))


def has_checkpoints(directory: str) -> bool:
    """True when `directory` holds at least one step in this format."""
    return os.path.isdir(directory) and any(
        is_step_dir(os.path.join(directory, n)) for n in os.listdir(directory))


def unreadable_checkpoint(path: str) -> ValueError:
    """The error for a path that is neither a checkpoint directory of this
    format nor a reference file: a JAX (Orbax) run directory, say."""
    return ValueError(
        f"{path!r} is not a checkpoint jen1_tpu_torch reads: give a checkpoint "
        "directory of this package (<dir>/<step>/state.pt and meta.json, written by "
        "jen1_tpu_torch.ckpt.checkpoint.CheckpointManager) or a reference JEN-1 "
        "PyTorch file (.pth, .pt or .bin). JAX (Orbax) run directories are not "
        "readable here.")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, keep_best: bool = True):
        """keep_best=True retains the k lowest-loss checkpoints, False the k
        most recent (k = max_to_keep)."""
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.keep_best = keep_best

    # ------------------------------------------------------------- steps

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if is_step_dir(os.path.join(self.directory, n)))

    def _loss(self, step: int) -> float:
        with open(os.path.join(self._step_dir(step), META_FILE)) as f:
            return float(json.load(f)["loss"])

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        if not self.keep_best:
            return self.latest_step()
        ranked = self._ranked(self.all_steps())
        return ranked[-1] if ranked else None

    def _ranked(self, steps: List[int]) -> List[int]:
        """Steps from the worst loss to the best (Orbax sorts the same way:
        descending loss, a stable sort, so equal losses stay in step order)."""
        return sorted(steps, key=self._loss, reverse=True)

    # -------------------------------------------------------------- save

    def save(self, step: int, state: Dict[str, torch.Tensor], *, loss: float,
             learning_rate: Optional[float] = None,
             extra_meta: Optional[Dict[str, Any]] = None) -> None:
        """Write `state` (a flat {name: tensor} dict) as step `step` with its
        loss and metadata, then drop the steps that retention lets go. Under
        torch.distributed every rank calls this and rank 0 writes."""
        distributed = dist.is_available() and dist.is_initialized()
        try:
            if not distributed or dist.get_rank() == 0:
                self._write(step, state, loss, learning_rate, extra_meta)
        finally:
            if distributed:
                dist.barrier()

    def _write(self, step: int, state: Dict[str, torch.Tensor], loss: float,
               learning_rate: Optional[float], extra_meta: Optional[Dict[str, Any]]) -> None:
        final = self._step_dir(step)
        if os.path.exists(final):
            raise ValueError(f"checkpoint step {step} already exists in {self.directory}")
        meta: Dict[str, Any] = {"loss": float(loss)}
        if learning_rate is not None:
            meta["learning_rate"] = float(learning_rate)
        meta.update(extra_meta or {})
        tmp = os.path.join(self.directory, f"{_TMP_PREFIX}{int(step)}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            tensors = {k: v.detach() for k, v in state.items()}
            with open(os.path.join(tmp, STATE_FILE), "wb") as f:
                torch.save(tensors, f)
                f.flush()
                os.fsync(f.fileno())
            with open(os.path.join(tmp, META_FILE), "w") as f:
                json.dump(meta, f)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._remove_old()

    def _remove_old(self) -> None:
        steps = self.all_steps()
        if len(steps) <= self.max_to_keep:
            return
        keep = set(self._ranked(steps)[-self.max_to_keep:] if self.keep_best
                   else steps[-self.max_to_keep:])
        for step in steps:
            if step not in keep:
                shutil.rmtree(self._step_dir(step))

    # ----------------------------------------------------------- restore

    def restore(self, step: Optional[int] = None, map_location="cpu"
                ) -> Optional[Tuple[Dict[str, torch.Tensor], Dict[str, Any]]]:
        """(state, meta) at `step` (default: the latest), tensors on
        `map_location`; None when there is no checkpoint. The state file is
        memory-mapped: a caller that uses only some tensors reads only those."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        path = self._step_dir(step)
        if not is_step_dir(path):
            raise FileNotFoundError(f"no checkpoint step {step} in {self.directory}")
        state = load_torch_file(os.path.join(path, STATE_FILE), map_location, mmap=True)
        with open(os.path.join(path, META_FILE)) as f:
            meta = json.load(f)
        return state, meta

    def restore_best(self, map_location="cpu"):
        step = self.best_step()
        return None if step is None else self.restore(step, map_location)

    def restore_partial(self, template: Dict[str, torch.Tensor],
                        step: Optional[int] = None) -> Tuple[Dict[str, torch.Tensor], List[str]]:
        """A copy of `template` whose tensors are replaced by the saved ones
        of the same name and shape (cast to the template's dtype and device),
        and the names that kept the template's tensor: the reference's
        `load_model_diffsize`, for finetuning across shapes."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint to restore in {self.directory}")
        saved, _ = self.restore(step)
        merged, skipped = {}, []
        for name, leaf in template.items():
            value = saved.get(name)
            if value is not None and tuple(value.shape) == tuple(leaf.shape):
                merged[name] = value.to(device=leaf.device, dtype=leaf.dtype)
            else:
                merged[name] = leaf
                skipped.append(name)
        return merged, skipped
