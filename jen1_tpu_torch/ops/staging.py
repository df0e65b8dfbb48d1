"""Staged compute weights: one persistent copy of each weight a denoiser
module reads at a compute dtype, in the layout its op reads, in place of a
cast at every call.

The port stores its weights fp32 and computes in bf16, so without staging
every forward casts each weight anew: a Linear's (O, I) weight, a 1x1
conv's and every bias to the activation dtype (`w.to(dtype)`, contiguous),
a k > 1 conv's or a transposed conv's (O, I, K) weight to (O, I, 1, K)
channels-last of that dtype (cuDNN's KRSC order). Under a CUDA graph those
casts are replayed at every step, though the weights do not change.

A module whose forward reads its weights through `compute_weights`
(ops/linear.py's Linear, ops/conv.py's OmniConv1d and Upsample1d) names
them in `staged_reads`: (parameter name, channels-last form) pairs, empty
where the forward reads none (an OmniConv1d that runs its int8 kernel).

`stage(model, dtype)` walks a model, outside any graph (Jen1._sample calls
it at each request's start, before the graphs' key is taken), and gives
each such weight a copy at `dtype` in its form. A copy already there is
refilled in place, at the same address, so that a captured graph reads the
new values, and only where its source changed: the parameter's
`data_ptr()` or its `_version` differs from the copy's record. A rebound
parameter (`p.data = ...`, a new address) gets a new copy, whose address
`weights_key` then carries. A parameter that has its form already (a bf16
weight at bf16 compute, a Linear at fp32) is its own copy and costs no
memory. The in-place writers of the port (`load_state_dict`,
`ckpt/from_jax.py`, LoRA's merge, the mesh's kv interleave, the optimizer)
write through the parameter and so bump `_version`; a write through
`p.data` would not (`.data` has a version counter of its own): the
trainer's restore writes so (train/trainer.py), and a trainer's model is
never staged.

`compute_weights(module, dtype)` gives a forward its weights: the copy when
the module is staged, the copy is current at `dtype` and autograd does not
need the weight; else the cast at the call, as without staging. That
covers a weight that requires grad under grad mode (training), a tensor
subclass (a DTensor of the mesh), an active sequence-parallel context, a
module never staged (the codecs' convs, the conditioners' projections) and
a read at another dtype than the copy's: the UNet's FiLM mapping head and
the DiT's time token and output head read fp32 in a bf16 model, and their
bf16 copies (1.45 MB in `Config()`'s UNet, 15.2 MB in the DiT) stay unread.

The copies live in each module's `_staged` dict, not as parameters or
buffers, so `state_dict()` and strict loads see the keys they always did.

Counters (`COUNTERS`; utils/cuda_graphs.py adds them at every replay):
STAGED, weights a staged module read with no copy made at the call (its
staged copy, or the parameter that has its form already) while autograd
did not need them; CAST, casts and layout copies made at the call by such
modules' forwards; RESTAGED, copies (re)filled by `stage`. They count on
every device. STAGED / (STAGED + CAST) is the staging's engagement share.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from jen1_tpu_torch.parallel import sp as seq

COUNTERS = ("STAGED", "CAST", "RESTAGED")
STAGED = 0
CAST = 0
RESTAGED = 0

# a weight of any other class (a DTensor) is never staged
_PLAIN = (torch.Tensor, nn.Parameter)


def source(w: torch.Tensor, channels_last: bool) -> torch.Tensor:
    """The view of `w` that its form holds: a conv's (O, I, K) as
    (O, I, 1, K)."""
    return w.unsqueeze(2) if channels_last else w


def compute_form(src: torch.Tensor, dtype: torch.dtype, channels_last: bool) -> torch.Tensor:
    """A weight's `source` view as its op reads it at `dtype`, in one copy:
    cast (contiguous), or (O, I, 1, K) channels-last; `src` itself where it
    has that form already."""
    if channels_last:
        return src.to(dtype, memory_format=torch.channels_last)
    return src.to(dtype)


class _Copy:
    """A staged weight: the copy (None: the parameter is its own) and the
    dtype, address and version of the parameter it was filled from."""

    __slots__ = ("tensor", "dtype", "ptr", "version")

    def __init__(self, tensor: Optional[torch.Tensor], dtype: torch.dtype):
        self.tensor, self.dtype = tensor, dtype
        self.ptr = self.version = -1

    def current(self, w: torch.Tensor, dtype: torch.dtype) -> bool:
        return self.dtype == dtype and self.ptr == w.data_ptr() and self.version == w._version


def compute_weights(module: nn.Module, dtype: torch.dtype) -> List[Optional[torch.Tensor]]:
    """The weights `module.staged_reads` names, each in its form at `dtype`
    (None for an absent bias): the staged copy where it serves, else a cast
    at the call (module docstring)."""
    global STAGED, CAST
    copies: Optional[Dict[str, _Copy]] = module.__dict__.get("_staged")
    out = []
    for name, channels_last in module.staged_reads:
        w = module._parameters.get(name)
        if w is None:
            out.append(None)
            continue
        served = (copies is not None and w.__class__ in _PLAIN
                  and not (w.requires_grad and torch.is_grad_enabled())
                  and seq.active() is None)
        if served:
            copy = copies.get(name)
            if copy is not None and copy.current(w, dtype):
                STAGED += 1
                out.append(source(w, channels_last) if copy.tensor is None else copy.tensor)
                continue
        src = source(w, channels_last)
        t = compute_form(src, dtype, channels_last)
        if t is not src:
            CAST += 1
        elif served:
            STAGED += 1
        out.append(t)
    return out


def _staged_modules(model: nn.Module) -> List[nn.Module]:
    """The modules of `model` that read weights through `compute_weights`,
    listed once per model: a module added later is not staged and casts at
    each call, as before."""
    found = model.__dict__.get("_staged_modules")
    if found is None:
        found = model.__dict__["_staged_modules"] = [
            m for m in model.modules() if getattr(type(m), "staged_reads", None) is not None]
    return found


@torch.no_grad()
def stage(model: nn.Module, dtype: torch.dtype) -> None:
    """Give every weight that `model`'s modules read through
    `compute_weights` a current copy at `dtype` (module docstring); drop
    the copies of weights no longer read (an int8 kernel attached, a
    DTensor)."""
    global RESTAGED
    for module in _staged_modules(model):
        copies: Dict[str, _Copy] = module.__dict__.setdefault("_staged", {})
        wanted = set()
        for name, channels_last in module.staged_reads:
            w = module._parameters.get(name)
            if w is None or w.__class__ not in _PLAIN:
                continue
            wanted.add(name)
            copy = copies.get(name)
            if copy is not None and copy.current(w, dtype):
                continue
            src = source(w, channels_last)
            if (copy is not None and copy.tensor is not None and copy.dtype == dtype
                    and copy.ptr == w.data_ptr()):
                # written in place: refill at the same address
                copy.tensor.copy_(src)
            else:
                t = compute_form(src, dtype, channels_last)
                copy = copies[name] = _Copy(None if t is src else t, dtype)
            if copy.tensor is not None:
                RESTAGED += 1
            copy.ptr, copy.version = w.data_ptr(), w._version
        if len(copies) > len(wanted):
            for name in set(copies) - wanted:
                del copies[name]


def staged_copies(module: nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """(parameter name, copy) of `module`'s staged copies, those that are
    not the parameter itself."""
    return [(name, copy.tensor) for name, copy in module.__dict__.get("_staged", {}).items()
            if copy.tensor is not None]
