"""CUDA graphs of sampler steps: the port's counterpart of the JAX package's
compiled samplers (`sampler_mode` "scan" / "stepwise",
jen1_tpu/diffusion/gdm.py:392-560, vdm.py:188-252) and of the compiled
program that `Jen1._sample_cache` memoizes
(jen1_tpu/api/generation.py:609-650); within one process it also stands in
for what utils/compile_cache.py buys the JAX package.

A `StepProgram` is called with a function of no arguments that reads and
writes tensors its caller holds (static buffers): one sampler step, the
same function at every call. On the card its first call runs the function
eagerly on a side stream, on those buffers (the warm-up: the kernel library
is built and loaded, cuBLAS and cuDNN set up their handles and workspaces),
which does that step's work, and then captures it as a
`torch.cuda.CUDAGraph` on the same stream (one per device for the
process); every later call replays the graph. On the CPU, and inside `disable_graphs()`, every call runs the
function eagerly on the same buffers. A failed capture raises: on the card
nothing falls back to the eager step. It leaves the card as it found it
(`_end_failed_capture`), so that a service goes on after one failed request.
The program keeps no reference to the
function, so a sampler that owns its programs forms no reference cycle and
frees its graphs and buffers as soon as it is dropped.

The programs of one owner (a `Jen1`) share one memory pool (`GraphSet`),
since only one of them runs at a time; after a failed capture, the ones
captured later share a second. Captures use the thread-local capture
mode, so that other threads (a service's completers copying results to the
host) may call the CUDA API while one thread captures.

Launch counters. The kernel wrappers count their launches in Python
(`COUNTERS` of ops/flash_attention.py, ops/int8_matmul.py and ops/norm.py,
whose `PLAIN_CUDA` counts its plain routes on the card, the DiT's
forwards and self-attention routes in models/dit.py, and the weights read
from staged copies or cast at the call in ops/staging.py), which under a
graph runs only at capture. A program records the counters' deltas over its
capture, takes them back (a capture launches nothing) and adds them at every
replay, so the counts stay the kernels' launches on the card.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import torch

_DISABLED = 0
_DISABLED_LOCK = threading.Lock()
# one side stream per device for every warm-up and capture: cuBLAS keeps a
# workspace per stream for the life of the process, so a stream per program
# would leave one behind for every capture
_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}
_SIDE_STREAMS_LOCK = threading.Lock()


@contextlib.contextmanager
def disable_graphs():
    """Run every StepProgram eagerly while inside (the counterpart of
    `jax.disable_jit()`). Process-wide, so that it reaches a service's
    worker threads; nests, and restores on exit."""
    global _DISABLED
    with _DISABLED_LOCK:
        _DISABLED += 1
    try:
        yield
    finally:
        with _DISABLED_LOCK:
            _DISABLED -= 1


def graphs_enabled() -> bool:
    """False inside `disable_graphs()`."""
    return _DISABLED == 0


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    with _SIDE_STREAMS_LOCK:
        if device not in _SIDE_STREAMS:
            _SIDE_STREAMS[device] = torch.cuda.Stream(device)
        return _SIDE_STREAMS[device]


def _counters() -> Dict[Tuple[object, str], int]:
    from jen1_tpu_torch.models import dit
    from jen1_tpu_torch.ops import flash_attention, int8_matmul, norm, staging

    return {(mod, name): getattr(mod, name)
            for mod in (flash_attention, int8_matmul, norm, dit, staging)
            for name in mod.COUNTERS}


def _end_failed_capture(stream: "torch.cuda.Stream", side: "torch.cuda.Stream", pool) -> None:
    """Undo what a capture leaves behind when ending it raised (a step that
    synchronised invalidates it): torch.cuda.graph does not restore the
    current stream, which stays `side`; the caching allocator goes on
    recording into `pool` as if the capture ran, and while it does, blocks
    freed with stream uses are never reused; and the device's default
    generator stays marked as capturing, so that every later random draw on
    the device raises ("Offset increment outside graph capture"). Restores
    `stream`, ends the allocator's recording into `pool` and releases the
    capture's hold on it (PyTorch's own calls for a pool, as
    `torch.cuda.use_mem_pool` makes them), and ends the generator's capture
    by one that succeeds: a graph of one in-place add on `side`, in a pool
    of its own, dropped at once. `pool` still refuses later captures
    (torch 2.11), so the caller captures into another."""
    device = stream.device.index
    torch.cuda.set_stream(stream)
    torch._C._cuda_endAllocateToPool(device, pool)
    torch._C._cuda_releasePool(device, pool)
    tick = torch.zeros(1, device=stream.device)
    with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=side,
                          capture_error_mode="thread_local"):
        tick.add_(1)


class GraphSet:
    """The graphs of one owner: the memory pool they share, and how many
    were captured and replayed and the seconds their captures took."""

    def __init__(self):
        self._pool = None
        self.captures = 0
        self.replays = 0
        self.capture_seconds = 0.0

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def new_pool(self) -> None:
        """Capture from now on into a fresh pool; the graphs captured so far
        keep theirs."""
        self._pool = None


class StepProgram:
    """A step as a CUDA graph on the card when `graphs` is given (module
    docstring); eager on the CPU, inside `disable_graphs()` and without
    `graphs`."""

    def __init__(self, device, graphs: Optional[GraphSet]):
        self.device = torch.device(device)
        self.graphs = graphs
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._deltas: Dict[Tuple[object, str], int] = {}

    def __call__(self, fn: Callable[[], None]) -> None:
        """Run the step `fn`: eagerly, or by capturing it at the first call
        on the card and replaying the graph at every later one."""
        if self.graphs is None or self.device.type != "cuda" or not graphs_enabled():
            fn()
        elif self.graph is None:
            self._warm_up_and_capture(fn)
        else:
            self.graph.replay()
            for (mod, name), n in self._deltas.items():
                setattr(mod, name, getattr(mod, name) + n)
            self.graphs.replays += 1

    def _warm_up_and_capture(self, fn: Callable[[], None]) -> None:
        current = torch.cuda.current_stream(self.device)
        side = _side_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            fn()  # the warm-up is this call's step
        current.wait_stream(side)
        t0 = time.perf_counter()
        before = _counters()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.graphs.pool(), stream=side,
                                  capture_error_mode="thread_local"):
                fn()
        except BaseException:
            # `side` still current: torch.cuda.graph's exit did not end the capture
            if torch.cuda.current_stream(self.device) == side:
                _end_failed_capture(current, side, self.graphs.pool())
                self.graphs.new_pool()
            raise
        finally:
            after = _counters()
            for (mod, name), n in before.items():
                setattr(mod, name, n)
        self._deltas = {k: after[k] - n for k, n in before.items() if after[k] != n}
        self.graph = graph
        self.graphs.captures += 1
        self.graphs.capture_seconds += time.perf_counter() - t0
