"""Serving for Jen1: an HTTP API over a micro-batching dispatcher (port of
jen1_tpu/serve.py).

    python -m jen1_tpu_torch.serve --config cfg.json --port 8000
    curl -X POST localhost:8000/generate -d '{"prompt": "warm jazz"}' -o out.wav

  * Static batch shapes: requests are grouped by (seconds, steps, use_gdm)
    and padded to a fixed `max_batch` with null prompts; the padding lanes
    are sliced off on the device, before the result crosses to the host.
  * Micro-batching: one dispatcher thread drains the request queue, waits
    up to `max_wait_ms` for co-batchable requests and runs the card at up
    to `max_batch` requests per batch.
  * Pipelined completion: the dispatcher calls
    `generate(..., output_transport="device")` under the device lock and
    hands the tensor to a completer thread, which fetches it (`.cpu()`) and
    answers the requests while the dispatcher forms the next batch.
  * HTTP (stdlib ThreadingHTTPServer): POST /generate with a JSON body
    {"prompt": str, "seconds": float, "steps": int, "seed": int,
    "use_gdm": bool, "format": "wav"|"npy"} returns audio/wav (16-bit PCM)
    or an .npy array; POST /generate_long {"prompt", "total_seconds",
    "window_seconds", "context_seconds", "steps", "seed"} streams s16le PCM
    as each window completes; GET /healthz returns readiness and stats.
  * Overload: admission is bounded by `max_queue`; beyond it `submit`
    raises ServiceOverloaded and HTTP answers 503 with a Retry-After
    estimated from the EWMA of batch walls. `close()` drains: new work is
    refused, admitted work completes, then the threads stop.
  * Seeds: a request with an explicit seed is never co-batched; it runs as
    lane 0 of its own padded batch, so seed=N reproduces
    `generate(prompts padded to max_batch, seed=N)[0]`. Default-seed
    requests (seed=-1) co-batch freely.

The service's default diffusion is GDM DDIM, as in the JAX package. JAX's
`rng_impl` (the TPU hardware RNG) and `--rng` have no counterpart: every
draw here comes from a `torch.Generator` seeded by the request, and
`GenerationService(rng_impl=...)` is a TypeError like any unknown argument.
"""

from __future__ import annotations

import io
import itertools
import json
import math
import queue
import threading
import time
import wave
from collections import deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import torch


class ServiceOverloaded(RuntimeError):
    """Admission queue is full; retry after `retry_after` seconds."""

    def __init__(self, retry_after: float):
        super().__init__(f"service overloaded, retry after {retry_after:.0f}s")
        self.retry_after = retry_after


class ServiceClosed(RuntimeError):
    """The service is draining or shut down and accepts no new work."""


_REQ_IDS = itertools.count()

# dispatched batches that may wait for a completer before the dispatcher
# blocks: each holds its audio on the device until it is fetched
PIPELINE_DEPTH = 2


@dataclass
class _Request:
    prompt: str
    seconds: float
    steps: int
    seed: int
    use_gdm: bool
    uid: int = field(default_factory=lambda: next(_REQ_IDS))
    done: threading.Event = field(default_factory=threading.Event)
    audio: Optional[np.ndarray] = None  # (ch, T)
    error: Optional[str] = None
    # set by submit() on timeout: the dispatcher drops the request at batch
    # formation instead of spending a device batch on audio nobody reads
    cancelled: bool = False
    # _finish() ran (guarded by _depth_lock): the depth slot is released once
    finished: bool = False

    @property
    def batch_key(self):
        # an explicit seed makes the key unique: the request runs as lane 0
        # of its own padded batch (module docstring, "Seeds")
        seed_key = None if self.seed == -1 else self.uid
        return (float(self.seconds), int(self.steps), bool(self.use_gdm), seed_key)


def to_host(audio) -> np.ndarray:
    """A batch's audio as a numpy array; a tensor is copied off its device."""
    if isinstance(audio, torch.Tensor):
        return audio.cpu().numpy()
    return np.asarray(audio)


class GenerationService:
    """Micro-batching dispatcher over a Jen1 model (jen1_tpu/serve.py:96-479).
    HTTP-independent: call `submit()` from any frontend; one background
    thread owns the device, `n_completers` threads fetch and deliver."""

    def __init__(
        self,
        jen1,
        max_batch: int = 4,
        max_wait_ms: float = 200.0,
        default_seconds: float = 30.0,
        default_steps: int = 100,
        max_queue: int = 32,
        sampler_mode: str = "scan",
        default_use_gdm: bool = True,
        output_dtype: str = "float32",
        n_completers: int = 2,
    ):
        self.jen1 = jen1
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.default_seconds = default_seconds
        self.default_steps = default_steps
        self.max_queue = int(max_queue)
        # 'scan' and 'stepwise' are one DDIM loop here; 'dpm++' runs
        # DPM-Solver++(2M)
        self.sampler_mode = str(sampler_mode)
        # GDM DDIM by default, as the JAX service; per-request use_gdm wins
        self.default_use_gdm = bool(default_use_gdm)
        # 'int16' converts to 16-bit PCM on the device and halves the fetch;
        # submit() then returns int16 arrays
        self.output_dtype = str(output_dtype)
        self.stats: Dict[str, Any] = {
            "requests": 0, "batches": 0, "padded_lanes": 0, "errors": 0,
            "rejected": 0, "streams": 0, "busy": False,
        }
        # guards every read-modify-write of `stats` and of the batch-wall
        # EWMA: completers, the dispatcher and submitters update them at once
        self._stats_lock = threading.Lock()
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        # requests pulled off the queue but not co-batchable with the batch
        # being formed; consulted before the queue, so a bumped request is
        # first in line for the next batch of its key
        self._pending: "deque[_Request]" = deque()
        # admitted-but-not-finished count, bounded by max_queue
        self._depth = 0
        self._depth_lock = threading.Lock()
        # EWMA of batch walls (dispatch to fetched), for Retry-After
        self._batch_secs_ewma = 1.0
        # one generate() at a time: batches and long-form streams share the
        # device through this lock, interleaving at window granularity
        self._device_lock = threading.Lock()
        self._draining = threading.Event()
        self._stop = threading.Event()
        # at most PIPELINE_DEPTH dispatched batches wait for a completer
        self._inflight: "queue.Queue" = queue.Queue(maxsize=PIPELINE_DEPTH)
        # host-side phase seconds summed over all batches: generate()'s
        # last_timings phases, 'collect' (batch formation) and 'fetch'
        self.phase_totals: Dict[str, float] = {}
        self._phase_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="jen1-dispatcher", daemon=True)
        self._completers = [
            threading.Thread(target=self._complete_loop, name=f"jen1-completer-{i}",
                             daemon=True)
            for i in range(max(1, int(n_completers)))
        ]
        self._thread.start()
        for c in self._completers:
            c.start()

    @property
    def queue_depth(self) -> int:
        with self._depth_lock:
            return self._depth

    def _bump(self, **counts: int) -> None:
        with self._stats_lock:
            for k, v in counts.items():
                self.stats[k] += v

    def _retry_after(self, depth: int) -> float:
        # a full queue drains in ~depth / max_batch batches
        batches = math.ceil(max(1, depth) / self.max_batch)
        with self._stats_lock:
            return max(1.0, batches * self._batch_secs_ewma)

    # ------------------------------------------------------------- public

    def submit(
        self,
        prompt: str,
        seconds: Optional[float] = None,
        steps: Optional[int] = None,
        seed: int = -1,
        use_gdm: Optional[bool] = None,
        timeout: Optional[float] = None,
    ) -> np.ndarray:
        """Blocking: returns (channels, samples) float32 (int16 with
        output_dtype='int16'). Raises RuntimeError on generation failure,
        TimeoutError when the deadline passes, ServiceOverloaded when the
        admission queue is full, ServiceClosed after close()."""
        # the draining check and the admission are one atomic section:
        # close() sets _draining under the same lock, so an admitted request
        # is counted before the drain loop reads the depth
        with self._depth_lock:
            if self._draining.is_set():
                raise ServiceClosed("service is shutting down")
            depth = self._depth
            admitted = depth < self.max_queue
            if admitted:
                self._depth += 1
        if not admitted:
            self._bump(rejected=1)
            raise ServiceOverloaded(self._retry_after(depth))
        req = _Request(
            prompt=str(prompt),
            seconds=float(seconds if seconds is not None else self.default_seconds),
            steps=int(steps if steps is not None else self.default_steps),
            seed=int(seed),
            use_gdm=bool(use_gdm if use_gdm is not None else self.default_use_gdm),
        )
        self._bump(requests=1)
        self._queue.put(req)
        if not req.done.wait(timeout):
            # abandoned: the dispatcher releases the depth slot and skips the
            # request at batch formation
            req.cancelled = True
            raise TimeoutError("generation did not complete in time")
        if req.error is not None:
            raise RuntimeError(req.error)
        return req.audio

    def submit_stream(
        self,
        prompt: str,
        total_seconds: float,
        *,
        window_seconds: Optional[float] = None,
        context_seconds: Optional[float] = None,
        steps: Optional[int] = None,
        seed: int = -1,
        use_gdm: Optional[bool] = None,
    ):
        """Long-form streaming: yields (channels, n_new) float32 chunks as
        each window completes (Jen1.generate_long_stream). The device lock is
        held per window, so queued short requests interleave between
        windows."""
        if self._draining.is_set():
            raise ServiceClosed("service is shutting down")
        window = float(window_seconds if window_seconds is not None else self.default_seconds)
        ctx = float(context_seconds if context_seconds is not None else window / 3.0)
        self._bump(streams=1)
        it = iter(self.jen1.generate_long_stream(
            str(prompt), float(total_seconds),
            window_seconds=window, context_seconds=ctx, seed=int(seed),
            steps=int(steps if steps is not None else self.default_steps),
            batch_size=1,
            use_gdm=bool(use_gdm if use_gdm is not None else self.default_use_gdm),
            sampler_mode=self.sampler_mode,
        ))
        while True:
            with self._device_lock:
                try:
                    chunk = next(it)
                except StopIteration:
                    return
            yield np.asarray(chunk)[0]  # (ch, n_new)

    def close(self, drain_timeout: float = 60.0) -> None:
        """Graceful shutdown: refuse new work, let admitted requests finish
        (up to drain_timeout), then stop the threads. Anything still queued
        afterwards fails with an error instead of leaving its submitter
        blocked."""
        with self._depth_lock:  # atomic with submit's admission section
            self._draining.set()
        deadline = time.time() + drain_timeout
        while self.queue_depth > 0 and time.time() < deadline:
            time.sleep(0.02)
        self._stop.set()
        self._thread.join(timeout=5.0)
        # the dispatcher's exit put one sentinel per completer
        for c in self._completers:
            c.join(timeout=drain_timeout)
        leftovers: List[_Request] = list(self._pending)
        self._pending.clear()
        while True:
            try:
                leftovers.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for req in leftovers:
            self._finish(req, error="service closed while request queued")

    # ---------------------------------------------------------- internals

    def _finish(self, req: _Request, error: Optional[str] = None) -> None:
        # idempotent: close()'s leftover sweep can race a draining
        # dispatcher; the depth slot is released exactly once
        with self._depth_lock:
            if req.finished:
                return
            req.finished = True
            self._depth -= 1
        if error is not None:
            req.error = error
        req.done.set()

    def _fail(self, batch: List[_Request], e: Exception) -> None:
        self._bump(errors=1)
        for req in batch:
            if not req.done.is_set():
                self._finish(req, error=f"{type(e).__name__}: {e}")

    def _next_request(self, timeout: float) -> Optional[_Request]:
        if self._pending:
            return self._pending.popleft()
        try:
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def _collect_batch(self) -> List[_Request]:
        """Block for one request, then drain co-batchable ones (same
        batch_key) for up to max_wait_ms. Bumped different-key requests go
        to the head-of-line `_pending` deque. Requests whose submitter timed
        out are finished and dropped here, before any device time is spent
        on them."""
        for req in [r for r in self._pending if r.cancelled]:
            self._pending.remove(req)
            self._finish(req, error="cancelled (submitter timed out)")
        first = self._next_request(timeout=0.1)
        if first is None or first.cancelled:
            if first is not None:
                self._finish(first, error="cancelled (submitter timed out)")
            return []
        batch = [first]
        # older bumped requests of the same key ride this batch first
        for req in list(self._pending):
            if len(batch) >= self.max_batch:
                break
            if req.batch_key == first.batch_key:
                self._pending.remove(req)
                batch.append(req)
        deadline = time.time() + self.max_wait_ms / 1e3
        while len(batch) < self.max_batch:
            remaining = deadline - time.time()
            if remaining <= 0:
                break
            try:
                req = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if req.cancelled:
                self._finish(req, error="cancelled (submitter timed out)")
            elif req.batch_key == first.batch_key:
                batch.append(req)
            else:
                self._pending.append(req)  # another shape: a later batch
        return batch

    def _add_phases(self, timings: Dict[str, float]) -> None:
        with self._phase_lock:
            for k, v in timings.items():
                self.phase_totals[k] = self.phase_totals.get(k, 0.0) + v

    def _dispatch_loop(self) -> None:
        while True:
            if self._stop.is_set() and not self._pending and self._queue.empty():
                for _ in self._completers:  # one shutdown sentinel each
                    self._inflight.put(None)
                return
            t_c0 = time.perf_counter()
            batch = self._collect_batch()
            if not batch:
                continue
            self._add_phases({"collect": time.perf_counter() - t_c0})
            self.stats["busy"] = True
            t0 = time.time()
            try:
                with self._device_lock:
                    audio = self._dispatch_batch(batch)
            except Exception as e:  # noqa: BLE001 - reported to the callers
                self._fail(batch, e)
                self.stats["busy"] = False
                continue
            # blocks only while PIPELINE_DEPTH batches wait for a completer
            self._inflight.put((batch, audio, t0))
            self.stats["busy"] = False

    def _complete_loop(self) -> None:
        """The device-to-host side: fetches each dispatched batch and
        delivers its responses while the dispatcher forms the next batch."""
        while True:
            item = self._inflight.get()
            if item is None:
                return
            batch, audio_dev, t0 = item
            try:
                t_f0 = time.perf_counter()
                audio = to_host(audio_dev)  # waits for the decode, then copies
                self._add_phases({"fetch": time.perf_counter() - t_f0})
                with self._stats_lock:
                    self._batch_secs_ewma = 0.7 * self._batch_secs_ewma + 0.3 * (time.time() - t0)
                    self.stats["batches"] += 1
                    self.stats["padded_lanes"] += self.max_batch - len(batch)
                for lane, req in enumerate(batch):
                    req.audio = audio[lane]
                    self._finish(req)
            except Exception as e:  # noqa: BLE001 - reported to the callers
                self._fail(batch, e)

    def _dispatch_batch(self, batch: List[_Request]):
        """Pad to the fixed max_batch and run generation, returning the
        result on the device, the padding lanes sliced off."""
        n_pad = self.max_batch - len(batch)
        prompts = [r.prompt for r in batch] + [""] * n_pad
        first = batch[0]
        # an explicit seed implies a singleton batch (batch_key holds the
        # request uid): the seeded request is lane 0 of its padded batch
        audio = self.jen1.generate(
            prompts,
            seed=first.seed,
            steps=first.steps,
            batch_size=self.max_batch,
            seconds=first.seconds,
            use_gdm=first.use_gdm,
            sampler_mode=self.sampler_mode,
            output_dtype=self.output_dtype,
            output_transport="device",
        )  # (max_batch, ch, T)
        if n_pad and isinstance(audio, torch.Tensor):
            # the padding lanes never cross to the host
            audio = audio[: len(batch)]
        self._add_phases(getattr(self.jen1, "last_timings", {}) or {})
        return audio


def _wav_bytes(audio_ct: np.ndarray, sample_rate: int) -> bytes:
    """(channels, T) float32 in [-1, 1], or int16 PCM, as 16-bit WAV bytes."""
    if audio_ct.dtype == np.int16:
        ints = audio_ct.T.astype("<i2")
    else:
        ints = (np.clip(audio_ct.T.astype(np.float32), -1.0, 1.0) * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(ints.shape[1])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(ints.tobytes())
    return buf.getvalue()


def _json_error(message: str) -> bytes:
    return json.dumps({"error": message}).encode()


def make_handler(service: GenerationService, sample_rate: int):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 for the chunked /generate_long stream; every other
        # response carries an exact Content-Length
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str,
                  headers: Optional[Dict[str, str]] = None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _payload(self, *required: str):
            """The JSON body, or None after a 400 when it lacks a field."""
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                missing = [key for key in required if key not in payload]
                if missing:
                    raise KeyError(missing[0])
                return payload
            except (KeyError, ValueError, TypeError) as e:
                self._send(400, _json_error(f"bad request: {e}"), "application/json")
                return None

        def do_GET(self):
            if self.path == "/healthz":
                body = json.dumps({
                    "ok": not service._draining.is_set(),
                    "queue_depth": service.queue_depth,
                    "max_queue": service.max_queue,
                    **service.stats,
                }).encode()
                self._send(200, body, "application/json")
            else:
                self._send(404, _json_error("not found"), "application/json")

        def do_POST(self):
            if self.path == "/generate_long":
                self._generate_long()
                return
            if self.path != "/generate":
                self._send(404, _json_error("not found"), "application/json")
                return
            payload = self._payload("prompt")
            if payload is None:
                return
            try:
                audio = service.submit(
                    payload["prompt"],
                    seconds=payload.get("seconds"),
                    steps=payload.get("steps"),
                    seed=int(payload.get("seed", -1)),
                    use_gdm=payload.get("use_gdm"),  # None: the service default
                    timeout=float(payload.get("timeout", 600.0)),
                )
            except TimeoutError:
                self._send(504, _json_error("generation timed out"), "application/json")
                return
            except ServiceOverloaded as e:
                self._send(503, _json_error(str(e)), "application/json",
                           headers={"Retry-After": str(int(math.ceil(e.retry_after)))})
                return
            except ServiceClosed as e:
                self._send(503, _json_error(str(e)), "application/json")
                return
            except RuntimeError as e:
                self._send(500, _json_error(str(e)), "application/json")
                return
            if payload.get("format", "wav") == "npy":
                buf = io.BytesIO()
                np.save(buf, audio)
                self._send(200, buf.getvalue(), "application/octet-stream")
            else:
                self._send(200, _wav_bytes(audio, sample_rate), "audio/wav")

        def _generate_long(self):
            """Long-form audio as chunked little-endian 16-bit PCM
            (audio/L16, declared s16le in X-Audio-Format): the first bytes
            leave after the first window, not after the whole clip."""
            payload = self._payload("prompt", "total_seconds")
            if payload is None:
                return
            try:
                total_seconds = float(payload["total_seconds"])
            except (TypeError, ValueError) as e:
                self._send(400, _json_error(f"bad request: {e}"), "application/json")
                return
            try:
                stream = service.submit_stream(
                    payload["prompt"], total_seconds,
                    window_seconds=payload.get("window_seconds"),
                    context_seconds=payload.get("context_seconds"),
                    steps=payload.get("steps"),
                    seed=int(payload.get("seed", -1)),
                    use_gdm=payload.get("use_gdm"),  # None: the service default
                )
                first = next(stream)  # generation errors surface as HTTP 500
            except StopIteration:
                self._send(200, b"", "audio/L16")
                return
            except ServiceClosed as e:
                self._send(503, _json_error(str(e)), "application/json")
                return
            except Exception as e:  # noqa: BLE001 - reported to the client
                self._send(500, _json_error(str(e)), "application/json")
                return
            self.send_response(200)
            self.send_header("Content-Type", "audio/L16")
            self.send_header("X-Audio-Format", "s16le")
            self.send_header("X-Sample-Rate", str(sample_rate))
            self.send_header("X-Channels", str(first.shape[0]))
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def write_chunk(arr):
                data = (np.clip(arr.T, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
                self.wfile.write(f"{len(data):X}\r\n".encode())
                self.wfile.write(data)
                self.wfile.write(b"\r\n")

            write_chunk(first)
            for chunk in stream:
                write_chunk(chunk)
            self.wfile.write(b"0\r\n\r\n")

    return Handler


def serve(
    jen1,
    host: str = "0.0.0.0",
    port: int = 8000,
    max_batch: int = 4,
    max_wait_ms: float = 200.0,
    max_queue: int = 32,
    sampler_mode: str = "scan",
    default_use_gdm: bool = True,
    output_dtype: str = "int16",
) -> ThreadingHTTPServer:
    """Build (but do not run) the HTTP server; call .serve_forever(), and
    `.service.close()` after `.shutdown()`.

    output_dtype defaults to 'int16' here (unlike GenerationService): the
    WAV response is 16-bit anyway, so the conversion on the device loses
    nothing and halves the fetch; 'npy' responses then carry int16."""
    service = GenerationService(jen1, max_batch=max_batch, max_wait_ms=max_wait_ms,
                                max_queue=max_queue, sampler_mode=sampler_mode,
                                default_use_gdm=default_use_gdm, output_dtype=output_dtype)
    httpd = ThreadingHTTPServer((host, port), make_handler(service, jen1.sample_rate))
    httpd.service = service  # type: ignore[attr-defined]
    return httpd


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    from jen1_tpu_torch.api.generation import Jen1
    from jen1_tpu_torch.config import Config

    p = argparse.ArgumentParser(description="Serve Jen1 text-to-music over HTTP")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint directory of this package or a reference .pth")
    p.add_argument("--config", default=None, help="config JSON path")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--max-wait-ms", type=float, default=200.0)
    p.add_argument("--max-queue", type=int, default=32,
                   help="admission bound; beyond it requests get 503")
    p.add_argument("--sampler-mode", default="scan", choices=("scan", "stepwise", "dpm++"))
    p.add_argument("--diffusion", default="gdm", choices=("gdm", "vdm"),
                   help="the default when a request omits use_gdm: 'gdm' (DDIM) or "
                        "'vdm' (generate()'s own default)")
    p.add_argument("--output-dtype", default="int16", choices=("int16", "float32"),
                   help="'int16' converts to PCM on the device (half the fetch; WAV is "
                        "16-bit anyway); 'float32' keeps fp32 npy responses")
    p.add_argument("--weights-dtype", default=None, choices=("float32", "bfloat16"),
                   help="'bfloat16' stores the UNet's matrix weights in bf16")
    p.add_argument("--device", default="cuda", help="torch device of the model")
    args = p.parse_args(argv)

    config = Config.from_json(args.config) if args.config else Config()
    jen1 = Jen1(args.ckpt, config=config, weights_dtype=args.weights_dtype,
                device=args.device)
    httpd = serve(
        jen1, host=args.host, port=args.port, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, max_queue=args.max_queue,
        sampler_mode=args.sampler_mode, default_use_gdm=(args.diffusion == "gdm"),
        output_dtype=args.output_dtype,
    )
    print(f"jen1_tpu_torch.serve listening on {args.host}:{httpd.server_address[1]}",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.service.close()  # drain admitted work before exit


if __name__ == "__main__":
    main()
