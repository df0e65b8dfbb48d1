"""The port's serving layer (jen1_tpu_torch/serve.py) and batch CLI
(jen1_tpu_torch/api/batch_generate.py): the behaviour tests of
tests/test_serve.py, driven through the port's GenerationService and HTTP
handler with a device-free fake Jen1 that returns torch tensors and with a
tiny real port Jen1 on the CPU; a seeded request equals lane 0 of a direct
`generate` with the same padded prompts, bit for bit; the stats stay exact
under four completer threads.
"""

import dataclasses
import io
import json
import sys
import threading
import time
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

from jen1_tpu_torch.api import batch_generate
from jen1_tpu_torch.serve import (
    GenerationService, ServiceClosed, ServiceOverloaded, _Request, _wav_bytes, serve,
)
from torch_port_util import one_torch_thread

SECONDS, STEPS, SR = 2.0, 3, 1600


class FakeJen1:
    """Device-free Jen1 stand-in: generate() sleeps `delay` and returns a
    tensor whose value encodes (seed, lane), so tests can check batching and
    seed routing without a model; with output_transport="device" it returns
    the tensor, else its numpy copy, as Jen1 does."""

    sample_rate = SR

    def __init__(self, delay: float = 0.0):
        self.delay = delay
        self.calls = []

    def generate(self, prompts, seed=-1, steps=100, batch_size=1, seconds=30.0,
                 use_gdm=False, sampler_mode="scan", output_dtype="float32",
                 output_transport="host"):
        time.sleep(self.delay)
        self.calls.append({"prompts": list(prompts), "seed": seed,
                           "sampler_mode": sampler_mode, "output_dtype": output_dtype,
                           "output_transport": output_transport})
        t = int(seconds * self.sample_rate)
        audio = torch.full((batch_size, 2, t), float(seed))
        audio += torch.arange(batch_size, dtype=torch.float32)[:, None, None] / 100.0
        if output_dtype == "int16":
            audio = (audio.clamp(-1, 1) * 32767.0).to(torch.int16)
        return audio if output_transport == "device" else audio.numpy()


def tiny_config():
    from jen1_tpu_torch.config import tiny_test_config

    cfg = tiny_test_config()
    cfg.conditioner_config.t5_config.t5_model_name = "tiny-test"
    cfg.conditioner_config.t5_config.max_length = cfg.model_config.context_embedding_max_length
    return cfg


@pytest.fixture(scope="module")
def tiny_jen1():
    """tests/test_serve.py's tiny model on the CPU: tiny_test_config, the
    tiny T5, a 1600 Hz codec with a 40-sample hop and a 4 x 16 RVQ."""
    from jen1_tpu_torch.api.generation import Jen1
    from jen1_tpu_torch.codec.model import EncodecConfig, EncodecModel

    cfg = tiny_config()
    codec = EncodecModel(EncodecConfig(sample_rate=SR, channels=2,
                                       dimension=cfg.model_config.in_channels, n_filters=2,
                                       ratios=(5, 4, 2), n_q=4, bins=16), device="cpu")
    with one_torch_thread():
        yield Jen1(sample_rate=SR, config=cfg, codec=codec, device="cpu")


@pytest.fixture(scope="module")
def service(tiny_jen1):
    svc = GenerationService(tiny_jen1, max_batch=3, max_wait_ms=300.0,
                            default_seconds=SECONDS, default_steps=STEPS)
    yield svc
    svc.close()


class TestGenerationService:
    def test_concurrent_requests_coalesce(self, service):
        """3 concurrent same-shape requests ride one padded batch (at most 2
        on a slow host, where the first may launch before the rest queue)."""
        before = service.stats["batches"]
        results = [None] * 3

        def worker(i):
            results[i] = service.submit(f"tune {i}", use_gdm=True, timeout=600)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for audio in results:
            assert isinstance(audio, np.ndarray) and audio.shape == (2, int(SECONDS * SR))
            assert np.isfinite(audio).all()
        assert 1 <= service.stats["batches"] - before <= 2

    def test_padding_lane_dropped(self, service):
        before = service.stats["padded_lanes"]
        audio = service.submit("solo", use_gdm=True, timeout=600)
        assert audio.ndim == 2 and audio.shape[0] == 2
        assert service.stats["padded_lanes"] - before == 2  # 1 request in a batch of 3

    def test_padding_lanes_sliced_on_the_device(self):
        """The dispatcher hands the completers only the requests' lanes of
        the device tensor (`isinstance(audio, torch.Tensor)`)."""
        fake = FakeJen1()
        svc = GenerationService(fake, max_batch=4, max_wait_ms=10.0, default_seconds=0.1,
                                default_steps=1)
        handed = []
        real = svc._dispatch_batch
        svc._dispatch_batch = lambda batch: handed.append(real(batch)) or handed[-1]
        try:
            svc.submit("one", timeout=30)
        finally:
            svc.close()
        assert fake.calls[-1]["output_transport"] == "device"
        assert fake.calls[-1]["prompts"] == ["one", "", "", ""]
        assert isinstance(handed[0], torch.Tensor) and handed[0].shape[0] == 1

    def test_seeded_request_equals_lane0_of_generate(self, tiny_jen1):
        """seed=N runs as lane 0 of its own batch padded with "": equal, bit
        for bit, to generate() of the same padded prompts and seed."""
        svc = GenerationService(tiny_jen1, max_batch=3, max_wait_ms=5.0,
                                default_seconds=SECONDS, default_steps=STEPS)
        try:
            with one_torch_thread():
                audio = svc.submit("seeded tune", seed=41, timeout=600)
        finally:
            svc.close()
        with one_torch_thread():
            direct = tiny_jen1.generate(["seeded tune", "", ""], seed=41, steps=STEPS,
                                        batch_size=3, seconds=SECONDS, use_gdm=True)
        assert audio.dtype == direct.dtype == np.float32
        np.testing.assert_array_equal(audio, direct[0])

    def test_output_dtype_flows_to_generate(self):
        """output_dtype='int16' reaches generate() and submit returns the
        int16 audio unchanged; _wav_bytes takes it as it is."""
        fake = FakeJen1()
        svc = GenerationService(fake, max_batch=1, max_wait_ms=10.0, default_seconds=2.0,
                                default_steps=2, output_dtype="int16")
        try:
            audio = svc.submit("pcm please", seed=0, timeout=60)
        finally:
            svc.close()
        assert audio.dtype == np.int16
        assert fake.calls[-1]["output_dtype"] == "int16"
        f = np.linspace(-1.2, 1.2, 64, dtype=np.float32).reshape(2, 32)
        ints = (np.clip(f, -1, 1) * 32767.0).astype(np.int16)
        assert _wav_bytes(ints, SR) == _wav_bytes(f, SR)

    def test_n_completers_parallel_fetch(self):
        fake = FakeJen1(delay=0.05)
        svc = GenerationService(fake, max_batch=1, max_wait_ms=5.0, n_completers=3)
        try:
            assert len(svc._completers) == 3
            results = [None] * 4

            def worker(i):
                results[i] = svc.submit(f"par {i}", seed=i, timeout=60)

            threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            svc.close()
        for i, r in enumerate(results):
            assert r is not None and float(r.flat[0]) == float(i)

    @pytest.mark.parametrize("depth", [1, 2])
    def test_pipeline_depth_bounds_batches_in_flight(self, depth):
        """GenerationService(pipeline_depth=k) (jen1_tpu/serve.py:112,
        172-175): with the one completer stuck in a fetch, the dispatcher
        runs k more batches into the in-flight queue and one that waits to
        enter it, then stops until the fetch returns."""
        release = threading.Event()

        class SlowFetch:  # a device result whose fetch waits for `release`
            def __init__(self, audio):
                self.audio = audio

            def __array__(self, dtype=None, copy=None):
                release.wait(30)
                return self.audio.numpy()

        class Fake(FakeJen1):
            def generate(self, *a, **kw):
                return SlowFetch(super().generate(*a, **kw))

        fake = Fake()
        svc = GenerationService(fake, max_batch=1, max_wait_ms=1.0, n_completers=1,
                                pipeline_depth=depth, default_seconds=0.01, default_steps=1)
        threads = [threading.Thread(target=svc.submit, args=(f"r{i}",), kwargs={"timeout": 60})
                   for i in range(depth + 4)]
        try:
            for t in threads:
                t.start()
            deadline = time.monotonic() + 10
            while len(fake.calls) < depth + 2 and time.monotonic() < deadline:
                time.sleep(0.01)
            time.sleep(0.3)  # the dispatcher would go on here if unbounded
            assert len(fake.calls) == depth + 2  # fetched 1 + queued k + waiting 1
            assert svc._inflight.qsize() == depth == svc._inflight.maxsize
        finally:
            release.set()
            for t in threads:
                t.join()
            svc.close()
        assert len(fake.calls) == depth + 4 and svc.stats["errors"] == 0

    def test_stats_exact_under_four_completers(self):
        """stats['batches'] and ['padded_lanes'] are read-modify-writes on
        four completer threads at once: none may be lost."""
        fake = FakeJen1()
        svc = GenerationService(fake, max_batch=2, max_wait_ms=1.0, n_completers=4,
                                max_queue=256, default_seconds=0.01,
                                default_steps=1)
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)  # switch threads as often as the GIL allows
        try:
            def worker(i):
                for j in range(20):
                    svc.submit(f"{i}-{j}", seed=-1 if j % 2 else i * 100 + j, timeout=60)

            threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            sys.setswitchinterval(interval)
            svc.close()
        n_batches = len(fake.calls)
        lanes = sum(sum(p != "" for p in c["prompts"]) for c in fake.calls)
        assert lanes == 160 and svc.stats["requests"] == 160
        assert svc.stats["batches"] == n_batches
        assert svc.stats["padded_lanes"] == 2 * n_batches - 160
        assert svc.stats["errors"] == 0

    def test_error_reported_not_swallowed(self, service):
        with pytest.raises((RuntimeError, TimeoutError)):
            # too short a clip for the UNet's downsampling
            service.submit("broken", seconds=1e-4, timeout=120)
        audio = service.submit("recovery", use_gdm=True, timeout=600)
        assert np.isfinite(audio).all()
        assert service.stats["errors"] >= 1

    def test_rng_impl_is_not_an_argument(self):
        """The JAX service's TPU-RNG knob has no counterpart in the port."""
        with pytest.raises(TypeError):
            GenerationService(FakeJen1(), rng_impl="rbg")


class TestOverloadAndSeeds:
    def test_burst_sheds_load_then_recovers(self):
        svc = GenerationService(FakeJen1(delay=0.15), max_batch=1, max_wait_ms=5.0,
                                max_queue=2)
        try:
            outcomes = []
            lock = threading.Lock()

            def worker():
                try:
                    svc.submit("x", seconds=0.1, steps=1, timeout=30)
                    out = "ok"
                except ServiceOverloaded as e:
                    assert e.retry_after >= 1.0
                    out = "shed"
                with lock:
                    outcomes.append(out)

            threads = [threading.Thread(target=worker) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert outcomes.count("ok") >= 1 and outcomes.count("shed") >= 1
            assert len(outcomes) == 8
            assert svc.stats["rejected"] == outcomes.count("shed")
            audio = svc.submit("after", seconds=0.1, steps=1, timeout=30)
            assert np.isfinite(audio).all()
        finally:
            svc.close()

    def test_close_drains_admitted_work(self):
        svc = GenerationService(FakeJen1(delay=0.1), max_batch=1, max_wait_ms=5.0,
                                max_queue=8)
        results = []

        def worker(i):
            results.append(svc.submit(f"r{i}", seconds=0.1, steps=1, timeout=30))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.02)  # let them be admitted
        svc.close()  # waits for all 3
        for t in threads:
            t.join()
        assert len(results) == 3
        with pytest.raises(ServiceClosed):
            svc.submit("too late", seconds=0.1, steps=1, timeout=5)

    def test_explicit_seeds_never_cobatch(self):
        fake = FakeJen1(delay=0.05)
        svc = GenerationService(fake, max_batch=4, max_wait_ms=250.0, max_queue=16)
        try:
            results = {}
            lock = threading.Lock()

            def worker(seed):
                audio = svc.submit("s", seconds=0.1, steps=1, seed=seed, timeout=30)
                with lock:
                    results[seed] = audio

            threads = [threading.Thread(target=worker, args=(s,)) for s in (5, 9)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            # lane 0 of its own batch: the value is the seed exactly
            assert float(results[5].flat[0]) == 5.0
            assert float(results[9].flat[0]) == 9.0
            assert len(fake.calls) == 2
        finally:
            svc.close()

    def test_different_key_request_not_starved(self):
        svc = GenerationService(FakeJen1(delay=0.02), max_batch=2, max_wait_ms=40.0,
                                max_queue=64)
        try:
            stop = threading.Event()

            def flood():  # a steady stream of key A
                while not stop.is_set():
                    try:
                        svc.submit("a", seconds=0.1, steps=1, timeout=10)
                    except (ServiceOverloaded, ServiceClosed):
                        time.sleep(0.005)

            flooders = [threading.Thread(target=flood) for _ in range(3)]
            for t in flooders:
                t.start()
            time.sleep(0.05)
            t0 = time.time()
            audio = svc.submit("b", seconds=0.2, steps=2, timeout=10)  # key B
            elapsed = time.time() - t0
            stop.set()
            for t in flooders:
                t.join()
            assert np.isfinite(audio).all()
            assert elapsed < 5.0
        finally:
            svc.close()


class TestCancellationAndCloseRaces:
    def test_timed_out_request_not_run(self):
        jen1 = FakeJen1(delay=0.4)
        svc = GenerationService(jen1, max_batch=1, max_wait_ms=10.0, default_seconds=1.0,
                                default_steps=2)
        try:
            t_a = threading.Thread(target=lambda: svc.submit("A", seconds=1.0, timeout=10.0))
            t_a.start()
            time.sleep(0.1)  # A holds the device
            with pytest.raises(TimeoutError):
                svc.submit("B", seconds=1.0, timeout=0.05)
            t_a.join(10.0)
            deadline = time.time() + 5.0
            while svc.queue_depth > 0 and time.time() < deadline:
                time.sleep(0.02)
            assert svc.queue_depth == 0  # B's admission slot released
            assert "B" not in [p for c in jen1.calls for p in c["prompts"]]
        finally:
            svc.close()

    def test_depth_released_exactly_once(self):
        svc = GenerationService(FakeJen1(), max_batch=1, default_seconds=1.0, default_steps=2)
        try:
            with svc._depth_lock:
                svc._depth += 1
            req = _Request("x", 1.0, 2, -1, False)
            svc._finish(req, error="boom")
            svc._finish(req, error="boom2")  # idempotent
            assert svc.queue_depth == 0
            assert req.error == "boom"
        finally:
            svc.close()

    def test_close_fails_requests_still_queued(self):
        svc = GenerationService(FakeJen1(), max_batch=1, default_seconds=1.0, default_steps=2)
        svc._stop.set()
        svc._thread.join(5.0)
        req = _Request("stranded", 1.0, 2, -1, False)
        with svc._depth_lock:
            svc._depth += 1
        svc._queue.put(req)
        svc.close(drain_timeout=0.1)
        assert req.done.is_set() and req.error is not None
        assert svc.queue_depth == 0

    def test_submit_after_close_raises_service_closed(self):
        svc = GenerationService(FakeJen1(), max_batch=1, default_seconds=1.0, default_steps=2)
        svc.close()
        with pytest.raises(ServiceClosed):
            svc.submit("late", seconds=1.0)


def post(url, body, timeout=600):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    return urllib.request.urlopen(urllib.request.Request(url, data=data, method="POST"),
                                  timeout=timeout)


class TestHTTP:
    @pytest.fixture(scope="class")
    def server(self, tiny_jen1):
        httpd = serve(tiny_jen1, host="127.0.0.1", port=0, max_batch=2, max_wait_ms=50.0)
        httpd.service.default_seconds = SECONDS
        httpd.service.default_steps = STEPS
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        with one_torch_thread():
            yield f"http://127.0.0.1:{httpd.server_address[1]}"
        httpd.shutdown()
        httpd.service.close()

    def test_healthz(self, server):
        with urllib.request.urlopen(f"{server}/healthz", timeout=30) as r:
            body = json.loads(r.read())
        assert body["ok"] is True and "batches" in body

    def test_generate_wav(self, server):
        with post(f"{server}/generate", {"prompt": "hi", "use_gdm": True}) as r:
            assert r.headers["Content-Type"] == "audio/wav"
            data = r.read()
        with wave.open(io.BytesIO(data)) as w:
            assert (w.getnchannels(), w.getframerate(), w.getnframes()) == (2, SR, 3200)

    def test_generate_npy(self, server):
        with post(f"{server}/generate", {"prompt": "hi", "use_gdm": True, "format": "npy"}) as r:
            audio = np.load(io.BytesIO(r.read()))
        # serve() converts to int16 PCM on the device by default
        assert audio.shape == (2, 3200) and audio.dtype == np.int16

    def test_bad_request(self, server):
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            post(f"{server}/generate", b'{"no_prompt": 1}', timeout=30)
        assert exc_info.value.code == 400

    def test_generate_long_streams_pcm(self, server, tiny_jen1):
        """Chunked s16le PCM equal to the in-process generate_long output for
        the same seed, under the service defaults (GDM DDIM)."""
        body = {"prompt": "stream me", "total_seconds": 2.5, "window_seconds": 1.0,
                "context_seconds": 0.5, "steps": 2, "seed": 13}
        with post(f"{server}/generate_long", body) as r:
            assert r.headers["X-Sample-Rate"] == str(SR)
            assert r.headers["X-Channels"] == "2"
            data = r.read()
        got = np.frombuffer(data, "<i2").reshape(-1, 2)
        expected = tiny_jen1.generate_long("stream me", total_seconds=2.5, window_seconds=1.0,
                                           context_seconds=0.5, seed=13, steps=2,
                                           use_gdm=True)[0]
        exp_pcm = (np.clip(expected.T, -1, 1) * 32767.0).astype("<i2")
        assert got.shape == exp_pcm.shape == (int(2.5 * SR), 2)
        np.testing.assert_array_equal(got, exp_pcm)

    def test_generate_long_bad_request(self, server):
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            post(f"{server}/generate_long", b'{"prompt": "x"}', timeout=30)
        assert exc_info.value.code == 400  # total_seconds missing

    def test_http_503_on_overload(self):
        httpd = serve(FakeJen1(delay=0.2), host="127.0.0.1", port=0, max_batch=1,
                      max_wait_ms=5.0, max_queue=1)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            codes, retry_afters = [], []
            lock = threading.Lock()

            def worker():
                try:
                    with post(f"{url}/generate", {"prompt": "x", "seconds": 0.1, "steps": 1},
                              timeout=30) as r:
                        with lock:
                            codes.append(r.status)
                except urllib.error.HTTPError as e:
                    with lock:
                        codes.append(e.code)
                        if e.code == 503:
                            retry_afters.append(e.headers.get("Retry-After"))

            threads = [threading.Thread(target=worker) for _ in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert 200 in codes and 503 in codes
            assert all(ra is not None and int(ra) >= 1 for ra in retry_afters)
            with urllib.request.urlopen(f"{url}/healthz", timeout=10) as r:
                body = json.loads(r.read())
            assert body["rejected"] >= 1 and body["max_queue"] == 1
        finally:
            httpd.shutdown()
            httpd.service.close()


class FakeEvent:
    """A CUDA event's surface: `elapsed_time` in ms to a later event."""

    def __init__(self, ms: float):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


class EventedFakeJen1(FakeJen1):
    """A FakeJen1 whose every decode took 25 ms on the device."""

    def generate(self, *args, **kw):
        self.last_decode_events = (FakeEvent(100.0), FakeEvent(125.0))
        return super().generate(*args, **kw)


class GatedFakeJen1(FakeJen1):
    """A FakeJen1 whose first generate() waits for `gate`."""

    def __init__(self):
        super().__init__()
        self.entered, self.gate = threading.Event(), threading.Event()

    def generate(self, *args, **kw):
        if not self.entered.is_set():
            self.entered.set()
            assert self.gate.wait(timeout=60)
        return super().generate(*args, **kw)


def submit_all(svc, n, **kw):
    """n concurrent requests; returns the submitting threads' idents."""
    idents = [None] * n

    def worker(i):
        idents[i] = threading.get_ident()
        svc.submit(f"r{i}", seconds=0.01, steps=1, timeout=60, **kw)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return idents


class TestTracing:
    """Queue wait, hand-off and the decode's device time as counters, and
    the serve.* spans in utils/profiling's ring."""

    @pytest.mark.parametrize("wait_ms,n", [(50.0, 1), (120.0, 2)])
    def test_queue_wait_holds_the_cobatching_window(self, wait_ms, n):
        """A request alone waits out the whole window before its batch is
        formed: queue_wait is at least n windows over n batched requests."""
        svc = GenerationService(FakeJen1(), max_batch=4, max_wait_ms=wait_ms)
        try:
            for i in range(n):
                svc.submit(f"alone {i}", seconds=0.01, steps=1, timeout=60)
        finally:
            svc.close()
        assert svc.stats["batched_requests"] == n
        assert svc.phase_totals["queue_wait"] >= n * wait_ms / 1e3

    def test_queue_wait_holds_the_wait_behind_a_busy_device(self):
        """Three requests queued while the dispatcher is held in a generate()
        for 0.3 s after all three were submitted each wait at least that
        long."""
        fake = GatedFakeJen1()
        svc = GenerationService(fake, max_batch=1, max_wait_ms=1.0)
        try:
            blocker = threading.Thread(
                target=svc.submit, args=("blocker",), kwargs=dict(seconds=0.01, steps=1))
            blocker.start()
            assert fake.entered.wait(timeout=60)
            queued = threading.Thread(target=submit_all, args=(svc, 3))
            queued.start()
            # stats["requests"] counts a request after its submit stamp
            deadline = time.time() + 60
            while svc.stats["requests"] < 4 and time.time() < deadline:
                time.sleep(0.001)
            time.sleep(0.3)
            fake.gate.set()
            queued.join(timeout=60)
            blocker.join(timeout=60)
        finally:
            svc.close()
        assert svc.stats["batched_requests"] == 4 and svc.stats["batches"] == 4
        assert svc.phase_totals["queue_wait"] >= 3 * 0.3

    def test_request_spans_share_uid_and_batches_follow_the_dispatcher(self, monkeypatch):
        """serve.request spans are keyed by their requests' uids, on the
        submitting threads, each around one batch's dispatch and fetch;
        collect, dispatch and the empty polls lie on the dispatcher's
        timeline, one after another."""
        import itertools

        from jen1_tpu_torch import serve as serve_mod
        from jen1_tpu_torch.utils import profiling

        monkeypatch.setattr(serve_mod, "_REQ_IDS", itertools.count(10_000))
        t0 = time.time_ns()
        svc = GenerationService(FakeJen1(delay=0.02), max_batch=2, max_wait_ms=30.0)
        try:
            idents = submit_all(svc, 5)
        finally:
            svc.close()
        # this service's threads: other services of the module run beside it
        dispatcher = svc._thread.ident
        ours = set(idents) | {dispatcher} | {c.ident for c in svc._completers}
        spans = [s for s in profiling.spans(t0) if s[0].startswith("serve.") and s[3] in ours]
        by = {name: [s for s in spans if s[0] == f"serve.{name}"]
              for name in ("request", "await_request", "collect", "dispatch", "fetch")}
        assert sorted(s[4] for s in by["request"]) == list(range(10_000, 10_005))
        assert {s[3] for s in by["request"]} == set(idents)
        timeline = sorted(by["await_request"] + by["collect"] + by["dispatch"],
                          key=lambda s: s[1])
        assert {s[3] for s in timeline} == {dispatcher}
        assert all(a[2] <= b[1] for a, b in zip(timeline, timeline[1:]))
        assert len(by["collect"]) == svc.stats["batches"]
        collect = {s[4]: s for s in by["collect"]}
        dispatch = {s[4]: s for s in by["dispatch"]}
        fetch = {s[4]: s for s in by["fetch"]}
        assert set(collect) == set(dispatch) == set(fetch) and len(collect) >= 3
        for b in collect:
            assert collect[b][2] <= dispatch[b][1] and dispatch[b][2] <= fetch[b][2]
            assert fetch[b][3] != dispatcher
        for req in by["request"]:
            assert any(req[1] <= dispatch[b][1] and fetch[b][2] <= req[2] for b in collect)

    @pytest.mark.parametrize("fake,decode_s", [(FakeJen1, None), (EventedFakeJen1, 0.025)])
    def test_decode_device_only_where_the_jen1_has_events(self, fake, decode_s):
        svc = GenerationService(fake(), max_batch=2, max_wait_ms=1.0)
        try:
            submit_all(svc, 3)
        finally:
            svc.close()
        batches = svc.stats["batches"]
        assert svc.phase_totals["handoff"] >= 0.0 and "fetch" in svc.phase_totals
        if decode_s is None:
            assert "decode_device" not in svc.phase_totals
        else:
            assert svc.phase_totals["decode_device"] == pytest.approx(batches * decode_s)

    @pytest.mark.parametrize("name", ["request", "await_request", "collect", "dispatch",
                                      "fetch"])
    def test_each_serve_span_is_recorded_on_its_thread(self, name):
        from jen1_tpu_torch.utils import profiling

        t0 = time.time_ns()
        svc = GenerationService(FakeJen1(), max_batch=1, max_wait_ms=1.0)
        try:
            (submitter,) = submit_all(svc, 1)
        finally:
            svc.close()
        completers = {c.ident for c in svc._completers}
        ours = {submitter, svc._thread.ident} | completers
        threads = {s[3] for s in profiling.spans(t0) if s[0] == f"serve.{name}"} & ours
        want = {"request": {submitter}, "fetch": completers}.get(name, {svc._thread.ident})
        assert threads and threads <= want

    def test_healthz_reports_phase_totals(self):
        httpd = serve(FakeJen1(), host="127.0.0.1", port=0, max_batch=2, max_wait_ms=5.0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            httpd.service.submit("x", seconds=0.01, steps=1, timeout=30)
            url = f"http://127.0.0.1:{httpd.server_address[1]}/healthz"
            with urllib.request.urlopen(url, timeout=10) as r:
                body = json.loads(r.read())
        finally:
            httpd.shutdown()
            httpd.service.close()
        assert body["batched_requests"] == 1 and body["batches"] == 1
        assert {"collect", "queue_wait", "handoff", "fetch"} <= set(body["phase_totals"])
        assert body["phase_totals"]["queue_wait"] >= 0.0


def test_batch_generate_writes_wavs_and_manifest(tmp_path):
    """3 prompts in batches of 2 (the second padded with ""): one WAV per
    prompt and a manifest, on the CPU. The CLI builds the EnCodec-48k codec
    (random weights), so the tiny UNet takes its 128 latent channels."""
    cfg = tiny_config()
    cfg.model_config = dataclasses.replace(cfg.model_config, in_channels=128,
                                           out_channels=128, context_channels=(129,))
    cfg_path = tmp_path / "cfg.json"
    cfg.to_json(str(cfg_path))
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("warm jazz\n\nsolo cello\nfast drums\n")
    out = tmp_path / "out"
    with one_torch_thread():
        batch_generate.main(["--prompts", str(prompts), "--out", str(out), "--config",
                             str(cfg_path), "--seconds", "1", "--steps", "2",
                             "--batch-size", "2", "--use-gdm", "--device", "cpu"])
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest == [{"file": "00000.wav", "prompt": "warm jazz"},
                        {"file": "00001.wav", "prompt": "solo cello"},
                        {"file": "00002.wav", "prompt": "fast drums"}]
    for entry in manifest:
        with wave.open(str(out / entry["file"])) as w:
            assert (w.getnchannels(), w.getframerate(), w.getnframes()) == (2, 48_000, 48_000)


def test_batch_generate_refuses_dp(tmp_path, monkeypatch):
    """--dp 2 is ported (tests/test_torch_mesh_entry.py runs it on two gloo
    ranks);
    outside a torchrun world of 2 it raises, naming torchrun, and a batch
    that dp does not divide is refused."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("x\n")
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        batch_generate.main(["--prompts", str(prompts), "--out", str(tmp_path / "o"),
                             "--dp", "2", "--batch-size", "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="multiple of --dp 2"):
        batch_generate.main(["--prompts", str(prompts), "--out", str(tmp_path / "o"),
                             "--dp", "2", "--device", "cpu"])
