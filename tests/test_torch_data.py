"""Port parity of the data slice: jen1_tpu_torch's native decoders,
`load_audio`, `MusicDataset` and `preprocess` against jen1_tpu on the CPU.

Fixtures are written by the writers the JAX suite uses: the stdlib WAV
writer, the pure-Python FLAC encoder, libmp3lame and libvorbis through
tests/test_mp3.py and tests/test_ogg.py, FFmpeg's AAC encoder through the
JAX shim; a format whose fixture cannot be built here skips, as the JAX
suite does. Bars: decoded samples, durations, dataset windows and the scan
caches equal exactly; preprocess latents 1e-4 (the codec bar of
tests/test_torch_codec.py), with one codec's weights in both packages.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from jen1_tpu.data import audio_io as jax_audio_io
from jen1_tpu.data import native_io as jax_native
from jen1_tpu.data import preprocess as jax_preprocess
from jen1_tpu.data.dataset import AUDIO_EXTS as JAX_AUDIO_EXTS
from jen1_tpu.data.dataset import MusicDataset as JaxMusicDataset
from jen1_tpu.data.flac_write import write_flac
from jen1_tpu_torch.data import audio_io, native_io, preprocess
from jen1_tpu_torch.data.dataset import AUDIO_EXTS, MusicDataset
from torch_port_util import TINY_CODEC, assert_close, one_torch_thread, synthetic_clip

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 48_000
LATENT_BAR = dict(rtol=1e-4, atol=1e-4)


def tone(seconds=0.5, ch=2, sr=SR, seed=0):
    return (0.8 * synthetic_clip(seed, seconds, sr, ch)).clip(-0.9, 0.9)


def write_fixture(fmt: str, path: str, audio: np.ndarray, sr: int = SR) -> None:
    """Write `audio` as `fmt` with the JAX suite's fixture writer, or skip."""
    if fmt == "wav":
        jax_audio_io.write_wav(path, audio, sr)
    elif fmt == "flac":
        write_flac(path, audio, sr)
    elif fmt == "mp3":
        if not jax_native.mp3_available():
            pytest.skip("native mp3io not built or libmpg123 absent")
        from test_mp3 import encode_mp3

        encode_mp3(path, audio, sr)
    elif fmt == "ogg":
        if not jax_native.ogg_available():
            pytest.skip("native oggio not built or libvorbisfile absent")
        from test_ogg import encode_ogg

        encode_ogg(path, audio, sr)
    else:
        if not jax_native.aac_available():
            pytest.skip("native aacio not built or FFmpeg absent")
        jax_native.aac_write_fixture(path, audio, sr)


JAX_READ = {"wav": jax_native.wav_read, "flac": jax_native.flac_read,
            "mp3": jax_native.mp3_read, "ogg": jax_native.ogg_read,
            "aac": jax_native.aac_read}
JAX_INFO = {"wav": jax_native.wav_info, "flac": jax_native.flac_info,
            "mp3": jax_native.mp3_info, "ogg": jax_native.ogg_info,
            "aac": jax_native.aac_info}
SUFFIX = {"wav": ".wav", "flac": ".flac", "mp3": ".mp3", "ogg": ".ogg", "aac": ".m4a"}


@pytest.mark.parametrize("fmt", ["wav", "flac", "mp3", "ogg", "aac"])
def test_decoders_bit_equal_jax(tmp_path, fmt):
    """info and read (whole file, a window, a window past the end) equal the
    JAX bindings' bit for bit; so do load_audio and get_duration_sec,
    seeks included."""
    path = str(tmp_path / f"clip{SUFFIX[fmt]}")
    write_fixture(fmt, path, tone())
    assert native_io.info(fmt, path) == JAX_INFO[fmt](path)
    total = native_io.info(fmt, path)[2]
    for start, num in ((0, None), (1234, 4000), (total - 100, 300)):
        out, sr = native_io.read(fmt, path, start, num)
        ref, ref_sr = JAX_READ[fmt](path, start, num)
        assert sr == ref_sr and out.dtype == np.float32
        np.testing.assert_array_equal(out, ref)
        out, sr = audio_io.load_audio(path, start, num)
        ref, ref_sr = jax_audio_io.load_audio(path, start, num)
        assert sr == ref_sr
        np.testing.assert_array_equal(out, ref)
    assert audio_io.get_duration_sec(path) == jax_audio_io.get_duration_sec(path)


def test_wav_read_batch_and_rejected_wav(tmp_path):
    """wav_read_batch equals the JAX call; a WAV the native reader rejects
    (4-bit samples, which the stdlib reads as 1-byte ones) is read by the
    stdlib reader in both packages; an unknown extension raises ValueError
    naming the formats."""
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"c{i}.wav"))
        jax_audio_io.write_wav(paths[-1], tone(seed=i), SR)
    starts = [0, 100, 23_000]
    np.testing.assert_array_equal(native_io.wav_read_batch(paths, starts, 2000, 2),
                                  jax_native.wav_read_batch(paths, starts, 2000, 2))
    import struct

    p8 = str(tmp_path / "u4.wav")
    data = bytes(range(0, 250, 5))
    fmt = struct.pack("<HHIIHH", 1, 1, 8000, 8000, 1, 4)
    with open(p8, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE" + b"fmt "
                + struct.pack("<I", 16) + fmt + b"data" + struct.pack("<I", len(data)) + data)
    with pytest.raises(IOError):
        native_io.read("wav", p8)
    np.testing.assert_array_equal(audio_io.load_audio(p8)[0], jax_audio_io.load_audio(p8)[0])
    assert audio_io.get_duration_sec(p8) == jax_audio_io.get_duration_sec(p8)
    with pytest.raises(ValueError, match=r"\.flac"):
        audio_io.load_audio(str(tmp_path / "x.aiff"))


def test_build_is_atomic_across_processes(tmp_path):
    """Four processes that build the same decoder at once into an empty
    build directory all load a whole library; one build is left behind and
    no temporary file."""
    code = ("import sys; from pathlib import Path; sys.path.insert(0, sys.argv[1]); "
            "from jen1_tpu_torch.data import native_io as n; n.BUILD_ROOT = Path(sys.argv[2]); "
            "n.get_lib('flac'); print(n.library_path('flac'))")
    procs = [subprocess.Popen([sys.executable, "-c", code, ROOT, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    libs = {o.strip() for o, _ in outs}
    assert len(libs) == 1
    built = [f for f in tmp_path.rglob("*") if f.is_file()]
    assert [str(f) for f in built] == list(libs)


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """No fallback: a source g++ rejects raises with g++'s stderr."""
    bad = tmp_path / "native"
    bad.mkdir()
    (bad / "wavio.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(native_io, "NATIVE_DIR", bad)
    monkeypatch.setattr(native_io, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native_io, "_libs", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ could not build the wav decoder(.|\n)*error"):
        native_io.get_lib("wav")
    assert not [f for f in (tmp_path / "build").rglob("*") if f.is_file()]


def corpus(tmp_path, seconds=(2.3, 0.7, 3.1, 1.6), sr=SR, name="ds"):
    """<dir>/audios with WAV and FLAC files of the given lengths (one at
    another rate and mono, which convert_audio fixes) and sidecar metadata
    for all but the last."""
    root = tmp_path / name
    (root / "audios").mkdir(parents=True)
    (root / "metadata").mkdir()
    for i, sec in enumerate(seconds):
        fmt = "flac" if i % 2 else "wav"
        rate, ch = (sr // 2, 1) if i == 2 else (sr, 2)
        write_fixture(fmt, str(root / "audios" / f"song{i}.{fmt}"), tone(sec, ch, rate, seed=i),
                      rate)
        if i < len(seconds) - 1:
            (root / "metadata" / f"song{i}.json").write_text(
                json.dumps({"prompt": f"song number {i}", "bpm": 100 + i}))
    (root / "audios" / "notes.txt").write_text("not audio")
    return root


@pytest.mark.parametrize("aug_shift,cached", [(True, False), (False, False), (True, True)])
def test_music_dataset_matches_jax(tmp_path, aug_shift, cached):
    """Same length, the same (index, offset) per item at the same seed (the
    aug_shift jitter drawn as JAX draws it), equal chunks and metadata;
    with the scan caches, and with the duration filter."""
    root = corpus(tmp_path)
    kw = dict(sr=SR, channels=2, sample_duration=0.5, aug_shift=aug_shift, seed=3,
              min_duration=0.5, max_duration=3.0)
    if cached:
        preprocess.scan(str(root))
        kw.update(durations_path=str(root / "durations.npy"),
                  cumsum_path=str(root / "cumsum.npy"),
                  audio_file_txt_path=str(root / "files.txt"))
    port, ref = MusicDataset(str(root), **kw), JaxMusicDataset(str(root), **kw)
    assert port.audio_files == ref.audio_files
    np.testing.assert_array_equal(port.cumsum, ref.cumsum)
    assert len(port) == len(ref) >= 8
    for item in range(len(ref)):
        assert port.get_index_offset(item) == ref.get_index_offset(item)
    for item in (0, 3, len(ref) - 1, 5):
        (a, ma), (b, mb) = port[item], ref[item]
        assert a.shape == b.shape == (SR // 2, 2)
        np.testing.assert_array_equal(a, b)
        assert ma == mb
    assert AUDIO_EXTS == JAX_AUDIO_EXTS


def test_scan_writes_the_same_files(tmp_path):
    root = corpus(tmp_path)
    preprocess.scan(str(root), str(tmp_path / "port"))
    jax_preprocess.scan(str(root), str(tmp_path / "jax"))
    for name in ("durations.npy", "cumsum.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "port" / name),
                                      np.load(tmp_path / "jax" / name))
    assert (tmp_path / "port" / "files.txt").read_text() == \
        (tmp_path / "jax" / "files.txt").read_text()


@pytest.fixture(scope="module")
def codecs():
    from jen1_tpu.codec.model import EncodecConfig as JConfig, EncodecModel as JModel
    from jen1_tpu_torch.ckpt.from_jax import load_encodec
    from jen1_tpu_torch.codec.model import EncodecConfig, EncodecModel
    from torch_port_util import np_tree

    jcodec = JModel(JConfig(**TINY_CODEC))
    pcodec = EncodecModel(EncodecConfig(**TINY_CODEC), device="cpu")
    load_encodec(pcodec, np_tree(jcodec.params))
    return jcodec, pcodec.eval()


@pytest.mark.parametrize("mode", ["chunked", "segmented", "whole"])
def test_encode_matches_jax(tmp_path, codecs, mode):
    """preprocess encode through the tiny codec (1600 Hz): the same window
    names, metadata files and latents (1e-4) as jen1_tpu's encode; 5 s
    windows are 200 frames, so the chunked encoder overlaps two chunks."""
    jcodec, pcodec = codecs
    sr = TINY_CODEC["sample_rate"]
    root = corpus(tmp_path, seconds=(11.0, 4.0), sr=sr)
    kw = dict(sample_duration=5.0, sr=sr, channels=2, batch_size=2)
    jax_preprocess.encode(str(root), str(tmp_path / "jax"), codec=jcodec,
                          segmented=mode == "segmented", chunked=mode == "chunked", **kw)
    with one_torch_thread():
        n = preprocess.encode(str(root), str(tmp_path / "port"), codec=pcodec, mode=mode,
                              device="cpu", **kw)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and n == 3
    assert [x for x in names if x.endswith(".npy")] == [
        "song0_0000.npy", "song0_0001.npy", "song1_0000.npy"]
    for name in names:
        if name.endswith(".json"):
            assert json.loads((tmp_path / "port" / name).read_text()) == json.loads(
                (tmp_path / "jax" / name).read_text())
        else:
            out, ref = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
            assert out.shape == ref.shape
            assert_close(out, ref, **LATENT_BAR)


def test_encode_cli_refuses_two_modes(tmp_path):
    with pytest.raises(SystemExit):
        preprocess.main(["encode", "--dataset-dir", str(tmp_path), "--segmented",
                         "--whole-clip", "--device", "cpu"])
    with pytest.raises(ValueError, match="encode mode"):
        preprocess.encoder_of(None, "stft")

