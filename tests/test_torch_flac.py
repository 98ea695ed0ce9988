"""The port's FLAC codec (its own copy of the C++ source, built with the
host compiler; the pure decoder; the facade) against the JAX package's.

The two packages build the same C++ source into two libraries, so files
written from the same samples must be byte-identical, and each package's
readers must decode the other's files to equal arrays.
"""
import numpy as np
import pytest
import torch

from tomatis_tpu.io import audio as jaudio
from tomatis_tpu_torch.io import audio, flac as flac_mod
from tomatis_tpu_torch.io.flac_py import PureFlacReader
from tomatis_tpu_torch.models import standard
from tomatis_tpu_torch.native import build

torch.set_num_threads(2)


def _sig(n=30000, ch=2, sr=48000, seed=0, amp=0.5):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = amp * np.sin(2 * np.pi * 440 * t)[:, None] * np.ones((1, ch))
    x += 0.02 * rng.standard_normal((n, ch))
    return np.clip(x, -1, 1).astype(np.float32)


def _no_native(monkeypatch):
    """From here on, a machine without a C++ compiler: the build hook
    refuses, and the port's library cache is empty. (The hook is shared
    with the JAX package, so a test writes its input file first.)"""
    monkeypatch.setenv("TOMATIS_NO_NATIVE", "1")
    monkeypatch.setattr(build, "_CACHE", {})


@pytest.mark.parametrize("subtype,ch", [("PCM_16", 2), ("PCM_24", 2),
                                        ("PCM_24", 1), ("PCM_16", 1)])
def test_writers_are_byte_identical(tmp_path, subtype, ch):
    x = _sig(ch=ch, seed=ch)
    a, b = tmp_path / "a.flac", tmp_path / "b.flac"
    audio.write(a, x, 48000, subtype=subtype)
    jaudio.write(b, x, 48000, subtype=subtype)
    assert a.read_bytes() == b.read_bytes()
    meta = audio.info(a)
    assert (meta.samplerate, meta.channels, meta.frames, meta.format,
            meta.subtype) == (48000, ch, len(x), "FLAC", subtype)
    tol = 2.0 ** -(15 if subtype == "PCM_16" else 23)
    y, sr = audio.read(a)
    assert sr == 48000 and np.max(np.abs(y - x)) <= tol + 1e-7
    np.testing.assert_array_equal(y, jaudio.read(b)[0])


@pytest.mark.parametrize("subtype", ["PCM_16", "PCM_24"])
def test_native_and_pure_readers_decode_equal(tmp_path, subtype):
    x = _sig(n=20000)
    p = tmp_path / "x.flac"
    jaudio.write(p, x, 48000, subtype=subtype)     # the reference's file
    nat = flac_mod.FlacReader(p)
    assert isinstance(nat, flac_mod._NativeFlacReader)
    pure = PureFlacReader(p)
    assert (pure.samplerate, pure.channels, pure.frames, pure.subtype) \
        == (nat.samplerate, nat.channels, nat.frames, nat.subtype)
    yn, yp = nat.read(-1), pure.read(-1)
    np.testing.assert_array_equal(yn, yp)
    np.testing.assert_array_equal(yn, jaudio.read(p)[0])
    nat.close()
    pure.close()


def test_seek_native_and_pure(tmp_path):
    x = _sig(n=25000)
    p = tmp_path / "s.flac"
    audio.write(p, x, 48000)
    whole, _ = audio.read(p)
    for reader in (flac_mod._NativeFlacReader(p), PureFlacReader(p)):
        for pos in (7013, 0, 24990, 12000):
            assert reader.seek(pos) == pos
            piece = reader.read(400)
            np.testing.assert_array_equal(piece, whole[pos:pos + 400])
            assert reader.tell() == pos + len(piece)
        reader.close()
    y, _ = audio.read(p, frames=1000, start=12345)
    np.testing.assert_array_equal(y, whole[12345:13345])


def test_streaming_write_and_write_raw(tmp_path):
    """Block-wise float writes and raw PCM_24 bytes give the same file as
    one write of the same samples."""
    from tomatis_tpu_torch.utils.pcm import le24_from_i32
    x = _sig(n=30011)     # not a multiple of the block size
    v = np.clip(np.rint(x * 8388608.0), -8388608, 8388607).astype(np.int32)
    one, blocks, raw = (tmp_path / n for n in ("1.flac", "b.flac", "r.flac"))
    audio.write(one, x, 44100)
    with audio.AudioFile(blocks, "w", samplerate=44100, channels=2) as f:
        for i in range(0, len(x), 7000):
            f.write(x[i:i + 7000])
        assert f.frames == len(x)
    with audio.AudioFile(raw, "w", samplerate=44100, channels=2) as f:
        assert f.supports_raw
        f.write_raw(le24_from_i32(v.reshape(-1)))
        assert f.frames == len(x)
    assert one.read_bytes() == blocks.read_bytes() == raw.read_bytes()
    with pytest.raises(ValueError, match="PCM_24"):
        with audio.AudioFile(tmp_path / "w16.flac", "w", samplerate=44100,
                             channels=2, subtype="PCM_16") as f:
            assert not f.supports_raw
            f._h.write_raw(b"\0" * 6)
    with pytest.raises(ValueError, match="unsupported FLAC subtype"):
        audio.AudioFile(tmp_path / "f.flac", "w", samplerate=44100,
                        channels=2, subtype="FLOAT")


def test_reader_falls_back_to_pure_without_native(tmp_path, monkeypatch):
    x = _sig(n=6000)
    p = tmp_path / "f.flac"
    jaudio.write(p, x, 48000, subtype="PCM_24")
    _no_native(monkeypatch)
    r = flac_mod.FlacReader(p)
    assert isinstance(r, PureFlacReader)
    assert np.max(np.abs(r.read(-1) - x)) <= 2 ** -23 + 1e-7
    with audio.AudioFile(p) as f:      # the facade takes the same route
        assert isinstance(f._h, PureFlacReader) and f.frames == len(x)
    with pytest.raises(RuntimeError, match="TOMATIS_NO_NATIVE"):
        flac_mod.FlacWriter(tmp_path / "o.flac", 48000, 2)


def test_process_writes_wav_sibling_without_native(tmp_path, monkeypatch,
                                                   capsys):
    """No encoder: process() reads the FLAC with the pure decoder and
    writes a WAV beside the requested path, with the conversion hint."""
    t = np.arange(24000) / 48000
    x = (np.where(t > 0.25, 0.1, 0.003) * np.sin(2 * np.pi * 700 * t))
    x = np.stack([x, x], 1).astype(np.float32)
    ip, op = tmp_path / "in.flac", tmp_path / "dir.v2" / "o.flac"
    op.parent.mkdir()
    jaudio.write(ip, x, 48000, subtype="PCM_24")
    _no_native(monkeypatch)
    st = standard.process(ip, op, frames_per_chunk=8, device="cpu")
    out = capsys.readouterr().out
    sibling = str(tmp_path / "dir.v2" / "o.wav")
    assert st["out_path"] == sibling and not op.exists()
    assert "[WARN] cannot encode" in out and sibling in out
    assert "cli.main convert -i" in out
    meta = audio.info(sibling)
    assert (meta.format, meta.subtype, meta.frames) == \
        ("WAV", "PCM_24", len(x))


def test_build_failure_is_reported(tmp_path, monkeypatch):
    """A compiler that fails raises RuntimeError with its command line."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(build, "CXX_FLAGS", ["--no-such-flag"])
    with pytest.raises(RuntimeError, match="native build failed"):
        build._compile(str(tmp_path / "nope.cpp"), str(tmp_path / "b" / "x.so"))
    assert not list((tmp_path / "b").glob("*.tmp"))


@pytest.mark.parametrize("change", ["flags", "host"])
def test_library_name_keys_flags_and_host(tmp_path, monkeypatch, change):
    """Other compile flags or another host give another library file, and
    a library built for the old key is not loaded, though it is newer
    than its source."""
    import os
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_CACHE", {})
    src = os.path.join(build.CSRC_DIR, "wire.cpp")
    old = build.library_path("wire", src)
    with open(old, "wb") as f:
        f.write(b"a library built for the old key")
    if change == "flags":
        monkeypatch.setattr(build, "CXX_FLAGS",
                            build.CXX_FLAGS + ["-DTOMATIS_OTHER_FLAGS"])
    else:
        monkeypatch.setattr(build.platform, "machine", lambda: "other-cpu")
    new = build.library_path("wire", src)
    assert new != old and os.path.dirname(new) == str(tmp_path)
    compiled, loaded = [], []

    def compile_(s, out):
        compiled.append(out)
        with open(out, "wb") as f:
            f.write(b"stub")

    monkeypatch.setattr(build, "_compile", compile_)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda p: loaded.append(p))
    build.load_library("wire")
    assert compiled == [new] and loaded == [new]
