"""The port's FLAC encoder against the JAX package's, byte for byte, over a
corpus that takes every subframe kind the encoder makes (CONSTANT,
VERBATIM, FIXED, LPC), every stereo assignment, both depths, mono and
stereo, partial last blocks and two-byte frame numbers; and every frame's
header CRC-8 and CRC-16 recomputed bit by bit, apart from the encoder's
tables.

The two packages build their own copies of the C++ encoder; the port's
makes a frame with its CRCs from tables, the autocorrelation's lags in one
pass and its integer stages in one reused scratch, and must write the
bytes of the JAX package's per-stage encoder.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

from test_flac_spec import crc8, crc16
from tomatis_tpu.io import audio as jaudio
from tomatis_tpu_torch.io import audio, flac as flac_mod
from tomatis_tpu_torch.utils.pcm import le24_from_i32

SR = 48000
BLOCK = flac_mod.BLOCK
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _programme(seconds, levels_db=None, seed=22):
    """The benchmark's flac_10min programme (passages 12 dB under and over
    the standard configuration's gate threshold), cut to `seconds`; with
    levels_db, every passage at those levels."""
    bench = os.path.join(ROOT, "benchmark")
    spec = importlib.util.spec_from_file_location(
        "programme", os.path.join(bench, "traffic", "programme.py"))
    programme = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(programme)
    with open(os.path.join(bench, "traffic", "flac_10min.json")) as f:
        mix = json.load(f)
    with open(os.path.join(bench, "configs",
                           "standard_cli_defaults.json")) as f:
        config = json.load(f)
    mix["lengths_s"] = [seconds]
    if levels_db is not None:
        mix["levels_db"] = levels_db
    return programme.make(mix, config, seed)[0]


def _tone(n, ch, amp=0.3, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = amp * np.sin(2 * np.pi * 440 * t)[:, None] * np.ones((1, ch))
    x[:, -1] *= 0.7
    return x + 0.003 * rng.standard_normal((n, ch))


def _extreme(n):
    """Samples at -2^23 and 2^23 - 1, the channels opposite: the side
    channel L - R takes 25 bits."""
    rng = np.random.default_rng(3)
    s = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    s[: n // 3] = np.repeat([-1.0, 1.0], 64)[np.arange(n // 3) % 128]
    return np.stack([s, -s], axis=1)


def _tones(n, *tones):
    """Pure tones (frequency, amplitude), the channels opposite."""
    t = np.arange(n) / SR
    x = sum(a * np.sin(2 * np.pi * f * t) for f, a in tones)
    return x[:, None] * [1.0, -1.0]


def _dither(n, ch, bits):
    rng = np.random.default_rng(4)
    return rng.integers(-1, 2, (n, ch)) / 2.0 ** (bits - 1)


# name -> (samples, subtype); the samples float, as a processor writes them
CORPUS = {
    "programme": lambda: (_programme(10.0), "PCM_24"),
    "programme_quiet": lambda: (_programme(3.0, [-12.0, -12.0]), "PCM_24"),
    "programme_loud": lambda: (_programme(3.0, [12.0, 12.0]), "PCM_24"),
    "white_noise": lambda: (np.random.default_rng(1).uniform(
        -1, 1, (3 * BLOCK + 100, 2)), "PCM_24"),
    "white_noise_mono16": lambda: (np.random.default_rng(2).uniform(
        -1, 1, (2 * BLOCK + 7, 1)), "PCM_16"),
    "silence": lambda: (np.zeros((2 * BLOCK + 50, 2)), "PCM_24"),
    "dc_offset": lambda: (np.full((2 * BLOCK + 50, 2), 0.25), "PCM_24"),
    "dither_lsb": lambda: (_dither(3 * BLOCK, 2, 24), "PCM_24"),
    "dither_lsb16": lambda: (_dither(3 * BLOCK, 2, 16), "PCM_16"),
    "full_scale_side": lambda: (_extreme(3 * BLOCK + 5), "PCM_24"),
    # pure tones, whose LPC coefficients turn on the autocorrelation's last
    # bits: an unfused sum where the encoder fuses changes their bytes
    "pure_tones": lambda: (_tones(100_000, (997.0, 0.1), (3000.0, 0.1)),
                           "PCM_24"),
    "pure_tone_loud": lambda: (_tones(100_000, (3000.0, 0.99)), "PCM_24"),
    "pcm24_stereo": lambda: (_tone(3 * BLOCK + 11, 2, seed=5), "PCM_24"),
    "pcm24_mono": lambda: (_tone(3 * BLOCK + 11, 1, seed=6), "PCM_24"),
    "pcm16_stereo": lambda: (_tone(3 * BLOCK + 11, 2, seed=7), "PCM_16"),
    "pcm16_mono": lambda: (_tone(3 * BLOCK + 11, 1, seed=8), "PCM_16"),
    "last_block_1": lambda: (_tone(2 * BLOCK + 1, 2, seed=9), "PCM_24"),
    "last_block_4095": lambda: (_tone(2 * BLOCK + 4095, 2, seed=10), "PCM_24"),
    "frames_4097": lambda: (_tone(BLOCK + 1, 2, seed=11), "PCM_24"),
    "frame_numbers_2_bytes": lambda: (_tone(130 * BLOCK + 300, 1, amp=0.01,
                                            seed=12), "PCM_16"),
}

_CUTS = (1, 4095, 4097, 7000, 2 ** 17 + 13)     # then 5 s pieces


def _pieces(n):
    """Uneven flush-cut-sized pieces over n frames: _CUTS, then 5 s."""
    at, k = 0, 0
    while at < n:
        c = _CUTS[k] if k < len(_CUTS) else 5 * SR
        yield at, min(n, at + c)
        at, k = min(n, at + c), k + 1


def _port_file(path, x, subtype, how):
    """x through the port's writer: one write of the floats, or the
    PCM_24 bytes (for PCM_16 the floats) in flush-cut-sized pieces."""
    if how == "write":
        audio.write(path, x, SR, subtype=subtype)
        return
    with flac_mod.FlacWriter(path, SR, x.shape[1], subtype) as w:
        if subtype != "PCM_24":
            for a, b in _pieces(len(x)):
                w.write(x[a:b])
            return
        v = np.clip(np.rint(x * 8388608.0), -8388608, 8388607).astype(np.int32)
        raw = le24_from_i32(v.reshape(-1))
        ch3 = 3 * x.shape[1]
        for a, b in _pieces(len(x)):
            w.write_raw(raw[a * ch3:b * ch3])


@pytest.mark.parametrize("how", ["write", "pieces"])
@pytest.mark.parametrize("case", sorted(CORPUS))
def test_corpus_bytes_equal_the_jax_encoder(tmp_path, case, how):
    x, subtype = CORPUS[case]()
    x = np.asarray(x, np.float32)
    port, ref = tmp_path / "port.flac", tmp_path / "jax.flac"
    _port_file(port, x, subtype, how)
    jaudio.write(ref, x, SR, subtype=subtype)
    assert port.read_bytes() == ref.read_bytes()


def _header(data, p):
    """(header length with its CRC-8, frame number) of a frame header at
    p whose CRC-8 holds, else None."""
    if data[p:p + 2] != b"\xff\xf8" or p + 6 > len(data):
        return None
    bs_code = data[p + 2] >> 4       # 12: 4096 frames, 7: 16 bits after
    lead = data[p + 4]
    n_num = 1 if lead < 0x80 else 8 - (~lead & 0xFF).bit_length()
    if lead >= 0x80 and not 2 <= n_num <= 7:
        return None
    num = lead if n_num == 1 else lead & (0x7F >> n_num)
    for b in data[p + 5:p + 4 + n_num]:
        if b & 0xC0 != 0x80:
            return None
        num = (num << 6) | (b & 0x3F)
    h = 4 + n_num + (2 if bs_code == 7 else 0)
    if p + h >= len(data) or crc8(data[p:p + h]) != data[p + h]:
        return None
    return h + 1, num


def _frames(data):
    """Every frame's (offset, length, number, block size): a frame starts
    at a sync code whose header's CRC-8 holds and numbers one more than
    the last, and ends where the next starts, its CRC-16 holding."""
    pos = 4
    while True:                                   # the metadata blocks
        last, size = data[pos] & 0x80, int.from_bytes(data[pos + 1:pos + 4],
                                                      "big")
        pos += 4 + size
        if last:
            break
    frames = []
    while pos < len(data):
        head = _header(data, pos)
        assert head is not None and head[1] == len(frames), (pos, head)
        bs_code = data[pos + 2] >> 4
        bsize = {12: 4096}.get(bs_code) or int.from_bytes(
            data[pos + head[0] - 3:pos + head[0] - 1], "big") + 1
        end, at = len(data), pos + head[0]
        while (at := data.find(b"\xff\xf8", at)) >= 0:
            nxt = _header(data, at)
            if nxt and nxt[1] == len(frames) + 1 and crc16(data[pos:at - 2]) \
                    == int.from_bytes(data[at - 2:at], "big"):
                end = at
                break
            at += 1
        assert crc16(data[pos:end - 2]) == int.from_bytes(data[end - 2:end],
                                                          "big"), len(frames)
        frames.append((pos, end - pos, head[1], bsize))
        pos = end
    return frames


@pytest.mark.parametrize("case", sorted(CORPUS))
def test_every_frame_crc_recomputed_bitwise(tmp_path, case):
    """The port's table CRCs against test_flac_spec's bitwise ones, in
    every frame of the case: the native and pure readers decode without
    checking either, so only this holds them."""
    x, subtype = CORPUS[case]()
    path = tmp_path / "port.flac"
    audio.write(path, np.asarray(x, np.float32), SR, subtype=subtype)
    frames = _frames(path.read_bytes())
    assert len(frames) == -(-len(x) // BLOCK)
    assert [f[2] for f in frames] == list(range(len(frames)))
    assert sum(f[3] for f in frames) == len(x)
