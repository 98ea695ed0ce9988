"""Segment finders, a copy of tomatis_tpu/analysis/segments.py over the
port's io.audio (capability parity with ref src/find_main_segment.py,
src/find_start_smart.py, src/find_end_smart.py). Host numpy throughout.

The smart start/end finders used librosa (absent in this image); the RMS /
spectral-centroid / zero-crossing-rate features are reimplemented here in
NumPy with librosa's framing conventions (centered frames)."""
from __future__ import annotations

import numpy as np

from tomatis_tpu_torch.io import audio

EPS = 1e-12


# ---------------------------------------------------------------------------
# feature helpers (librosa-equivalent, centered framing)
# ---------------------------------------------------------------------------

def _frames_centered(y: np.ndarray, frame_length: int, hop_length: int):
    pad = frame_length // 2
    yp = np.pad(y, (pad, pad), mode="constant")
    n = 1 + (len(yp) - frame_length) // hop_length
    idx = np.arange(n)[:, None] * hop_length + np.arange(frame_length)[None, :]
    return yp[idx]


def rms_track(y, frame_length: int, hop_length: int) -> np.ndarray:
    fr = _frames_centered(y, frame_length, hop_length)
    return np.sqrt(np.mean(fr * fr, axis=1))


def spectral_centroid_track(y, sr: int, frame_length: int,
                            hop_length: int) -> np.ndarray:
    fr = _frames_centered(y, frame_length, hop_length)
    win = np.hanning(frame_length).astype(np.float32)
    mag = np.abs(np.fft.rfft(fr * win, axis=1))
    freqs = np.fft.rfftfreq(frame_length, 1 / sr)
    denom = np.sum(mag, axis=1) + EPS
    return np.sum(mag * freqs[None, :], axis=1) / denom


def zcr_track(y, frame_length: int, hop_length: int) -> np.ndarray:
    fr = _frames_centered(y, frame_length, hop_length)
    signs = np.signbit(fr)
    return np.mean(signs[:, 1:] != signs[:, :-1], axis=1)


# ---------------------------------------------------------------------------
# find_main_segment (ref :28-121)
# ---------------------------------------------------------------------------

def find_main_segment(in_path, win_ms: float = 100.0, hop_ms: float = 50.0,
                      margin_db: float = 15.0, min_seg_sec: float = 60.0,
                      pad_sec: float = 0.5) -> dict:
    """Noise floor = p10 of windowed RMS; active = floor + margin; pick the
    longest active run and pad it."""
    with audio.AudioFile(in_path, "r") as f:
        sr = f.samplerate
        ch = f.channels
        dur = f.frames / sr
        if ch != 2:
            raise ValueError(f"expected stereo, got {ch} channels")
        win = int(sr * win_ms / 1000.0)
        hop = int(sr * hop_ms / 1000.0)
        levels = []
        pend = np.zeros((0, ch), np.float32)
        while True:
            blk = f.read(sr * 10)
            if len(blk) == 0:
                break
            pend = np.concatenate([pend, blk])
            n = (len(pend) - win) // hop + 1
            for i in range(max(0, n)):
                fr = pend[i * hop:i * hop + win]
                r = np.sqrt(np.mean(fr * fr) + EPS)
                levels.append(20 * np.log10(r + EPS))
            if n > 0:
                pend = pend[n * hop:]
    levels = np.asarray(levels, np.float32)
    win_sec = win / sr
    times = np.arange(len(levels)) * hop / sr

    noise_floor = float(np.percentile(levels, 10))
    thr = noise_floor + margin_db
    active = levels >= thr
    res = dict(sr=sr, duration=dur, noise_floor=noise_floor, threshold=thr)
    if not active.any():
        res["found"] = False
        return res
    # longest active run
    d = np.diff(active.astype(np.int8), prepend=0, append=0)
    starts = np.flatnonzero(d == 1)
    ends = np.flatnonzero(d == -1)
    lens = (times[np.minimum(ends - 1, len(times) - 1)] + win_sec
            - times[starts])
    k = int(np.argmax(lens))
    t0, t1 = float(times[starts[k]]), float(
        times[min(ends[k] - 1, len(times) - 1)] + win_sec)
    res.update(found=lens[k] >= min_seg_sec, start=t0, end=t1,
               length=float(lens[k]),
               start_padded=max(0.0, t0 - pad_sec),
               end_padded=min(dur, t1 + pad_sec))
    return res


# ---------------------------------------------------------------------------
# find_start_smart (ref :5-65) / find_end_smart (ref :5-72)
# ---------------------------------------------------------------------------

def find_start_smart(in_path, search_duration: float = 30.0,
                     focus=(14.0, 19.0)) -> dict:
    """RMS + centroid + ZCR over the head; dynamic threshold (noise floor
    + 15 dB, at least -50); candidates = >5 dB jumps in the focus window."""
    meta = audio.info(in_path)
    sr = meta.samplerate
    x, _ = audio.read(in_path, frames=int(search_duration * sr))
    y = x.mean(axis=1).astype(np.float32)
    hop = int(sr * 0.05)
    frame = int(sr * 0.1)
    rms = rms_track(y, frame, hop)
    db = 20 * np.log10(rms + 1e-9)
    cent = spectral_centroid_track(y, sr, frame, hop)
    zcr = zcr_track(y, frame, hop)
    times = np.arange(len(rms)) * hop / sr

    head = db[:int(1.0 / 0.05)]
    noise_floor = float(np.mean(head)) if len(db) > 20 else -80.0
    threshold = max(noise_floor + 15, -50.0)

    candidates = []
    for i in range(1, len(db)):
        t = times[i]
        if focus[0] <= t <= focus[1] and (db[i] - db[i - 1]) > 5.0:
            candidates.append(float(t))
    return dict(sr=sr, times=times, db=db, centroid=cent, zcr=zcr,
                noise_floor=noise_floor, threshold=threshold,
                candidates=candidates)


def find_end_smart(in_path, search_duration: float = 30.0) -> dict:
    """Reverse scan of the tail: last sustained point above the tail-noise
    threshold; +1 s reverb margin in the recommendation."""
    meta = audio.info(in_path)
    sr = meta.samplerate
    total_dur = meta.frames / sr
    start_search = max(0.0, total_dur - search_duration)
    x, _ = audio.read(in_path, frames=int(search_duration * sr),
                      start=int(start_search * sr))
    y = x.mean(axis=1).astype(np.float32)
    hop = int(sr * 0.1)
    frame = int(sr * 0.2)
    rms = rms_track(y, frame, hop)
    db = 20 * np.log10(rms + 1e-9)
    times = np.arange(len(rms)) * hop / sr + start_search

    noise_floor = float(np.mean(db[-10:])) if len(db) > 10 else -80.0
    threshold = max(noise_floor + 15, -60.0)

    last_music_time = total_dur
    found = False
    for i in range(len(db) - 1, -1, -1):
        if db[i] > threshold and i > 5 and np.mean(db[i - 5:i]) > threshold:
            last_music_time = float(times[i])
            found = True
            break
    rec = min(total_dur, last_music_time + 1.0) if found \
        and last_music_time < total_dur - 0.5 else None
    return dict(sr=sr, duration=total_dur, noise_floor=noise_floor,
                threshold=threshold, end_time=last_music_time,
                found=found, recommended_cut=rec)
