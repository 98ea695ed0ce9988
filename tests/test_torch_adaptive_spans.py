"""The adaptive processor's spans (tomatis_tpu_torch/models/adaptive.py on
utils/trace.py): under trace.timeline() a file-to-file `process` and a
`process_array` record their stage spans on the calling thread, all with
the call's job id, nested as the stages are; each stage timer is the sum
of its spans; one adaptive.probe row per probe that search_probes counts;
no rows with the timeline off; and the module's bare stage timer is gone."""
import inspect
import os

import numpy as np
import pytest
import torch

from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.models import adaptive as ad
from tomatis_tpu_torch.utils import trace

torch.set_num_threads(2)
SR = 48000
FPC = 32

# span name -> (the timer it sums into, or None, and its parents)
SPANS = {
    "adaptive.peak_scan": ("peak_scan_s", {None}),
    "adaptive.levels": ("levels_s", {None}),
    "adaptive.search": ("threshold_search_s", {None}),
    "adaptive.probe": (None, {"adaptive.search"}),
    "adaptive.gate_ramp": ("gate_ramp_s", {None}),
    "adaptive.csv": ("state_csv_s", {None}),
    "adaptive.pass3": ("pass3_s", {None}),
    "adaptive.step": ("step_s", {"adaptive.pass3"}),
    "adaptive.stage_write": ("stage_write_s", {"adaptive.pass3"}),
    "adaptive.finalize": ("restore_protect_s", {None}),
    "adaptive.stage_read": (None, {"adaptive.finalize"}),
    "writer.encode": ("encode_s", {"adaptive.finalize"}),
    "writer.close": ("encode_s", {"adaptive.finalize"}),
    "adaptive.decode": ("decode_s", {"adaptive.peak_scan", "adaptive.levels",
                                     "adaptive.pass3"}),
}


def _sig(seconds, seed=0):
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    env = 0.003 + 0.1 * (np.sin(2 * np.pi * 0.4 * t) > 0)
    x = env * (np.sin(2 * np.pi * 700 * t) + 0.05 * rng.standard_normal(n))
    return np.stack([x, 0.9 * x], 1).astype(np.float32)


@pytest.fixture
def flac(tmp_path):
    path = tmp_path / "in.flac"
    audio.write(path, _sig(6.0), SR, subtype="PCM_24")
    return path


def _job_rows(job):
    return [r for r in trace.rows() if r.job == job]


def test_process_spans_on_the_calling_thread(tmp_path, flac):
    with trace.timeline():
        st = ad.process(flac, tmp_path / "o.flac", ad.AdaptiveParams(),
                        state_csv_path=tmp_path / "s.csv",
                        frames_per_chunk=FPC, device="cpu")
        st2 = ad.process(flac, tmp_path / "o2.flac", ad.AdaptiveParams(),
                         frames_per_chunk=FPC, device="cpu")
    assert st["job_id"] != st2["job_id"]
    rows = _job_rows(st["job_id"])
    assert {r.thread for r in rows} == {"MainThread"}
    assert {r.name for r in rows} == set(SPANS)
    for r in rows:
        assert r.parent in SPANS[r.name][1], r
    probes = [r for r in rows if r.name == "adaptive.probe"]
    assert len(probes) == st["search_probes"] >= 1
    assert [r.at for r in probes] == list(range(len(probes)))
    steps = [r.at for r in rows if r.name == "adaptive.step"]
    assert steps == list(range(0, st["n_frames"], FPC))
    # each timer is the sum of its spans
    t = st["timings"]
    sums = {}
    for r in rows:
        key = SPANS[r.name][0]
        if key is not None:
            sums[key] = sums.get(key, 0.0) + (r.t1 - r.t0)
    for key, total in sums.items():
        assert t[key] == pytest.approx(total, rel=1e-9, abs=1e-9), key


def test_process_array_spans(flac):
    x, _ = audio.read(flac)
    with trace.timeline():
        _, info = ad.process_array(x, SR, ad.AdaptiveParams(),
                                   frames_per_chunk=FPC, device="cpu")
    names = {r.name for r in _job_rows(info["job_id"])}
    assert names == {"adaptive.peak_scan", "adaptive.levels",
                     "adaptive.search", "adaptive.probe",
                     "adaptive.gate_ramp", "adaptive.pass3", "adaptive.step",
                     "adaptive.finalize"}
    assert info["search_probes"] >= 1
    assert set(info["timings"]) == {"peak_scan_s", "levels_s",
                                    "threshold_search_s", "gate_ramp_s",
                                    "pass3_s", "step_s",
                                    "restore_protect_s"}


def test_timeline_off_keeps_no_rows_and_times_all_the_same(tmp_path, flac,
                                                          monkeypatch):
    monkeypatch.delenv("TOMATIS_TRACE", raising=False)
    st = ad.process(flac, tmp_path / "o.flac", ad.AdaptiveParams(),
                    frames_per_chunk=FPC, device="cpu")
    assert _job_rows(st["job_id"]) == []
    t = st["timings"]
    assert {"peak_scan_s", "levels_s", "threshold_search_s", "gate_ramp_s",
            "state_csv_s", "pass3_s", "step_s", "stage_write_s",
            "restore_protect_s", "encode_s", "decode_s",
            "wall_s"} == set(t)
    assert not os.path.exists(str(tmp_path / "o.flac") + ".stage.wav")


def test_the_bare_stage_timer_is_gone():
    assert not hasattr(ad, "_lap")
    assert "_lap(" not in inspect.getsource(ad)
