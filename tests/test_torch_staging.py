"""The port's process-based input staging (tomatis_tpu_torch/engine/
staging.py): the cases of tests/test_staging.py on the port's `process`
(CPU, transport="wire": the staging process serves wire-input files) plus
what the port adds to the contract: the staging module and its worker
import neither torch nor jax, and threaded, process-staged and resumed
runs all write the in-order bytes, on every transport."""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from tomatis_tpu_torch.engine import staging
from tomatis_tpu_torch.engine import streaming as S
from tomatis_tpu_torch.io import audio, wirecodec
from tomatis_tpu_torch.models.standard import StandardParams, process

# two intra-op threads: the suite runs several workers side by side, and
# torch ops called from the stream's helper threads each bring a pool
torch.set_num_threads(2)
SR = 48000
P = StandardParams(gate_ui=50.0, hysteresis_db=3.0, up_delay_ms=250.0,
                   require_48k_stereo=False)
# > 8 chunks at fpc=64 (the engagement threshold) while staying small
# enough for the CPU: 30 s = ~700 frames = 11 chunks
FPC = 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _signal(seconds, seed=3):
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    env = 0.004 + 0.2 * (np.sin(2 * np.pi * 0.45 * t) > 0)
    x = env * (np.sin(2 * np.pi * 500 * t)
               + 0.4 * np.sin(2 * np.pi * 3000 * t)
               + 0.02 * rng.standard_normal(n))
    return np.clip(np.stack([x, 0.9 * x], 1), -1, 1).astype(np.float32)


@pytest.fixture()
def infile(tmp_path):
    ip = tmp_path / "in.wav"
    audio.write(ip, _signal(30.0, seed=21), SR, subtype="PCM_24")
    return ip


def _process(ip, op, **kw):
    kw.setdefault("transport", "wire")
    return process(ip, op, P, frames_per_chunk=FPC, device="cpu", **kw)


def test_staging_module_is_torch_free():
    """Importing engine.staging (what the worker process does) and
    running its entry point's imports leaves torch and jax out of
    sys.modules: the worker's start-up is paid per parent process and it
    must never create a CUDA context."""
    code = (
        "import sys\n"
        "import tomatis_tpu_torch.engine.staging as st\n"
        "from tomatis_tpu_torch.io import audio, wirecodec\n"
        "from tomatis_tpu_torch.utils.rolling import RollingReader\n"
        "import numpy as np\n"
        "v = np.arange(2048, dtype=np.int32).reshape(1024, 2)\n"
        "kind, buf = st.host_encode(v, True, False)\n"
        "assert kind == 'wire' and (wirecodec.decode_i32(buf, 1024, 2) == v)"
        ".all()\n"
        "bad = [m for m in ('torch', 'jax') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_process_staging_matches_thread_path(infile, tmp_path, monkeypatch):
    monkeypatch.setenv("TOMATIS_PROCESS_STAGE", "0")
    ref = tmp_path / "ref.wav"
    st0 = _process(infile, ref, state_csv_path=tmp_path / "ref.csv")
    assert st0["producer"] == "thread"

    monkeypatch.setenv("TOMATIS_PROCESS_STAGE", "1")
    out = tmp_path / "out.wav"
    st1 = _process(infile, out, state_csv_path=tmp_path / "out.csv")
    assert st1["producer"] == "process"
    assert st1["wire"] == st0["wire"] and st1["wire"]["in_bytes"] > 0
    assert out.read_bytes() == ref.read_bytes()
    assert (tmp_path / "out.csv").read_bytes() \
        == (tmp_path / "ref.csv").read_bytes()

    # the singleton worker survives the run and is reused by the next
    assert staging._WORKER and staging._WORKER[0].alive()
    w0 = staging._WORKER[0]
    out2 = tmp_path / "out2.wav"
    _process(infile, out2)
    assert out2.read_bytes() == ref.read_bytes()
    assert staging._WORKER and staging._WORKER[0] is w0


@pytest.mark.parametrize("transport", ["pcm24", "f32"])
def test_raw_transports_keep_the_thread_producer(infile, tmp_path,
                                                 monkeypatch, transport):
    """The staging process serves wire-input streams only; pcm24 and f32
    read on the producer thread, and pcm24 writes the wire run's bytes."""
    monkeypatch.setenv("TOMATIS_PROCESS_STAGE", "1")
    out = tmp_path / "out.wav"
    st = _process(infile, out, transport=transport)
    assert st["producer"] == "thread" and st["chunks"] > 8
    if transport == "pcm24":
        ref = tmp_path / "ref.wav"
        _process(infile, ref)
        assert out.read_bytes() == ref.read_bytes()


def test_short_stream_keeps_the_thread_producer(tmp_path, monkeypatch):
    """<= 8 chunks: the worker's spawn would not amortise."""
    monkeypatch.setenv("TOMATIS_PROCESS_STAGE", "1")
    ip = tmp_path / "short.wav"
    audio.write(ip, _signal(10.0, seed=5), SR, subtype="PCM_24")
    st = _process(ip, tmp_path / "o.wav")
    assert st["producer"] == "thread" and st["chunks"] <= 8
    assert st["wire"]["in_bytes"] > 0


class _Bomb(Exception):
    pass


@pytest.mark.parametrize("stage", ["1", "0"], ids=["process", "thread"])
def test_process_staging_resume_byte_identical(infile, tmp_path,
                                               monkeypatch, stage):
    """Interrupt a checkpointed run and resume: the producer's schedule
    restarts at the resume frame and the spliced output and state CSV are
    byte-identical to an uninterrupted run."""
    monkeypatch.setenv("TOMATIS_PROCESS_STAGE", stage)
    ref = tmp_path / "ref.wav"
    _process(infile, ref, state_csv_path=tmp_path / "ref.csv")

    out = tmp_path / "out.wav"
    ck = tmp_path / "ck.npz"
    orig = S.StreamRunner._write_cut_pcm24
    calls = {"n": 0}

    def bomb(self, *a, **k):
        calls["n"] += 1
        if calls["n"] > 1:
            raise _Bomb()
        return orig(self, *a, **k)

    monkeypatch.setattr(S.StreamRunner, "_write_cut_pcm24", bomb)
    with pytest.raises(_Bomb):
        _process(infile, out, checkpoint_path=ck, checkpoint_every=2,
                 state_csv_path=tmp_path / "out.csv")
    monkeypatch.setattr(S.StreamRunner, "_write_cut_pcm24", orig)
    assert ck.exists()
    st = _process(infile, out, checkpoint_path=ck, checkpoint_every=2,
                  state_csv_path=tmp_path / "out.csv")
    assert not ck.exists()
    assert out.read_bytes() == ref.read_bytes()
    assert (tmp_path / "out.csv").read_bytes() \
        == (tmp_path / "ref.csv").read_bytes()
    assert st["chunks"] < 11, "the resumed run re-ran every chunk"


def test_concurrent_streams_use_dedicated_workers(infile, tmp_path,
                                                  monkeypatch):
    """Two overlapping staged streams must not cross pipes: the second
    gets a throwaway worker while the first holds the singleton."""
    monkeypatch.setenv("TOMATIS_PROCESS_STAGE", "1")
    outs = [tmp_path / "a.wav", tmp_path / "b.wav"]
    errs = []

    def run(o):
        try:
            _process(infile, o)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)
    ths = [threading.Thread(target=run, args=(o,)) for o in outs]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errs
    assert outs[0].read_bytes() == outs[1].read_bytes()


def test_worker_death_fails_loudly(infile, tmp_path, monkeypatch):
    """A worker killed mid-stream must surface as a run error (never
    silent truncation), and the next run must respawn cleanly."""
    monkeypatch.setenv("TOMATIS_PROCESS_STAGE", "1")
    real_stage = staging.stage_stream

    def capture(*a, **k):
        st = real_stage(*a, **k)
        st._w.kill()   # die before the first item arrives
        return st

    monkeypatch.setattr(S.staging, "stage_stream", capture)
    out = tmp_path / "out.wav"
    with pytest.raises(RuntimeError, match="staging worker"):
        _process(infile, out)
    monkeypatch.setattr(S.staging, "stage_stream", real_stage)

    ref = tmp_path / "ref.wav"
    st = _process(infile, ref)   # clean respawn
    assert st["producer"] == "process"
    monkeypatch.setenv("TOMATIS_PROCESS_STAGE", "0")
    thr = tmp_path / "thr.wav"
    _process(infile, thr)
    assert ref.read_bytes() == thr.read_bytes()


def test_worker_reports_stream_errors(tmp_path):
    """An exception inside the worker's stream (a missing file) comes
    back as a RuntimeError naming it, and the worker stays usable."""
    st = staging.stage_stream(str(tmp_path / "nope.wav"), True, 2, -2048,
                              1024, [(-2048, 4096, None)], False)
    with pytest.raises(RuntimeError, match="staging worker"):
        st.get()
    st.close()
    ip = tmp_path / "ok.wav"
    audio.write(ip, _signal(0.5), SR, subtype="PCM_24")
    st = staging.stage_stream(str(ip), True, 2, 0, 1024,
                              [(0, 4096, 4096), (4096, 4096, None)], False)
    kinds = [st.get()[0], st.get()[0]]
    with pytest.raises(StopIteration):
        st.get()
    st.close()
    assert kinds == ["wire", "wire"]


def test_decode_offload_matches_local_and_falls_back():
    """decode_pcm24 through the RPC worker is byte-identical to the
    local decoder, and a killed worker degrades to local decode."""
    rng = np.random.default_rng(5)
    v = (rng.standard_normal((48000, 2)) * 3e5).astype(np.int32)
    buf = wirecodec.encode_i32(v, rice=True)
    local = wirecodec.decode_pcm24(buf, len(v), 2)

    staging.ensure_rpc_worker()
    assert staging._RPC and staging._RPC[0].alive()
    assert staging.rpc_available()
    off = staging.decode_pcm24_offload(buf, len(v), 2)
    assert np.array_equal(off, local)

    staging._RPC[0].kill()   # dead worker: silent local fallback
    off2 = staging.decode_pcm24_offload(buf, len(v), 2)
    assert np.array_equal(off2, local)
    assert not staging.rpc_available()


def test_host_encode_offload_matches_local():
    """host_encode through the RPC worker returns the local item, for
    ints, PCM_24-exact floats and inexact floats (a result, not a
    failure)."""
    rng = np.random.default_rng(6)
    v = (rng.standard_normal((4096, 2)) * 2e5).astype(np.int32)
    x = v.astype(np.float32) / np.float32(8388608.0)
    staging.ensure_rpc_worker()
    assert staging.rpc_available()
    for sig, int_in in ((v, True), (x, False),
                        (x + np.float32(1e-8), False)):
        a = staging.host_encode_offload(sig, int_in, False)
        b = staging.host_encode(sig, int_in, False)
        assert a[0] == b[0]
        assert np.array_equal(a[1], b[1])
    assert a[0] == "raw_inexact"


def test_process_staging_env_switch(monkeypatch):
    monkeypatch.delenv("TOMATIS_PROCESS_STAGE", raising=False)
    assert staging.process_staging_enabled()
    monkeypatch.setenv("TOMATIS_PROCESS_STAGE", "0")
    assert not staging.process_staging_enabled()


def test_flac_source_through_the_staging_process(tmp_path, monkeypatch):
    """A FLAC source: the worker decodes it as PCM_24 ints and the run
    writes the bytes of the in-order pcm24 run."""
    ip = tmp_path / "in.flac"
    audio.write(ip, _signal(30.0, seed=9), SR, subtype="PCM_24")
    monkeypatch.setenv("TOMATIS_PROCESS_STAGE", "1")
    a, b = tmp_path / "a.flac", tmp_path / "b.flac"
    st = _process(ip, a, state_csv_path=tmp_path / "a.csv")
    assert st["producer"] == "process"
    _process(ip, b, transport="pcm24", state_csv_path=tmp_path / "b.csv")
    assert a.read_bytes() == b.read_bytes()
    assert (tmp_path / "a.csv").read_bytes() == \
        (tmp_path / "b.csv").read_bytes()
