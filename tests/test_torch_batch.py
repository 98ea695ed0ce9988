"""The port's batch processor (tomatis_tpu_torch/parallel/batch.py): the
cases of tests/test_batch.py on the CPU, against the port's single-file
`process` (bytes and state CSVs equal: the batch never ramps, and at 16
frames per chunk neither does `process`) and against the JAX package's
`process_batch` on the same numpy-seeded inputs (samples within 4 LSB, the
standing FFT difference of ROADMAP.md §3; states and frame indices equal;
levels within 1e-4 dB)."""
import csv

import numpy as np
import pytest
import torch

from tomatis_tpu.parallel import batch as jbatch
from tomatis_tpu.models import standard as jstd
from tomatis_tpu_torch.cli import main as cli_main
from tomatis_tpu_torch.engine import streaming
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.models import standard
from tomatis_tpu_torch.models.standard import StandardParams, process
from tomatis_tpu_torch.parallel import batch
from tomatis_tpu_torch.parallel.batch import process_batch

# two intra-op threads: the suite runs several workers side by side
torch.set_num_threads(2)
SR = 48000
FPC = 16
LSB = 4
LEVEL_ATOL = 1e-4


def _sig(seconds, seed, quiet=0.002, loud=0.06):
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    env = quiet + loud * (np.sin(2 * np.pi * (0.5 + 0.1 * seed) * t) > 0)
    x = env * (np.sin(2 * np.pi * (300 + 50 * seed) * t)
               + 0.05 * rng.standard_normal(n))
    return np.clip(np.stack([x, 0.9 * x], 1), -1, 1).astype(np.float32)


def _batch(jobs, p, **kw):
    kw.setdefault("frames_per_chunk", FPC)
    return process_batch(jobs, p, device="cpu", **kw)


def _files(tmp_path, seconds, seed0=0, ext="flac"):
    jobs = []
    for i, sec in enumerate(seconds):
        ip = tmp_path / f"in{i}.{ext}"
        audio.write(ip, _sig(sec, seed0 + i), SR, subtype="PCM_24")
        jobs.append((ip, tmp_path / f"out{i}.{ext}"))
    return jobs


def _same_bytes(a, b) -> bool:
    return open(a, "rb").read() == open(b, "rb").read()


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_batch_matches_single(tmp_path):
    p = StandardParams(require_48k_stereo=False)
    jobs = _files(tmp_path, [3.0, 2.2, 4.1])        # unequal lengths
    csvs = [tmp_path / f"st{i}.csv" for i in range(3)]
    stats = _batch(jobs, p, state_csv_paths=csvs)
    assert all(s["failed"] is None for s in stats)
    assert batch.LAST_TIMINGS["chunks"] == -(-max(s["n_frames"]
                                                  for s in stats) // FPC)
    for i, (ip, op) in enumerate(jobs):
        ref_o, ref_c = tmp_path / f"ref{i}.flac", tmp_path / f"refst{i}.csv"
        st = process(ip, ref_o, p, state_csv_path=ref_c,
                     frames_per_chunk=FPC, device="cpu")
        assert _same_bytes(op, ref_o) and _same_bytes(csvs[i], ref_c)
        assert (stats[i]["c1_frames"], stats[i]["c2_frames"]) == \
            (st["c1_frames"], st["c2_frames"])


def test_batch_matches_jax_process_batch(tmp_path):
    p = StandardParams(require_48k_stereo=False)
    jp = jstd.StandardParams(require_48k_stereo=False)
    jobs = _files(tmp_path, [2.5, 1.7, 3.3], seed0=4)
    csvs = [tmp_path / f"st{i}.csv" for i in range(3)]
    jjobs = [(ip, tmp_path / f"j{i}.flac") for i, (ip, _) in enumerate(jobs)]
    jcsvs = [tmp_path / f"jst{i}.csv" for i in range(3)]
    stats = _batch(jobs, p, state_csv_paths=csvs)
    jstats = jbatch.process_batch(jjobs, jp, frames_per_chunk=FPC,
                                  state_csv_paths=jcsvs)
    for i in range(3):
        for k in ("failed", "n_frames", "sr", "c1_frames", "c2_frames"):
            assert stats[i][k] == jstats[i][k], k
        y, _ = audio.read(jobs[i][1])
        jy, _ = audio.read(jjobs[i][1])
        assert y.shape == jy.shape
        d = np.abs(np.rint(y * 8388608.0) - np.rint(jy * 8388608.0))
        assert d.max() <= LSB
        rows, jrows = _read_csv(csvs[i]), _read_csv(jcsvs[i])
        assert [r["state"] for r in rows] == [r["state"] for r in jrows]
        assert [r["frame_idx"] for r in rows] == \
            [r["frame_idx"] for r in jrows]
        np.testing.assert_allclose(
            [float(r["level_dbfs"]) for r in rows],
            [float(r["level_dbfs"]) for r in jrows], atol=LEVEL_ATOL)


def test_batch_chunk_fn_is_single_chunk_fn_per_lane():
    """The batched step equals the single-file step lane by lane: full,
    partial and empty lanes, and an empty lane freezes every carry."""
    p = StandardParams(require_48k_stereo=False)
    n_fft, hop, C, F = p.n_fft, p.hop, 2, 8
    ctl = standard.build_controller(p, SR, "cpu")
    eng = streaming.ChunkedStftEngine(n_fft, hop, C, F, device="cpu")
    beng = streaming.ChunkedStftEngine(n_fft, hop, C, F, device="cpu")
    fn = eng.make_chunk_fn(ctl, transport="pcm24")
    bfn = beng.make_batch_chunk_fn(ctl)
    rng = np.random.default_rng(5)
    n_valid = [F, 5, 0]
    B, L, tail = len(n_valid), eng.chunk_input_len, eng.tail_len
    sig = torch.from_numpy(
        (0.05 * rng.standard_normal((B, L, C))).astype(np.float32))
    ot = torch.from_numpy(
        (0.01 * rng.standard_normal((B, tail, C))).astype(np.float32))
    wt = torch.from_numpy(rng.uniform(0.3, 1, (B, tail)).astype(np.float32))
    carries = [torch.tensor(v, dtype=torch.int32) for v in (1, 2, 2)]
    gain = torch.tensor(0.8)
    pcm, aux, out, c2, ot2, wt2 = bfn(
        sig, torch.tensor(n_valid, dtype=torch.int32), carries, ot, wt,
        ctl.params(), gain)
    for b, nv in enumerate(n_valid):
        ref = fn(sig[b], nv, carries[b], ot[b], wt[b], ctl.params(), gain)
        for g, r in zip((pcm[b], aux[b], out[b], c2[b], ot2[b], wt2[b]),
                        ref):
            assert torch.equal(g, r), b
    assert int(c2[2]) == 2 and torch.equal(ot2[2], ot[2])


def test_batch_isolates_failures(tmp_path):
    p = StandardParams(require_48k_stereo=False)
    good = tmp_path / "good.flac"
    audio.write(good, _sig(2.0, 1), SR, subtype="PCM_24")
    bad = tmp_path / "missing.flac"          # doesn't exist
    corrupt = tmp_path / "corrupt.flac"
    corrupt.write_bytes(b"not a flac file at all")
    jobs = [(bad, tmp_path / "o0.flac"),
            (good, tmp_path / "o1.flac"),
            (corrupt, tmp_path / "o2.flac")]
    stats = _batch(jobs, p)
    assert stats[0]["failed"] is not None
    assert stats[2]["failed"] is not None
    assert stats[1]["failed"] is None
    y, _ = audio.read(tmp_path / "o1.flac")
    assert len(y) == int(2.0 * SR)


def test_batch_failure_pattern_equals_jax(tmp_path):
    """Missing, corrupt, wrong-rate and zero-length lanes beside good ones:
    the same lanes fail on both packages, the rest match within 4 LSB."""
    p = StandardParams()                      # strict 48 kHz stereo
    jp = jstd.StandardParams()
    ok1, ok2 = tmp_path / "ok1.flac", tmp_path / "ok2.wav"
    audio.write(ok1, _sig(1.6, 1), SR, subtype="PCM_24")
    audio.write(ok2, _sig(1.1, 2), SR, subtype="PCM_24")
    rate = tmp_path / "rate.wav"
    audio.write(rate, _sig(1.0, 3)[:44100], 44100, subtype="PCM_24")
    empty = tmp_path / "empty.wav"
    audio.write(empty, np.zeros((0, 2), np.float32), SR, subtype="PCM_24")
    corrupt = tmp_path / "corrupt.flac"
    corrupt.write_bytes(b"fLaC but nothing else")
    ins = [tmp_path / "missing.flac", ok1, rate, empty, corrupt, ok2]
    outs = {}
    for tag, fn in (("port", lambda j: _batch(j, p)),
                    ("jax", lambda j: jbatch.process_batch(
                        j, jp, frames_per_chunk=FPC))):
        jobs = [(ip, tmp_path / f"{tag}{i}{ip.suffix}")
                for i, ip in enumerate(ins)]
        outs[tag] = (fn(jobs), jobs)
    (st, jobs), (jst, jjobs) = outs["port"], outs["jax"]
    assert [s["failed"] is None for s in st] == \
        [s["failed"] is None for s in jst] == \
        [False, True, False, True, False, True]
    assert [s["n_frames"] for s in st] == [s["n_frames"] for s in jst]
    for i in (1, 3, 5):
        y, _ = audio.read(jobs[i][1])
        jy, _ = audio.read(jjobs[i][1])
        assert y.shape == jy.shape
        if len(y):
            assert np.abs(np.rint(y * 8388608.0)
                          - np.rint(jy * 8388608.0)).max() <= LSB


def test_batch_rejects_rate_mismatch_per_file(tmp_path):
    p = StandardParams()  # strict 48k stereo
    a = tmp_path / "a.flac"
    b = tmp_path / "b.flac"
    audio.write(a, _sig(1.5, 2), SR, subtype="PCM_24")
    audio.write(b, _sig(1.0, 3)[:, :1], SR, subtype="PCM_24")  # mono
    stats = _batch([(a, tmp_path / "oa.flac"), (b, tmp_path / "ob.flac")], p)
    assert stats[0]["failed"] is None
    assert "stereo" in stats[1]["failed"] or "48" in stats[1]["failed"]


def test_all_files_unopenable_returns_failed_stats(tmp_path):
    jobs = [(tmp_path / "nope1.flac", tmp_path / "o1.flac"),
            (tmp_path / "nope2.flac", tmp_path / "o2.flac")]
    stats = _batch(jobs, StandardParams(require_48k_stereo=False))
    assert len(stats) == 2
    assert all(s["failed"] is not None for s in stats)
    assert all(s["n_frames"] == 0 for s in stats)


def test_batch_exact_chunk_boundary_lane_matches_single(tmp_path):
    """A shorter lane whose frame count is an exact multiple of
    frames_per_chunk keeps riding the launch with n_valid = 0: those
    chunks must not wipe its OLA tail, which its final flush needs."""
    p = StandardParams(require_48k_stereo=False)
    total_short = 48 * 2048            # 48 frames = 3 chunks of 16
    rng = np.random.default_rng(3)
    t = np.arange(total_short) / SR
    x_short = (0.05 * np.sin(2 * np.pi * 500 * t)
               + 0.001 * rng.standard_normal(total_short))
    x_short = np.stack([x_short, 0.9 * x_short], 1).astype(np.float32)
    t2 = np.arange(int(4.3 * SR)) / SR
    x_long = (0.04 * np.sin(2 * np.pi * 800 * t2)).astype(np.float32)
    x_long = np.stack([x_long, x_long], 1)
    ps, pl = tmp_path / "short.flac", tmp_path / "long.flac"
    audio.write(ps, x_short, SR, subtype="PCM_24")
    audio.write(pl, x_long, SR, subtype="PCM_24")
    ref = tmp_path / "ref.flac"
    st = process(ps, ref, p, frames_per_chunk=FPC, device="cpu")
    assert st["n_frames"] % FPC == 0
    outs, outl = tmp_path / "s_out.flac", tmp_path / "l_out.flac"
    stats = _batch([(ps, outs), (pl, outl)], p)
    assert all(s["failed"] is None for s in stats)
    assert _same_bytes(outs, ref)


def test_batch_rejects_mismatched_csv_list(tmp_path):
    with pytest.raises(ValueError, match="state_csv_paths"):
        _batch([(tmp_path / "a.flac", tmp_path / "b.flac"),
                (tmp_path / "c.flac", tmp_path / "d.flac")],
               StandardParams(require_48k_stereo=False),
               state_csv_paths=[tmp_path / "one.csv"])


def test_zero_length_file_lane(tmp_path):
    p = StandardParams(require_48k_stereo=False)
    ez = tmp_path / "empty.wav"
    audio.write(ez, np.zeros((0, 2), np.float32), SR, subtype="PCM_24")
    ok = tmp_path / "ok.flac"
    audio.write(ok, _sig(1.0, 2), SR, subtype="PCM_24")
    stats = _batch([(ez, tmp_path / "eo.wav"), (ok, tmp_path / "oo.flac")],
                   p)
    assert [s["failed"] for s in stats] == [None, None], stats
    y, _ = audio.read(tmp_path / "eo.wav")
    assert len(y) == 0


def _sabotaged_open(monkeypatch, target, what):
    orig_open = batch._Lane.open

    def open_and_sabotage(self, sr, ch):
        orig_open(self, sr, ch)
        if not self.in_path.endswith(target):
            return
        if what == "read":
            orig_window = self.rolling.window

            def window(start, n):
                if start > SR // 2:
                    raise IOError("disk went away")
                return orig_window(start, n)
            self.rolling.window = window
        else:
            written = [0]
            orig_write = self.writer.write_raw

            def write_raw(buf):
                written[0] += len(buf)
                if written[0] > 8192:
                    raise IOError("sink full")
                return orig_write(buf)
            self.writer.write_raw = write_raw

    monkeypatch.setattr(batch._Lane, "open", open_and_sabotage)


@pytest.mark.parametrize("what,msg", [("read", "disk went away"),
                                      ("write", "sink full")])
def test_batch_midstream_failure_isolated(tmp_path, monkeypatch, what, msg):
    """A lane whose reader (producer thread) or writer (its own writer
    thread) dies mid-stream fails alone; the other lane matches the
    single-file run byte for byte."""
    p = StandardParams(require_48k_stereo=False)
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    audio.write(a, _sig(2.0, 1), SR, subtype="PCM_24")
    audio.write(b, _sig(2.0, 2), SR, subtype="PCM_24")
    out_single = tmp_path / "single.wav"
    process(b, out_single, p, frames_per_chunk=FPC, device="cpu")
    _sabotaged_open(monkeypatch, "a.wav", what)
    stats = _batch([(a, tmp_path / "oa.wav"), (b, tmp_path / "ob.wav")], p)
    assert stats[0]["failed"] is not None and msg in stats[0]["failed"]
    assert stats[1]["failed"] is None
    assert _same_bytes(out_single, tmp_path / "ob.wav")


def test_devices_n_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="devices"):
        _batch([(tmp_path / "a.flac", tmp_path / "b.flac")],
               StandardParams(), devices=2)


def test_batch_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour of a host without a card")
    ip = tmp_path / "a.wav"
    audio.write(ip, _sig(0.5, 1), SR, subtype="PCM_24")
    with pytest.raises(RuntimeError, match="CUDA"):
        process_batch([(ip, tmp_path / "o.wav")], StandardParams())


def test_process_batch_cli(tmp_path, capsys):
    jobs = _files(tmp_path, [1.2, 0.8], seed0=6)
    ins = [str(ip) for ip, _ in jobs] + [str(tmp_path / "missing.flac")]
    outdir, csvdir = tmp_path / "out", tmp_path / "csv"
    rc = cli_main.main(["process-batch", "-i", *ins, "-o", str(outdir),
                        "--state_csv_dir", str(csvdir), "--frames_per_chunk",
                        str(FPC), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 1                       # one file failed
    assert out.count("[OK]") == 2 and out.count("[FAIL]") == 1
    assert "2/3 files" in out
    p = StandardParams()
    for i, (ip, _) in enumerate(jobs):
        ref = tmp_path / f"ref{i}.flac"
        process(ip, ref, p, state_csv_path=tmp_path / f"ref{i}.csv",
                frames_per_chunk=FPC, device="cpu")
        assert _same_bytes(outdir / f"in{i}_tomatis.flac", ref)
        assert _same_bytes(csvdir / f"in{i}.csv", tmp_path / f"ref{i}.csv")
    rc = cli_main.main(["process-batch", "-i", ins[0], "-o", str(outdir),
                        "--devices", "2", "--device", "cpu"])
    assert rc == 1 and "not ported" in capsys.readouterr().out
