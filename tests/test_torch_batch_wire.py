"""The port's wire batch (tomatis_tpu_torch/parallel/batch.py, which
process_batch picks on a link slower than WIRE_BATCH_LINK_MBPS; here the
link rate is held below it) on the CPU: every lane's file and state CSV
equal the
port's pcm24 batch byte for byte (the wire payload is the pcm24 launch's
bytes, losslessly compressed, so the comparison is exact); against the
JAX package's process_batch, whose single-device default is wire, samples
within 4 LSB (the standing FFT difference of ROADMAP.md §3), states and
frame indices equal, levels within 1e-4 dB, the input link bytes equal
(the same C++ encoder on the same windows) and the output link bytes
within 1% (the same device pack on PCM_24 ints up to 4 LSB apart)."""
import contextlib
import csv
import math

import numpy as np
import pytest
import torch

from tomatis_tpu.models import standard as jstd
from tomatis_tpu.parallel import batch as jbatch
from tomatis_tpu_torch.cli import main as cli_main
from tomatis_tpu_torch.engine import streaming
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.models import standard
from tomatis_tpu_torch.models.standard import StandardParams, process
from tomatis_tpu_torch.ops import wire as wire_ops
from tomatis_tpu_torch.parallel import batch
from tomatis_tpu_torch.parallel.batch import process_batch

# two intra-op threads: the suite runs several workers side by side
torch.set_num_threads(2)
SR = 48000
FPC = 16
LSB = 4
LEVEL_ATOL = 1e-4
OUT_USED_RTOL = 0.01
SLOW_LINK_MBPS = 100.0      # under WIRE_BATCH_LINK_MBPS: the rule picks wire
P = StandardParams(require_48k_stereo=False)


@contextlib.contextmanager
def _link(mbps):
    """process_batch's view of the device's link rate held at mbps (a CPU
    device has none: infinite, so the rule keeps pcm24)."""
    keep = batch._link_mbps
    batch._link_mbps = lambda dev: mbps
    try:
        yield
    finally:
        batch._link_mbps = keep


@pytest.fixture(autouse=True)
def _rice_out_off(monkeypatch):
    """Both packages' wire output without rice (their CPU default), fixed
    so the output link bytes compare like for like."""
    monkeypatch.setenv("TOMATIS_WIRE_RICE_OUT", "0")


def _sig(seconds, seed, quiet=0.002, loud=0.06):
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    env = quiet + loud * (np.sin(2 * np.pi * (0.5 + 0.1 * seed) * t) > 0)
    x = env * (np.sin(2 * np.pi * (300 + 50 * seed) * t)
               + 0.05 * rng.standard_normal(n))
    return np.clip(np.stack([x, 0.9 * x], 1), -1, 1).astype(np.float32)


def _files(tmp_path, seconds, seed0=0, ext="flac"):
    ins = []
    for i, sec in enumerate(seconds):
        ip = tmp_path / f"in{i}.{ext}"
        audio.write(ip, _sig(sec, seed0 + i), SR, subtype="PCM_24")
        ins.append(ip)
    return ins


def _run(tmp_path, ins, tag, transport, fpc=FPC, csv_out=True, **kw):
    """process_batch on the CPU into tmp_path/tag, on a link slow enough
    for wire (transport "wire") or with the CPU's own (none: pcm24);
    returns (stats, outs, csvs)."""
    d = tmp_path / tag
    d.mkdir(exist_ok=True)
    outs = [d / f"out{i}{ip.suffix}" for i, ip in enumerate(ins)]
    csvs = [d / f"st{i}.csv" for i in range(len(ins))] if csv_out else None
    with _link(SLOW_LINK_MBPS if transport == "wire" else math.inf):
        stats = process_batch(list(zip(ins, outs)), P, frames_per_chunk=fpc,
                              state_csv_paths=csvs, device="cpu", **kw)
    assert batch.LAST_TIMINGS["transport"] == transport
    return stats, outs, csvs


def _same_bytes(a, b) -> bool:
    return open(a, "rb").read() == open(b, "rb").read()


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("fpc,seconds", [(16, [3.0, 2.2, 4.1]),
                                         (64, [6.0, 2.5])],
                         ids=["fpc16-3lanes", "fpc64-2lanes"])
def test_wire_batch_equals_pcm24_batch(tmp_path, fpc, seconds):
    """Uneven lanes: a lane past its end rides the zero stream while the
    others run; every file and state CSV equal the pcm24 batch's."""
    ins = _files(tmp_path, seconds)
    st_p, outs_p, csvs_p = _run(tmp_path, ins, "pcm24", "pcm24", fpc)
    chunks = batch.LAST_TIMINGS["chunks"]
    st_w, outs_w, csvs_w = _run(tmp_path, ins, "wire", "wire", fpc)
    lt, lw = batch.LAST_TIMINGS, batch.LAST_WIRE
    assert lt["transport"] == "wire" and lt["chunks"] == chunks
    assert lt["block_launches"] == [chunks]
    assert min(s["n_frames"] for s in st_w) < (chunks - 1) * fpc
    assert lw["in_raw_chunks"] == 0 and lw["in_used"] > 0
    assert lw["out_used"] > 0
    for i in range(len(ins)):
        assert st_w[i] == {**st_p[i], "out_path": str(outs_w[i])}
        assert _same_bytes(outs_w[i], outs_p[i])
        assert _same_bytes(csvs_w[i], csvs_p[i])


def test_wire_batch_matches_jax_process_batch(tmp_path):
    ins = _files(tmp_path, [2.5, 1.7, 3.3], seed0=4)
    stats, outs, csvs = _run(tmp_path, ins, "port", "wire")
    wire = dict(batch.LAST_WIRE)
    jouts = [tmp_path / f"j{i}.flac" for i in range(3)]
    jcsvs = [tmp_path / f"jst{i}.csv" for i in range(3)]
    jstats = jbatch.process_batch(list(zip(ins, jouts)),
                                  jstd.StandardParams(
                                      require_48k_stereo=False),
                                  frames_per_chunk=FPC,
                                  state_csv_paths=jcsvs)
    jwire = dict(jbatch.LAST_WIRE)
    for i in range(3):
        for k in ("failed", "n_frames", "sr", "c1_frames", "c2_frames"):
            assert stats[i][k] == jstats[i][k], k
        y, _ = audio.read(outs[i])
        jy, _ = audio.read(jouts[i])
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
    assert wire["in_used"] == jwire["in_used"]
    assert abs(wire["out_used"] - jwire["out_used"]) \
        <= OUT_USED_RTOL * jwire["out_used"]


def test_wire_float_fallback_matches_single(tmp_path):
    """The counterpart of tests/test_batch.py::
    test_batch_wire_float_fallback_matches_single: a FLOAT input that is
    not PCM_24-exact ships its chunks as raw floats (the whole batch
    chunk); once that lane has ended the chunks go back to the codec.
    Both lanes equal the pcm24 batch's bytes and the single-file run's
    samples."""
    x = _sig(1.0, 3) + np.float32(1e-9)     # not PCM_24-representable
    ip = tmp_path / "f.wav"
    audio.write(ip, x, SR, subtype="FLOAT")
    ip2 = tmp_path / "g.flac"               # PCM_24-exact second lane
    audio.write(ip2, _sig(2.5, 4), SR, subtype="PCM_24")
    ins = [ip, ip2]
    st_w, outs_w, _ = _run(tmp_path, ins, "wire", "wire", csv_out=False)
    lw = dict(batch.LAST_WIRE)
    assert all(s["failed"] is None for s in st_w)
    assert 0 < lw["in_raw_chunks"] < batch.LAST_TIMINGS["chunks"]
    assert lw["in_used"] > 0
    _, outs_p, _ = _run(tmp_path, ins, "pcm24", "pcm24", csv_out=False)
    for src, out, outp in zip(ins, outs_w, outs_p):
        assert _same_bytes(out, outp)
        ref = tmp_path / (src.stem + "_ref.flac")
        process(src, ref, P, frames_per_chunk=FPC, device="cpu")
        np.testing.assert_array_equal(audio.read(out)[0],
                                      audio.read(ref)[0])


def test_wire_link_bytes_accounting(tmp_path):
    """tests/test_batch.py::test_batch_link_bytes_accounting's bounds, and
    the port's exact overheads: the input ships the lanes' streams and the
    2-word-per-lane header (n_valid, active), the output exactly the
    active lanes' used words."""
    ins = _files(tmp_path, [12.0] * 4, ext="wav")
    stats, _, _ = _run(tmp_path, ins, "wire", "wire", fpc=64,
                       csv_out=False)
    assert all(s["failed"] is None for s in stats)
    w, chunks = batch.LAST_WIRE, batch.LAST_TIMINGS["chunks"]
    assert w["in_used"] > 0 and w["out_used"] > 0
    assert w["in_shipped"] < w["in_used"] * 1.06, w
    assert w["out_shipped"] < w["out_used"] * 1.03, w
    assert w["in_shipped"] - w["in_used"] == chunks * 4 * 2 * 4, w
    assert w["out_shipped"] == w["out_used"], w


def test_wire_long_batch_keeps_the_local_codec(tmp_path):
    """Lanes of more than 8 chunks (where the reference starts its RPC
    worker) encode and decode in this process, and every file and state
    CSV equal the pcm24 batch's."""
    ins = _files(tmp_path, [6.0, 3.5], ext="wav")     # 6 s: 143 frames
    _, outs_w, csvs_w = _run(tmp_path, ins, "wire", "wire")
    assert batch.LAST_TIMINGS["chunks"] > 8
    _, outs_p, csvs_p = _run(tmp_path, ins, "pcm24", "pcm24")
    for i in range(2):
        assert _same_bytes(outs_w[i], outs_p[i])
        assert _same_bytes(csvs_w[i], csvs_p[i])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lane_layout_matches_device_compaction(seed):
    """_lane_layout's slices of the flat stream hold each active lane's
    used words: random counts, inactive lanes and counts past the row
    capacity (clipped) among them."""
    rng = np.random.default_rng(seed)
    Bp, capW = 7, 50
    words = torch.from_numpy(
        rng.integers(-2**31, 2**31, (Bp, capW), dtype=np.int64)
        .astype(np.int32))
    used = rng.integers(0, capW + 20, Bp).astype(np.int32)
    used[seed % Bp] = capW + 7               # one past the capacity
    active = rng.random(Bp) < 0.7
    active[(seed + 3) % Bp] = False
    flat, total = batch._flatten_words(words, torch.from_numpy(used),
                                       torch.from_numpy(active))
    u, offs = batch._lane_layout(used, active, capW)
    assert int(total) == int(u.sum())
    assert list(u) == [min(int(n), capW) if a else 0
                       for n, a in zip(used, active)]
    for i in range(Bp):
        assert torch.equal(flat[offs[i]:offs[i] + u[i]], words[i, :u[i]])


def _sabotage(monkeypatch, target, what):
    """Make lane `target` fail mid-stream: its reader (read), its writer
    (write) or its device pack's used count (used: a 3-word stream, which
    no decoder takes) from its third chunk on."""
    if what == "used":
        pack, calls = batch._pack_pcm24, [0]

        def bad_pack(pcm, C, rice):
            words, used = pack(pcm, C, rice)
            calls[0] += 1
            if calls[0] > 2 * 2 and calls[0] % 2 == 1:    # lane 0 of 2
                used = torch.full_like(used, 3)
            return words, used
        monkeypatch.setattr(batch, "_pack_pcm24", bad_pack)
        return
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
                                      ("write", "sink full"),
                                      ("used", "")])
def test_wire_midstream_failure_isolated(tmp_path, monkeypatch, what, msg):
    """A lane whose reader, writer or output stream goes bad mid-stream
    fails alone on wire; the other lane equals its single-file run."""
    ins = _files(tmp_path, [2.0, 2.0], ext="wav", seed0=1)
    ref = tmp_path / "single.wav"
    process(ins[1], ref, P, frames_per_chunk=FPC, device="cpu")
    _sabotage(monkeypatch, "in0.wav", what)
    stats, outs, _ = _run(tmp_path, ins, "wire", "wire", csv_out=False)
    assert stats[0]["failed"] is not None and msg in stats[0]["failed"]
    assert stats[1]["failed"] is None
    assert _same_bytes(outs[1], ref)


def test_wire_refuses_devices_and_auto_is_pcm24(tmp_path):
    """Lane blocks (devices=) keep pcm24 on any link, as the reference's
    sharded lanes do; the CPU's own link (none) keeps pcm24 and leaves
    LAST_WIRE empty; both write the wire run's bytes."""
    ins = _files(tmp_path, [1.0, 0.7])
    _run(tmp_path, ins, "wire", "wire", csv_out=False)
    assert batch.LAST_WIRE
    d = tmp_path / "blocks"
    d.mkdir()
    outs = [d / f"out{i}.flac" for i in range(2)]
    with _link(SLOW_LINK_MBPS):
        stats = process_batch(list(zip(ins, outs)), P, frames_per_chunk=FPC,
                              devices=2, device="cpu")
    assert batch.LAST_TIMINGS["transport"] == "pcm24"
    assert batch.LAST_WIRE == {}
    assert all(s["failed"] is None for s in stats)
    _, outs_a, _ = _run(tmp_path, ins, "auto", "pcm24", csv_out=False)
    assert batch.LAST_WIRE == {}
    for out, out_a in zip(outs, outs_a):
        assert _same_bytes(out, tmp_path / "wire" / out.name)
        assert _same_bytes(out_a, tmp_path / "wire" / out.name)


@pytest.mark.parametrize("mbps,sharded,want", [
    (SLOW_LINK_MBPS, False, "wire"),
    (batch.WIRE_BATCH_LINK_MBPS, False, "pcm24"),
    (5.0e4, False, "pcm24"),
    (SLOW_LINK_MBPS, True, "pcm24"),
], ids=["slow", "at-threshold", "pcie", "lane-blocks"])
def test_batch_transport_rule(mbps, sharded, want):
    """batch_transport: wire only on one device whose link is slower than
    WIRE_BATCH_LINK_MBPS."""
    with _link(mbps):
        assert batch.batch_transport([torch.device("cpu")], sharded) == want


def test_batch_transport_cpu_has_no_link():
    assert batch._link_mbps(torch.device("cpu")) == math.inf
    assert batch.batch_transport([torch.device("cpu")], False) == "pcm24"


def test_wire_batch_needs_the_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour of a host without a card")
    ip = _files(tmp_path, [0.5])[0]
    with _link(SLOW_LINK_MBPS), pytest.raises(RuntimeError, match="CUDA"):
        process_batch([(ip, tmp_path / "o.flac")], P)


def test_batch_chunk_fn_wire_is_single_wire_step_per_lane():
    """The wire batch packs each lane of the batched pcm24 step as
    _pack_pcm24 packs the single-file pcm24 step's bytes: full, partial
    and empty lanes give the same words and used counts, rice off and
    on."""
    n_fft, hop, C, F = P.n_fft, P.hop, 2, 8
    ctl = standard.build_controller(P, SR, "cpu")
    eng = streaming.ChunkedStftEngine(n_fft, hop, C, F, device="cpu")
    fn = eng.make_chunk_fn(ctl, transport="pcm24")
    bfn = streaming.ChunkedStftEngine(
        n_fft, hop, C, F, device="cpu").make_batch_chunk_fn(ctl)
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
    nv = torch.tensor(n_valid, dtype=torch.int32)
    pcm = bfn(sig, nv, carries, ot, wt, ctl.params(), gain)[0]
    singles = [fn(sig[b], n, carries[b], ot[b], wt[b], ctl.params(),
                  gain)[0] for b, n in enumerate(n_valid)]
    for rice in (False, True):
        words, used = batch._pack_lanes(pcm, C, rice)
        assert words.shape == (B, wire_ops.max_words(eng.emit_full, C))
        for b, one in enumerate(singles):
            w1, u1 = batch._pack_pcm24(one, C, rice)
            assert int(used[b]) == int(u1) > 0
            assert torch.equal(words[b, :int(u1)], w1[:int(u1)])


def test_flat_staging_unpacks_every_lane_exactly():
    """_stage_flat + _unpack_lanes give back each lane's window bit for
    bit: packed streams, the raw escape (full-scale noise) and the zero
    stream, each at its offset behind the header, which holds the frame
    counts and the active flags (0 until the dispatch sets them)."""
    rng = np.random.default_rng(9)
    n, ch = 3000, 2
    wins = [np.rint(0.3 * rng.standard_normal((n, ch)) * 2**20) / 2**23,
            rng.integers(-2**23, 2**23, (n, ch)) / 2**23,
            np.zeros((n, ch)),
            np.rint(np.cumsum(rng.standard_normal((n, ch)), 0)) / 2**23]
    wins = [w.astype(np.float32) for w in wins]
    streams = [batch.host_encode(w)[1] for w in wins]
    nfs = np.array([7, 3, 0, 7], np.int32)
    flat, offs, words = batch._stage_flat(streams, nfs, torch.device("cpu"))
    f = flat.numpy()
    assert list(f[:4]) == list(nfs) and not f[4:8].any()
    assert offs[0] == 2 * 4
    assert len(f) == offs[-1] + words[-1]
    sig = batch._unpack_lanes(flat, offs, words, n, ch)
    for b, w in enumerate(wins):
        assert torch.equal(sig[b], torch.from_numpy(w))


def test_process_batch_cli_wire(tmp_path, capsys):
    """The CLI on a link slow enough for wire writes the bytes it writes
    on the CPU's own link (pcm24)."""
    ins = [str(ip) for ip in _files(tmp_path, [1.2, 0.8], seed0=6)]
    outs = {}
    for tr, mbps in (("pcm24", math.inf), ("wire", SLOW_LINK_MBPS)):
        outs[tr] = tmp_path / tr
        with _link(mbps):
            rc = cli_main.main(["process-batch", "-i", *ins, "-o",
                                str(outs[tr]), "--frames_per_chunk",
                                str(FPC), "--device", "cpu"])
        out = capsys.readouterr().out
        assert rc == 0 and "2/2 files" in out
        assert batch.LAST_TIMINGS["transport"] == tr
    for i in range(2):
        name = f"in{i}_tomatis.flac"
        assert _same_bytes(outs["wire"] / name, outs["pcm24"] / name)
