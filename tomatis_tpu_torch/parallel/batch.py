"""Batch processing: B files per chunk launch, PyTorch port of
tomatis_tpu/parallel/batch.py.

Each file is a lane. Every pcm24 batch chunk uploads the lanes' input
windows as one pinned [B, L, C] tensor and runs
ChunkedStftEngine.make_batch_chunk_fn: the lanes' levels, gates and rFFT
gain banks at the single-file shapes, then ONE launch of the batched
chunk-tail kernel for all lanes (the counterpart of the Pallas kernel
under jax.vmap). Lanes are independent:
per-file gate carries, OLA tails, flush plans and writers. A lane whose
stream is exhausted (or has failed) keeps riding the launch with zeros and
n_valid = 0, which freezes its carries. A file whose I/O fails is isolated:
its lane is failed and the rest continue (at open, read, route and write).

Threads: a producer stages every lane's window ahead of the device, the
lanes' reads (FLAC decodes) side by side on a pool of up to 8 threads; the
calling thread uploads, enqueues and moves chunks through the pipeline of
utils/pipeline.py (at depth 1); each lane has its own ordered writer
thread, so the lanes' FLAC encoders run side by side too (the reference
routes all lanes on one worker in a serial loop, and on a PCIe host the
encoder is a FLAC sink's wall). The native codecs release the interpreter
lock. Each file's bytes are the serial loop's bytes.

devices=N (or a device list) shards the lanes over devices, as the
reference's shard_map over a 1-D 'data' mesh: the lanes are padded to a
multiple of the device count with idle lanes, and lane block k runs its
own batched launch per chunk on devices[k], with no traffic between
devices (the reference's shard_map has none). A device may repeat: lane
blocks then take turns on it.

On one device the batch can compress the link both ways with the wire
codec, which the reference runs on every single-device batch (its
`wire = mesh_devs is None`). The port takes it where the reference's reason
holds, a link slow enough that the bytes the codec saves take longer to
ship than the codec takes to run: batch_transport() compares the card's
measured read-back rate with WIRE_BATCH_LINK_MBPS, and a PCIe host
stays on pcm24. Input: each active lane's window is C++-encoded on
the producer, idle lanes take one all-zeros stream, and the lanes'
streams (whole u32 words) go into ONE pinned int32 buffer behind a header
of 2*B words (n_valid, active): one upload per batch chunk. The device
unpacks each lane at its offset (the host knows it from staging). A chunk
in which some lane is not PCM_24-exact ships the lanes' raw floats
instead, as the pcm24 batch does. Output: each lane's PCM_24 bytes from
the batched pcm24 step are packed on the device, and the active lanes'
used words are compacted into one flat stream at exclusive-cumsum
offsets. S1 reads aux and used [B], S2 fetches flat[:total], and each
lane's writer thread decodes its slice with the native codec before
routing it. Every file's bytes are the pcm24 batch's. LAST_WIRE holds
the link bytes of the last wire call. The codec stays in this process on
long batches too: the reference's RPC worker past 8 chunks (its
engine/staging.py) made a 10-minute lane 2.2 s slower on an H100 host,
each call's window pickled through a pipe. This module is the port's only user of the wire codec
(ops/wire.py, io/wirecodec.py): the rice policy and the packing of the
chunk tail's bytes live here.

Not carried over: `_VCHUNK_CACHE`, `_VSTEP_CACHE`, `_FLAT_GRID` with
`_flat_canonical`'s padding to a canonical shape, and the 1 MB page rows
with `_PAGE_ROW` and `trim_tail_page` (they bounded XLA's executable
count; eager torch compiles nothing).
"""
from __future__ import annotations

import contextlib
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tomatis_tpu_torch.engine.streaming import (ChunkedStftEngine,
                                                ChunkReadback, SinkState,
                                                StreamRunner, timed_read,
                                                timed_sink)
from tomatis_tpu_torch.io import audio, wirecodec
from tomatis_tpu_torch.ops import wire as wire_ops
from tomatis_tpu_torch.utils import trace
from tomatis_tpu_torch.utils.device import resolve_device, resolve_devices
from tomatis_tpu_torch.utils.pipeline import (OrderedWorker, Prefetcher,
                                              StagedPipeline)
from tomatis_tpu_torch.utils.rolling import RollingReader
from tomatis_tpu_torch.utils.stateio import StateCsvWriter

# the most recent process_batch call: its batch chunks, the launches per
# lane block, the devices, the transport and the utils.trace job id; and
# span totals of utils/trace.py: the producer's wall time in the lanes'
# reads (read_s, batch.read) and, one entry per lane, its reads' decode
# time (lane_decode_s, producer.decode on the pool), its writer thread's
# busy time (lane_write_s, writer.job) and its sink writes and the
# encoder's close (lane_encode_s, writer.encode and writer.close)
LAST_TIMINGS: dict = {}

# link bytes of the most recent wire-transport process_batch call (empty
# after any other call): *_used the lanes' exact stream bytes, *_shipped
# what crossed the link (the input with its header; the output stream of
# every lane that was active at dispatch); in_raw_chunks the
# batch chunks that shipped raw floats (some lane not PCM_24-exact)
LAST_WIRE: dict = {}

# Link rate (MB/s) below which a one-device batch ships the wire codec's
# streams: the bytes it saves at B = 8 over the wall time it adds. On an
# H100 80GB HBM3 (700 W) chip_smoke.py's phase 28 reads 511 MB saved a
# run (429 MB on wire against 940 MB on pcm24) for 0.44-1.09 s more wall
# over three calls, crossovers of 469-1159 MB/s; the lowest, rounded
# down, is taken. That card's PCIe link read back 38 GB/s.
WIRE_BATCH_LINK_MBPS = 450.0

# Static rice switches of the wire codec, one per link DIRECTION (the
# per-block rice mode is a stream property; encoder and decoder of each
# direction pair by construction, and the host decoders accept either
# stream). Rice saves a few percent of link bytes on program material and
# costs device time on both halves:
# - input (host C++ encode -> device unpack): OFF, as in the reference.
# - output (device pack -> host C++ decode): by the measured link.
#   resolve_rice_out() probes the device->host rate once; the
#   TOMATIS_WIRE_RICE_OUT env var forces 0/1.
WIRE_RICE_IN = False
WIRE_RICE_OUT = False

# Device->host rate below which rice-out pays: the bytes rice saves per
# chunk over the extra device time of the rice pack. chip_smoke.py reads
# both at the production chunk on an H100 80GB HBM3 (700 W): 0.371 MB
# saved for 16.6 ms more pack time, so the break-even is about 22 MB/s
# (PERF.md). A PCIe link is three orders of magnitude above it.
RICE_OUT_BW_THRESHOLD_MBPS = 22.0

_RICE_OUT_MEMO: dict = {}


def probe_d2h_mbps(mb: float = 4.0, fresh: bool = False,
                   device="cuda") -> float:
    """One-shot device->host bandwidth estimate in MB/s (memoised per
    process): time the copy of a device tensor of `mb` MB into pinned
    memory. `fresh=True` bypasses and refreshes the memo. Raises without
    a CUDA device: there is no link to measure."""
    if not fresh and "bw" in _RICE_OUT_MEMO:
        return _RICE_OUT_MEMO["bw"]
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError("probe_d2h_mbps needs a CUDA device")
    n = int(mb * 1e6 / 4)
    a = torch.arange(n, dtype=torch.float32, device=dev) + 1.0
    host = torch.empty(n, dtype=torch.float32, pin_memory=True)
    host.copy_(a)                                # warm the path
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    host.copy_(a, non_blocking=True)
    torch.cuda.synchronize(dev)
    bw = host.numel() * 4 / 1e6 / max(time.perf_counter() - t0, 1e-9)
    _RICE_OUT_MEMO["bw"] = bw
    return bw


def resolve_rice_out(device="cuda") -> bool:
    """The wire output's rice policy: env force (TOMATIS_WIRE_RICE_OUT=0/1)
    or, by default, one memoised d2h bandwidth probe against
    RICE_OUT_BW_THRESHOLD_MBPS. A CPU device has no link: the module
    default."""
    env = os.environ.get("TOMATIS_WIRE_RICE_OUT", "auto")
    if env in ("0", "1"):
        return env == "1"
    if "choice" not in _RICE_OUT_MEMO:
        if torch.device(device).type != "cuda":
            return WIRE_RICE_OUT
        _RICE_OUT_MEMO["choice"] = (probe_d2h_mbps(device=device)
                                    < RICE_OUT_BW_THRESHOLD_MBPS)
    return _RICE_OUT_MEMO["choice"]


def host_encode(sig: np.ndarray):
    """Host half of a lane's input staging (no torch calls; the C++
    codec releases the interpreter lock): ("wire", stream) when the float
    window is PCM_24-exact, else ("raw_inexact", sig), which ships as
    floats."""
    packed = wirecodec.encode_f32(sig, rice=WIRE_RICE_IN)
    return ("raw_inexact", sig) if packed is None else ("wire", packed)


def _pack_pcm24(pcm, C: int, rice: bool):
    """The chunk tail's PCM_24 bytes [n*C*3] -> wire_ops.pack_device's
    (words, used). The bytes are sign-extended, so the pack sees exactly
    the ints the pcm24 transport ships."""
    b = pcm.view(-1, 3)
    v = (b[:, 0].to(torch.int32)
         | (b[:, 1].to(torch.int32) << 8)
         | (b[:, 2].view(torch.int8).to(torch.int32) << 16)).reshape(-1, C)
    return wire_ops.pack_device(v, v.shape[0], C, rice=rice)


def _pack_lanes(pcm, C: int, rice: bool):
    """The batched step's PCM_24 bytes [B, n*C*3], each lane packed by
    _pack_pcm24 (the counterpart of the reference's vmapped pack) ->
    (words int32 [B, max_words], used int32 [B])."""
    packed = [_pack_pcm24(row, C, rice) for row in pcm]
    return (torch.stack([w for w, _ in packed]),
            torch.stack([u for _, u in packed]))


class _Lane:
    """Host-side state of one file's stream. Its reader belongs to the
    producer thread, its writer and state CSV to the lane's own writer
    thread; each side closes its own handles."""

    def __init__(self, in_path, out_path, runner: StreamRunner,
                 state_csv_path=None, index: int = 0, job: int = 0):
        self.in_path = str(in_path)
        self.out_path = str(out_path)
        self.runner = runner
        self.eng = runner.engine
        self.plan = runner.plan
        self.reader = None
        self.rolling = None
        self.writer = None
        self.csvw = None
        self.state_csv_path = state_csv_path
        self.frame0 = 0
        self.sink = SinkState(self.plan.pad)
        self.failed = None
        self.done = False
        self.index, self.job = index, job
        # span totals: decode_s (its reads), write_s (its writer thread's
        # busy time), encode_s (its sink writes and the encoder's close)
        self.timings = {"decode_s": 0.0, "write_s": 0.0, "encode_s": 0.0}
        self.write = None

    @property
    def n_frames(self):
        return self.plan.n_frames

    def open(self, sr, ch):
        self.sr = sr
        self.reader = audio.AudioFile(self.in_path, "r")
        self.rolling = RollingReader(
            timed_read(self.reader.read, self.timings, self.job, self.index),
            ch, left_pad=self.plan.pad, base=-self.plan.pad,
            block=self.eng.emit_len)
        self.writer = audio.AudioFile(self.out_path, "w", samplerate=sr,
                                      channels=ch, subtype="PCM_24")
        self.write = timed_sink(lambda raw: self.writer.write_raw(raw),
                                self.timings, self.job, self.index)
        if self.state_csv_path:
            self.csvw = StateCsvWriter(self.state_csv_path, sr,
                                       self.runner.total)

    def fail(self, err):
        """Mark the lane failed (the first error is the one reported)."""
        if self.failed is None:
            self.failed = str(err)
        self.done = True

    def close_input(self):
        _close(self.reader)
        self.reader = None

    def close_output(self):
        if self.writer is not None:
            with trace.span("writer.close", self.timings, "encode_s",
                            job=self.job, at=self.index):
                _close(self.writer)
        _close(self.csvw)
        self.writer = self.csvw = None

    def consume(self, c_frame0, c_nf, payload, aux, out_dev):
        """Route one chunk's PCM_24 bytes and aux rows through the shared
        SinkState (one routing implementation with the single-file run)."""
        self.sink.route(self.runner, self.eng, c_frame0, c_nf, payload, aux,
                        out_dev, self.csvw.on_frames if self.csvw else None,
                        self.write)

    def finish(self, out_tail, w_tail):
        if self.n_frames % self.eng.frames_per_chunk == 0 \
                and self.n_frames > 0:
            self.sink.append_tail(self.runner, self.eng, self.n_frames,
                                  out_tail, w_tail)
        self.sink.final_drain(self.runner, self.write)
        self.close_output()
        self.done = True

    def stats(self):
        sc = self.sink.states_count
        tf = int(sc[1] + sc[2])
        return dict(in_path=self.in_path, out_path=self.out_path,
                    failed=self.failed, n_frames=self.n_frames,
                    sr=getattr(self, "sr", 0),
                    c1_frames=int(sc[1]), c2_frames=int(sc[2]),
                    c2_ratio=sc[2] / tf if tf else 0.0)


def _close(h) -> None:
    try:
        if h is not None:
            h.close()
    except Exception:
        pass


def _on(dev: torch.device):
    """The device context of a CUDA device (events and copies go on its
    current stream); nothing for the CPU."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


class _BlockReadback:
    """The readback of one batch chunk: a ChunkReadback per lane block,
    each made and driven on its block's device. parts: (device, fetch,
    stream) per block, stream None or (flat words, total) as ChunkReadback
    takes it. materialize() returns the host arrays of each block: [pcm,
    aux] (pcm24), [aux, used, flat[:total]] (wire)."""

    def __init__(self, parts: list):
        self._parts = []
        for dev, fetch, stream in parts:
            with _on(dev):
                self._parts.append((dev, ChunkReadback(fetch, stream)))

    def _each(self, name: str) -> list:
        out = []
        for dev, rb in self._parts:
            with _on(dev):
                out.append(getattr(rb, name)())
        return out

    def block_until_ready(self) -> None:
        self._each("block_until_ready")

    def copy_to_host_async(self) -> None:
        self._each("copy_to_host_async")

    def start_stream(self) -> None:
        self._each("start_stream")

    def materialize(self) -> list:
        return self._each("materialize")


def _lane_devices(devices, device) -> list:
    """The device of each lane block: `device` alone (one block) for
    devices None; for an int N the first N CUDA devices, or N blocks on
    `device` when it names one (cpu, cuda:N); a list as given."""
    if devices is None:
        return [resolve_device(device)]
    if isinstance(devices, int):
        devs = resolve_devices(devices, device)
    else:
        devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("empty device list")
    return devs


def _host_buffer(shape, dtype, dev: torch.device) -> torch.Tensor:
    """A host staging tensor: pinned when it goes to a card (the caching
    host allocator reuses the block once its copy has run)."""
    return torch.empty(shape, dtype=dtype, pin_memory=dev.type == "cuda")


def _stage_flat(streams: list, nfs: np.ndarray, pin: torch.device):
    """The lanes' wire streams (uint8 arrays of whole u32 words, one per
    lane) packed in lane order behind a header of 2*Bp words (the frame
    counts, then the active flags, left 0 for the dispatch to set), in one
    host int32 buffer (pinned for a card). Returns (buffer, offsets in
    words, lengths in words)."""
    Bp = len(streams)
    words = np.array([len(v) // 4 for v in streams], np.int64)
    offs = 2 * Bp + np.cumsum(words) - words
    flat = _host_buffer((2 * Bp + int(words.sum()),), torch.int32, pin)
    f = flat.numpy()
    f[:Bp] = nfs
    f[Bp:2 * Bp] = 0
    fb = f.view(np.uint8)
    for v, o in zip(streams, offs):
        fb[4 * o:4 * o + len(v)] = v
    return flat, offs, words


def _unpack_lanes(flat, offs_w, words_w, n: int, ch: int) -> torch.Tensor:
    """Device half of the flat input: each lane's stream, sliced at the
    offset the host staged it at, unpacked to float32 -> [Bp, n, ch]."""
    return torch.stack([
        wire_ops.unpack_device(flat[int(o):int(o) + int(w)], n, ch,
                               WIRE_RICE_IN)
        for o, w in zip(offs_w, words_w)])


def _flatten_words(words: torch.Tensor, used: torch.Tensor,
                   active: torch.Tensor):
    """Compact every active lane's used output words into ONE stream at
    exclusive-cumsum offsets of the used counts (inactive lanes 0, each
    clipped to the row capacity), with no host sync: lane i's whole row is
    written at its offset in increasing lane order, so the next lane's row
    overwrites its unused tail; what lies past the total is never fetched.
    words int32 [Bp, capW], used [Bp], active bool [Bp] -> (flat int32
    [Bp * capW], total words 0-d). _lane_layout is its host replica."""
    Bp, capW = words.shape
    u = torch.where(active, used.to(torch.int64), 0).clamp(0, capW)
    offs = torch.cumsum(u, 0) - u
    flat = torch.empty(Bp * capW, dtype=words.dtype, device=words.device)
    cols = torch.arange(capW, device=words.device)
    for i in range(Bp):
        flat.index_copy_(0, offs[i] + cols, words[i])
    return flat, u.sum()


def _lane_layout(used: np.ndarray, active: np.ndarray, capW: int):
    """Host replica of _flatten_words' offset arithmetic (the same masking
    and clipping, so the host's slices match the device layout word for
    word): per-lane used words and exclusive-cumsum offsets."""
    u = np.clip(np.where(active, used.astype(np.int64), 0), 0, capW)
    return u, np.cumsum(u) - u


def _link_mbps(dev: torch.device) -> float:
    """The device's link rate in MB/s: the memoised pinned read-back probe
    on a card; a CPU device has no link to spare (infinite)."""
    return probe_d2h_mbps(device=dev) if dev.type == "cuda" else math.inf


def batch_transport(blocks: list, sharded: bool) -> str:
    """The batch's transport, from what the run observes: lane blocks
    (devices=) take pcm24, as the reference's sharded lanes do; one device
    takes wire when its link is slower than WIRE_BATCH_LINK_MBPS."""
    if sharded or _link_mbps(blocks[0]) >= WIRE_BATCH_LINK_MBPS:
        return "pcm24"
    return "wire"


def process_batch(jobs, params=None, frames_per_chunk: int = 1024,
                  state_csv_paths=None, devices=None,
                  device="cuda") -> list:
    """Process a batch of files, one lane each, with one batched chunk
    step per chunk on `device`.

    jobs: list of (in_path, out_path). All inputs must share sr/channels
    (a mismatched file fails in isolation). Returns per-file stats dicts.
    Outputs are PCM_24 (FLAC or WAV by extension), each file's bytes and
    state CSV those of standard.process on the same file with the chunk
    ramp off (TOMATIS_NO_RAMP=1): the batch never ramps.

    devices: None = every lane on `device`. An int N takes the first N
    CUDA devices (N blocks on `device` when it names one device, e.g.
    cpu); a list is used as given, repeats allowed. The lanes are padded
    to a multiple of the device count with idle lanes and lane block k
    runs on devices[k]; each lane's bytes are those of the single-device
    run. The link transport is batch_transport()'s choice (the same bytes
    either way); LAST_TIMINGS["transport"] names it and
    LAST_TIMINGS["job_id"] holds the call's utils.trace job id."""
    from tomatis_tpu_torch.models.standard import (StandardParams,
                                                   build_controller)
    LAST_WIRE.clear()
    job = trace.new_job()
    p = params or StandardParams()
    jobs = list(jobs)
    B = len(jobs)
    csvs = state_csv_paths or [None] * B
    if len(csvs) != B:
        raise ValueError(f"state_csv_paths has {len(csvs)} entries for "
                         f"{B} jobs (zip would silently drop jobs)")
    blocks = _lane_devices(devices, device)
    transport = batch_transport(blocks, devices is not None)
    wire = transport == "wire"
    D = len(blocks)
    Bl = -(-B // D)      # lanes per block; Bl * D - B idle lanes pad
    Bp = Bl * D

    # probe the batch's sr/ch from the first openable file
    sr = ch = None
    metas = []
    for in_path, _ in jobs:
        try:
            m = audio.info(in_path)
            metas.append(m)
            if sr is None:
                sr, ch = m.samplerate, m.channels
        except Exception as e:
            metas.append(e)

    if sr is None:
        # every file failed to open: per-file failure isolation still
        # holds, so return per-file stats instead of failing the batch
        return [dict(in_path=str(in_path), out_path=str(out_path),
                     failed=str(m), n_frames=0, sr=0, c1_frames=0,
                     c2_frames=0, c2_ratio=0.0)
                for (in_path, out_path), m in zip(jobs, metas)]

    # one engine, controller and batched step per distinct device
    steps = {}
    for dv in blocks:
        if str(dv) not in steps:
            eng = ChunkedStftEngine(p.n_fft, p.hop, ch, frames_per_chunk,
                                    device=dv)
            ctl = build_controller(p, sr, dv)
            steps[str(dv)] = dict(engine=eng, ctl=ctl,
                                  fn=eng.make_batch_chunk_fn(ctl),
                                  rice=wire and resolve_rice_out(dv))
    engine, controller = (steps[str(blocks[0])][k] for k in ("engine",
                                                             "ctl"))

    lanes = []
    for i, ((in_path, out_path), m, csvp) in enumerate(zip(jobs, metas,
                                                             csvs)):
        runner = StreamRunner(engine, controller,
                              total=0 if isinstance(m, Exception)
                              else m.frames,
                              output_gain_db=p.output_gain_db,
                              transport="pcm24", build_chunk_fn=False)
        lane = _Lane(in_path, out_path, runner, csvp, index=i, job=job)
        if isinstance(m, Exception):
            lane.fail(m)
        elif p.require_48k_stereo and (m.samplerate != 48000
                                       or m.channels != 2):
            lane.fail(f"expected 48kHz stereo, got {m.samplerate}/"
                      f"{m.channels}")
        elif m.samplerate != sr or m.channels != ch:
            lane.fail(f"batch sr/ch mismatch: {m.samplerate}/{m.channels}")
        else:
            try:
                lane.open(sr, ch)
            except Exception as e:
                lane.fail(e)
                lane.close_input()
                lane.close_output()
        lanes.append(lane)

    hop, F, L = engine.hop, engine.frames_per_chunk, engine.chunk_input_len
    capW = wire_ops.max_words(engine.emit_full, ch)

    def read_window(lane, start, nf, sig_row):
        """One lane's window of the next chunk into its slot (a pool
        thread; one read of a lane at a time)."""
        sig_row[:] = lane.rolling.window(start, L)
        lane.rolling.advance(start + nf * hop)

    def read_encode(lane, start, nf):
        """wire: one lane's window of the next chunk and its C++ encode
        (a pool thread; the codec releases the interpreter lock) ->
        (window, tagged item)."""
        win = lane.rolling.window(start, L)
        lane.rolling.advance(start + nf * hop)
        return win, host_encode(win)

    # an idle lane's wire stream: all zeros, the same for every chunk
    zero_stream = (host_encode(np.zeros((L, ch), np.float32))[1]
                   if wire else None)

    def produce():
        """Producer thread: stage every lane's window of the next chunk,
        the lanes' reads (FLAC decodes, and on wire their encodes) side by
        side on the pool. pcm24, and wire when some lane's window is not
        PCM_24-exact: one host tensor [B, L, C] of the windows (pinned for
        a card) and an int32 [B] one of the frame counts. wire otherwise:
        the flat buffer of _stage_flat. An exhausted or failed lane rides
        with zeros (its wire stream the zero stream) and 0 frames. A read
        error rides the item and fails that lane on the calling thread;
        the producer closes the reader of a lane it has finished with. Its
        wall time in the lanes' reads is a batch.read span, summed in
        timings["read_s"]. Yields (item, frame counts, errors); item
        ("f32", sig, nv) or ("wire", flat, offsets, lengths)."""
        pf0 = [0] * B
        dead = [lane.failed is not None for lane in lanes]
        pin = blocks[0]
        while True:
            with trace.span("batch.read", timings, "read_s", job=job):
                nv = _host_buffer((Bp,), torch.int32, pin)
                nfs = nv.numpy()
                nfs[:] = 0
                sig = sig_np = None
                if not wire:
                    sig = _host_buffer((Bp, L, ch), torch.float32, pin)
                    sig_np = sig.numpy()
                    sig_np[B:] = 0.0   # the idle lanes that pad the blocks
                errs, reads, got = {}, {}, {}
                for i, lane in enumerate(lanes):
                    nf = min(F, lane.n_frames - pf0[i])
                    if dead[i] or lane.failed is not None or nf <= 0:
                        if not dead[i] and lane.failed is not None:
                            dead[i] = True
                            lane.close_input()
                        if sig_np is not None:
                            sig_np[i] = 0.0
                        continue
                    start = -lane.plan.pad + pf0[i] * hop
                    reads[i] = (nf, pool.submit(read_encode, lane, start, nf)
                                if wire else pool.submit(
                                    read_window, lane, start, nf,
                                    sig_np[i]))
                for i, (nf, fut) in reads.items():
                    try:
                        got[i] = fut.result()
                    except Exception as e:
                        errs[i] = e
                        dead[i] = True
                        lanes[i].close_input()
                        if sig_np is not None:
                            sig_np[i] = 0.0
                        continue
                    pf0[i] += nf
                    nfs[i] = nf
            if not nfs.any() and not errs:
                return
            if not wire:
                yield ("f32", sig, nv), nfs.copy(), errs
            elif all(enc[0] == "wire" for _, enc in got.values()):
                streams = [got[i][1][1] if i in got else zero_stream
                           for i in range(Bp)]
                yield (("wire",) + _stage_flat(streams, nfs, pin),
                       nfs.copy(), errs)
            else:
                sig = _host_buffer((Bp, L, ch), torch.float32, pin)
                sig_np = sig.numpy()
                sig_np[:] = 0.0
                for i, (win, _) in got.items():
                    sig_np[i] = win
                yield ("f32", sig, nv), nfs.copy(), errs

    # per lane block, on its device: the lanes' controller carries and
    # OLA tails, the controller's parameters and the output gain
    carries = [steps[str(dv)]["ctl"].init_carry() for dv in blocks
               for _ in range(Bl)]
    out_tail_b = [torch.zeros((Bl, engine.tail_len, ch),
                              dtype=torch.float32, device=dv)
                  for dv in blocks]
    w_tail_b = [torch.zeros((Bl, engine.tail_len), dtype=torch.float32,
                            device=dv) for dv in blocks]
    params = [steps[str(dv)]["ctl"].params() for dv in blocks]
    gains = [torch.tensor(lanes[0].runner.output_gain, dtype=torch.float32,
                          device=dv) for dv in blocks]
    timings = {"chunks": 0, "read_s": 0.0, "block_launches": [0] * D}
    wire_acct = {"in_used": 0, "in_shipped": 0, "out_used": 0,
                 "out_shipped": 0, "in_raw_chunks": 0}
    writers: dict = {}

    def route(i, c_frame0, c_nf, payload, aux, out_dev):
        """Lane i's writer thread: take one chunk's PCM_24 bytes from
        payload() (on wire the lane's decode) and route them; an error
        fails the lane alone and closes its output."""
        lane = lanes[i]
        if lane.failed is not None:
            return
        with trace.span("writer.job", lane.timings, "write_s", job=job,
                        at=i):
            try:
                lane.consume(c_frame0, c_nf, payload(), aux, out_dev)
            except Exception as e:
                lane.fail(e)
                lane.close_output()

    def finish(i, out_tail, w_tail):
        lane = lanes[i]
        if lane.failed is not None:
            return
        with trace.span("writer.job", lane.timings, "write_s", job=job,
                        at=i):
            try:
                lane.finish(out_tail, w_tail)
            except Exception as e:
                lane.fail(e)
                lane.close_output()

    def wire_payloads(host, act):
        """wire: lane i -> a callable decoding its slice of the fetched
        stream (the offsets replicate the device compaction)."""
        aux_np, used_np, flat_np = host
        used_w, offs_w = _lane_layout(used_np, act, capW)
        fb = flat_np.view(np.uint8)
        wire_acct["out_shipped"] += flat_np.nbytes
        out = {}
        for i, lane in enumerate(lanes):
            if lane.failed is None and act[i]:
                wire_acct["out_used"] += 4 * int(used_w[i])
                src = fb[4 * offs_w[i]:4 * (offs_w[i] + used_w[i])]
                out[i] = (lambda src=src: wirecodec.decode_pcm24(
                    src, engine.emit_full, ch),
                          aux_np[i])
        return out

    def pipe_finish(ck):
        """S3: wait the readback out and hand each active lane's rows to
        its writer thread."""
        frame0s, nfs_c, act_c, rb, out_devs = ck["ready"]
        with trace.span("batch.readback", job=job):
            parts = rb.materialize()
        if wire:
            rows = wire_payloads(parts[0], act_c)
        else:
            rows = {}
            for i, lane in enumerate(lanes):
                if lane.failed is None and nfs_c[i] > 0:
                    k, j = divmod(i, Bl)
                    pcm_np, aux_np = parts[k]
                    rows[i] = (lambda pcm=pcm_np[j]: pcm, aux_np[j])
        with trace.span("batch.backpressure", job=job):
            for i, (payload, aux) in rows.items():
                k, j = divmod(i, Bl)
                writers[i].submit(
                    lambda i=i, payload=payload, aux=aux, od=out_devs[k][j]:
                    route(i, frame0s[i], int(nfs_c[i]), payload, aux, od))

    def join_writers():
        with trace.span("batch.backpressure", job=job):
            for w in writers.values():
                w.check(join=True)

    def upload(item, act):
        """Calling thread: each lane block's (signal, n_valid, active) on
        its device; a wire item is unpacked there, its act words set
        first."""
        if item[0] == "wire":
            _, flat, offs, words = item
            flat.numpy()[Bp:2 * Bp] = act
            wire_acct["in_used"] += 4 * int(words.sum())
            wire_acct["in_shipped"] += 4 * flat.numel()
            dv = blocks[0]
            flat_d = flat.to(dv, non_blocking=True)
            return [(_unpack_lanes(flat_d, offs, words, L, ch),
                     flat_d[:Bp], flat_d[Bp:2 * Bp] != 0)]
        _, sig, nv = item
        if wire:
            wire_acct["in_raw_chunks"] += 1
            act_h = _host_buffer((Bp,), torch.bool, blocks[0])
            act_h.numpy()[:] = act
            act_d = act_h.to(blocks[0], non_blocking=True)
        return [(sig[k * Bl:(k + 1) * Bl].to(dv, non_blocking=True),
                 nv[k * Bl:(k + 1) * Bl].to(dv, non_blocking=True),
                 act_d if wire else None)
                for k, dv in enumerate(blocks)]

    prefetch = None
    pool = ThreadPoolExecutor(max_workers=min(8, max(1, B)),
                              thread_name_prefix="batch-read")
    try:
        for i, lane in enumerate(lanes):
            if lane.failed is None:
                writers[i] = OrderedWorker(name=f"writer-lane{i}")
        prefetch = Prefetcher(produce())
        # depth 1: a chunk is handed to the writers as soon as the next
        # one is enqueued (its compute and readback take milliseconds on a
        # card), so the lanes' encodes overlap the next chunks' decodes;
        # a batch of long lanes has few chunks (4 at 150 s), and the
        # single-file depth of 3 would hold the writers back until the
        # 4th chunk. S2 fetches the wire stream (a no-op on pcm24).
        pipe = StagedPipeline(lambda ck: ck["ready"][3].start_stream(),
                              pipe_finish, depth=1)
        # the calling thread's spans (batch.stage: the producer wait and
        # the upload; batch.dispatch, batch.promote, batch.consume,
        # batch.finish) are rows of the timeline alone
        while True:
            with trace.span("batch.stage", job=job):
                try:
                    item, nfs, errs = prefetch.get()
                except StopIteration:
                    break
                for i, e in errs.items():
                    lanes[i].fail(e)
                    writers[i].submit(lanes[i].close_output)
                if not nfs.any():
                    continue
                if all(lane.failed is not None for lane in lanes):
                    break   # nothing left to route; drop the staged chunk
                # dispatch-time active mask: it decides both the device's
                # compaction of the wire output and the host's slices of it
                # (a lane failing after this point ships its bytes once,
                # unrouted)
                act = np.array([i < B and nfs[i] > 0
                                and lanes[i].failed is None
                                for i in range(Bp)])
                staged = upload(item, act)
            with trace.span("batch.dispatch", job=job):
                fetch, out_devs = [], []
                for k, (dv, (sig_d, nv_d, act_d)) in enumerate(zip(blocks,
                                                                    staged)):
                    rows = slice(k * Bl, (k + 1) * Bl)
                    (payload, aux, out_dev, carries[rows], out_tail_b[k],
                     w_tail_b[k]) = steps[str(dv)]["fn"](
                        sig_d, nv_d, carries[rows], out_tail_b[k],
                        w_tail_b[k], params[k], gains[k])
                    timings["block_launches"][k] += 1
                    if wire:
                        words, used = _pack_lanes(payload, ch,
                                                  steps[str(dv)]["rice"])
                        fetch.append((dv, [aux, used],
                                      _flatten_words(words, used, act_d)))
                    else:
                        fetch.append((dv, [payload, aux], None))
                    out_devs.append(out_dev)
                rb = _BlockReadback(fetch)
            timings["chunks"] += 1
            frame0s = [lane.frame0 for lane in lanes]
            for i, lane in enumerate(lanes):
                lane.frame0 += int(nfs[i])
            pipe.push((frame0s, nfs, act, rb, out_devs), rb)

            with trace.span("batch.promote", job=job):
                pipe.promote()
            if pipe.due():
                with trace.span("batch.consume", job=job):
                    pipe.retire()
        with trace.span("batch.consume", job=job):
            pipe.drain()
            join_writers()

        # the stream tails of lanes whose last chunk was full, then every
        # lane's last flush cut, each on its own writer thread
        with trace.span("batch.finish", job=job):
            out_tail_np = torch.cat([t.cpu() for t in out_tail_b]).numpy()
            w_tail_np = torch.cat([t.cpu() for t in w_tail_b]).numpy()
            for i, w in writers.items():
                w.submit(lambda i=i: finish(i, out_tail_np[i],
                                            w_tail_np[i]))
            join_writers()
        LAST_TIMINGS.clear()
        LAST_TIMINGS.update(
            chunks=timings["chunks"],
            block_launches=timings["block_launches"],
            devices=[str(dv) for dv in blocks], transport=transport,
            job_id=job,
            read_s=round(timings["read_s"], 4),
            **{f"lane_{k}": [round(lane.timings[k], 4) for lane in lanes]
               for k in ("decode_s", "write_s", "encode_s")})
        if wire:
            LAST_WIRE.update(wire_acct)
    finally:
        # writers first (they may still hold an output), then the
        # producer (it may still hold a reader); an exception escaping the
        # loop must not leave a lane's file open (WAV headers are patched
        # and FLAC streams finalised on close)
        for w in writers.values():
            w.close()
        if prefetch is not None:
            prefetch.close()
        pool.shutdown(wait=True)
        for lane in lanes:
            if not lane.done:
                lane.fail("batch run aborted")
            lane.close_input()
            lane.close_output()
    return [lane.stats() for lane in lanes]
