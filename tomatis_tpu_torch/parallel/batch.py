"""Batch processing: B files per chunk launch, PyTorch port of
tomatis_tpu/parallel/batch.py (its pcm24 path).

Each file is a lane. Every batch chunk uploads the lanes' input windows as
one pinned [B, L, C] tensor and runs ChunkedStftEngine.make_batch_chunk_fn:
the lanes' levels, gates and rFFT gain banks at the single-file shapes,
then ONE launch of the batched chunk-tail kernel for all lanes (the
counterpart of the Pallas kernel under jax.vmap). Lanes are independent:
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

Not carried over, each listed as open in ROADMAP.md: the single-device
`wire` batch (flat h2d header, page rows, `LAST_WIRE`), `devices=N` lane
sharding (raises NotImplementedError), and `_VCHUNK_CACHE` (eager torch
compiles nothing).
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import torch

from tomatis_tpu_torch.engine.streaming import (ChunkedStftEngine,
                                                ChunkReadback, SinkState,
                                                StreamRunner)
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.utils.device import resolve_device
from tomatis_tpu_torch.utils.pipeline import (OrderedWorker, Prefetcher,
                                              StagedPipeline)
from tomatis_tpu_torch.utils.rolling import RollingReader
from tomatis_tpu_torch.utils.stateio import StateCsvWriter

# wall time per stage of the most recent process_batch call: the calling
# thread's stages, the producer's reads (read_s) and each lane's writer
# thread's busy time (lane_write_s)
LAST_TIMINGS: dict = {}


class _Lane:
    """Host-side state of one file's stream. Its reader belongs to the
    producer thread, its writer and state CSV to the lane's own writer
    thread; each side closes its own handles."""

    def __init__(self, in_path, out_path, runner: StreamRunner,
                 state_csv_path=None):
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
        self.write_s = 0.0      # its writer thread's busy time

    @property
    def n_frames(self):
        return self.plan.n_frames

    def open(self, sr, ch):
        self.sr = sr
        self.reader = audio.AudioFile(self.in_path, "r")
        self.rolling = RollingReader(self.reader.read, ch,
                                     left_pad=self.plan.pad,
                                     base=-self.plan.pad,
                                     block=self.eng.emit_len)
        self.writer = audio.AudioFile(self.out_path, "w", samplerate=sr,
                                      channels=ch, subtype="PCM_24")
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
        for h in (self.writer, self.csvw):
            _close(h)
        self.writer = self.csvw = None

    def consume(self, c_frame0, c_nf, payload, aux, out_dev):
        """Route one chunk's PCM_24 bytes and aux rows through the shared
        SinkState (one routing implementation with the single-file run)."""
        self.sink.route(self.runner, self.eng, c_frame0, c_nf, payload, aux,
                        out_dev, self.csvw.on_frames if self.csvw else None,
                        self.writer.write_raw)

    def finish(self, out_tail, w_tail):
        if self.n_frames % self.eng.frames_per_chunk == 0 \
                and self.n_frames > 0:
            self.sink.append_tail(self.runner, self.eng, self.n_frames,
                                  out_tail, w_tail)
        self.sink.final_drain(self.runner, self.writer.write_raw)
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


def _host_buffer(shape, dtype, dev: torch.device) -> torch.Tensor:
    """A host staging tensor: pinned when it goes to a card (the caching
    host allocator reuses the block once its copy has run)."""
    return torch.empty(shape, dtype=dtype, pin_memory=dev.type == "cuda")


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

    devices: None or 1. Sharding the lanes over several cards is not
    ported yet (it waits for torch.distributed, ROADMAP.md)."""
    from tomatis_tpu_torch.models.standard import (StandardParams,
                                                   build_controller)
    p = params or StandardParams()
    jobs = list(jobs)
    B = len(jobs)
    csvs = state_csv_paths or [None] * B
    if len(csvs) != B:
        raise ValueError(f"state_csv_paths has {len(csvs)} entries for "
                         f"{B} jobs (zip would silently drop jobs)")
    if devices is not None and devices != 1:
        raise NotImplementedError(
            f"devices={devices!r}: sharding the lanes over several cards is "
            "not ported yet (it waits for the torch.distributed port, "
            "ROADMAP.md queue item 7)")
    dev = resolve_device(device)

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

    engine = ChunkedStftEngine(p.n_fft, p.hop, ch, frames_per_chunk,
                               device=dev)
    controller = build_controller(p, sr, dev)
    chunk_fn = engine.make_batch_chunk_fn(controller)
    ctl_params = controller.params()

    lanes = []
    for (in_path, out_path), m, csvp in zip(jobs, metas, csvs):
        runner = StreamRunner(engine, controller,
                              total=0 if isinstance(m, Exception)
                              else m.frames,
                              output_gain_db=p.output_gain_db,
                              transport="pcm24", build_chunk_fn=False)
        lane = _Lane(in_path, out_path, runner, csvp)
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

    def read_window(lane, start, nf, sig_row):
        """One lane's window of the next chunk into its slot (a pool
        thread; one read of a lane at a time)."""
        sig_row[:] = lane.rolling.window(start, L)
        lane.rolling.advance(start + nf * hop)

    def produce():
        """Producer thread: stage every lane's window of the next chunk
        into one host tensor [B, L, C] (pinned for a card) and the lanes'
        frame counts into an int32 [B] one. An exhausted or failed lane's
        slot is zeros with 0 frames. A read error rides the item and fails
        that lane on the calling thread; the producer closes the reader
        of a lane it has finished with. Its wall time in the lanes' reads
        goes to timings["read_s"]."""
        pf0 = [0] * B
        dead = [lane.failed is not None for lane in lanes]
        while True:
            _t = time.perf_counter()
            sig = _host_buffer((B, L, ch), torch.float32, dev)
            nv = _host_buffer((B,), torch.int32, dev)
            sig_np, nfs = sig.numpy(), nv.numpy()
            nfs[:] = 0
            errs, reads = {}, {}
            for i, lane in enumerate(lanes):
                nf = min(F, lane.n_frames - pf0[i])
                if dead[i] or lane.failed is not None or nf <= 0:
                    if not dead[i] and lane.failed is not None:
                        dead[i] = True
                        lane.close_input()
                    sig_np[i] = 0.0
                    continue
                reads[i] = (nf, pool.submit(read_window, lane,
                                            -lane.plan.pad + pf0[i] * hop,
                                            nf, sig_np[i]))
            for i, (nf, fut) in reads.items():
                try:
                    fut.result()
                except Exception as e:
                    errs[i] = e
                    dead[i] = True
                    lanes[i].close_input()
                    sig_np[i] = 0.0
                    continue
                pf0[i] += nf
                nfs[i] = nf
            timings["read_s"] += time.perf_counter() - _t
            if not nfs.any() and not errs:
                return
            yield sig, nv, errs

    carries = [controller.init_carry() for _ in range(B)]
    out_tail_b = torch.zeros((B, engine.tail_len, ch), dtype=torch.float32,
                             device=dev)
    w_tail_b = torch.zeros((B, engine.tail_len), dtype=torch.float32,
                           device=dev)
    gain = torch.tensor(lanes[0].runner.output_gain, dtype=torch.float32,
                        device=dev)
    timings = {"stage_s": 0.0, "dispatch_s": 0.0, "block_s": 0.0,
               "consume_s": 0.0, "finish_s": 0.0, "chunks": 0,
               "read_s": 0.0}
    writers: dict = {}

    def route(i, c_frame0, c_nf, payload, aux, out_dev):
        """Lane i's writer thread: route one chunk; an error fails the
        lane alone and closes its output."""
        lane = lanes[i]
        if lane.failed is not None:
            return
        t0 = time.perf_counter()
        try:
            lane.consume(c_frame0, c_nf, payload, aux, out_dev)
        except Exception as e:
            lane.fail(e)
            lane.close_output()
        lane.write_s += time.perf_counter() - t0

    def finish(i, out_tail, w_tail):
        lane = lanes[i]
        if lane.failed is not None:
            return
        t0 = time.perf_counter()
        try:
            lane.finish(out_tail, w_tail)
        except Exception as e:
            lane.fail(e)
            lane.close_output()
        lane.write_s += time.perf_counter() - t0

    def pipe_finish(ck):
        """S3: wait the readback out and hand each active lane's rows to
        its writer thread."""
        frame0s, nfs_c, rb, out_dev = ck["ready"]
        pcm_np, aux_np = rb.materialize()
        for i, lane in enumerate(lanes):
            if lane.failed is None and nfs_c[i] > 0:
                writers[i].submit(
                    lambda i=i: route(i, frame0s[i], int(nfs_c[i]),
                                      pcm_np[i], aux_np[i], out_dev[i]))

    def join_writers():
        for w in writers.values():
            w.check(join=True)

    prefetch = None
    pool = ThreadPoolExecutor(max_workers=min(8, max(1, B)))
    try:
        for i, lane in enumerate(lanes):
            if lane.failed is None:
                writers[i] = OrderedWorker()
        prefetch = Prefetcher(produce())
        # depth 1: a chunk is handed to the writers as soon as the next
        # one is enqueued (its compute and readback take milliseconds on a
        # card), so the lanes' encodes overlap the next chunks' decodes;
        # a batch of long lanes has few chunks (4 at 150 s), and the
        # single-file depth of 3 would hold the writers back until the
        # 4th chunk
        pipe = StagedPipeline(lambda ck: None, pipe_finish, depth=1)
        while True:
            _t = time.perf_counter()
            try:
                sig, nv, errs = prefetch.get()
            except StopIteration:
                break
            for i, e in errs.items():
                lanes[i].fail(e)
                writers[i].submit(lanes[i].close_output)
            nfs = nv.numpy().copy()
            if not nfs.any():
                continue
            if all(lane.failed is not None for lane in lanes):
                break   # nothing left to route; drop the staged chunk
            sig_d = sig.to(dev, non_blocking=True)
            nv_d = nv.to(dev, non_blocking=True)
            timings["stage_s"] += time.perf_counter() - _t
            _t = time.perf_counter()
            pcm, aux, out_dev, carries, out_tail_b, w_tail_b = chunk_fn(
                sig_d, nv_d, carries, out_tail_b, w_tail_b, ctl_params,
                gain)
            rb = ChunkReadback([pcm, aux])
            timings["dispatch_s"] += time.perf_counter() - _t
            timings["chunks"] += 1
            frame0s = [lane.frame0 for lane in lanes]
            for i, lane in enumerate(lanes):
                lane.frame0 += int(nfs[i])
            pipe.push((frame0s, nfs, rb, out_dev), rb)

            _t = time.perf_counter()
            pipe.promote()
            timings["block_s"] += time.perf_counter() - _t
            _t = time.perf_counter()
            if pipe.retire():
                timings["consume_s"] += time.perf_counter() - _t
        _t = time.perf_counter()
        pipe.drain()
        join_writers()
        drain_s = time.perf_counter() - _t
        timings["consume_s"] += drain_s

        # the stream tails of lanes whose last chunk was full, then every
        # lane's last flush cut, each on its own writer thread
        _t = time.perf_counter()
        out_tail_np = out_tail_b.cpu().numpy()
        w_tail_np = w_tail_b.cpu().numpy()
        for i, w in writers.items():
            w.submit(lambda i=i: finish(i, out_tail_np[i], w_tail_np[i]))
        join_writers()
        timings["finish_s"] += time.perf_counter() - _t
        LAST_TIMINGS.clear()
        LAST_TIMINGS.update({k: round(v, 4) if isinstance(v, float) else v
                             for k, v in timings.items()})
        LAST_TIMINGS["drain_s"] = round(drain_s, 4)
        LAST_TIMINGS["lane_write_s"] = [round(lane.write_s, 4)
                                        for lane in lanes]
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
