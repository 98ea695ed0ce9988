"""Processing over a ('data', 'seq') mesh of devices: data-parallel over
files x sequence-parallel over frames, PyTorch port of
tomatis_tpu/parallel/sharded.py.

The reference is one process over one host's devices: a 2-D
`jax.sharding.Mesh`, `shard_map` and ICI collectives. Its counterpart here
is one process driving a list of torch devices, with no process group:

- a Mesh holds the devices reshaped (data, seq). A device may repeat:
  [cuda:0]*4 is a 4-shard mesh on one card, [cpu]*8 the tests' mesh (the
  counterpart of XLA's --xla_force_host_platform_device_count=8);
- every step runs its per-file work once per shard in a Python loop over
  the mesh (the loop over 'data' replaces jax.vmap). Launches are
  asynchronous per device, so on several cards the shards overlap;
- the two collectives are explicit copies. The all_gather of the tiny
  shard totals of a block-composed scan is a torch.stack of every shard's
  total, copied to each shard's device. The OLA halo ppermute (i -> i+1)
  is a copy of shard i's trailing n_fft - hop samples and weights to shard
  i+1's device; shard 0 receives zeros, plus the carried tails on the
  streaming steps. A copy is always a new tensor, also on a repeated
  device, so an in-place add never writes through a view of another
  shard's sums.

Two things cross the split, as in the reference: the gate automaton (and
the crossfade ramp), solved as a block-composed scan (each shard composes
its local tables, the totals are gathered, every shard composes its
exclusive prefix and applies it to its local prefix), and the OLA halo.
Levels, the rFFT gain bank and the overlap-add (overlap_add_cuda on a CUDA
shard, twice per shard and file) are frame-parallel and run per shard.
"""
from __future__ import annotations

import numpy as np
import torch

from tomatis_tpu_torch.models.controllers import _blend_db
from tomatis_tpu_torch.ops import gate as gate_ops, stft
from tomatis_tpu_torch.ops.cuda_ola import FLOOR8
from tomatis_tpu_torch.ops.dsp import EPS, frame_levels_dbfs
from tomatis_tpu_torch.utils.device import resolve_device, resolve_devices


class Mesh:
    """Devices reshaped (data, seq): ``devices[d][s]`` runs shard s of the
    files of data row d. ``shape`` is {"data": ..., "seq": ...}, as the
    reference Mesh's."""

    def __init__(self, devices: list, data: int):
        n = len(devices)
        seq = n // data
        self.devices = [devices[d * seq:(d + 1) * seq] for d in range(data)]
        self.shape = {"data": data, "seq": seq}

    @property
    def first(self) -> torch.device:
        return self.devices[0][0]


def make_mesh(n_devices: int | None = None, data: int | None = None,
              devices=None) -> Mesh:
    """Build a ('data', 'seq') mesh over the first n_devices CUDA devices
    (all of them by default), or over an explicit device list (repeats
    allowed). Without a card and without a device list it raises."""
    if devices is None:
        devices = resolve_devices(n_devices)
    else:
        devices = [resolve_device(d) for d in devices]
    n = len(devices)
    if n < 1:
        raise ValueError("empty device list")
    if data is None:
        data = 2 if n % 2 == 0 and n > 1 else 1
    if data < 1 or n % data:
        raise ValueError(f"cannot factor {n} devices into data={data}")
    return Mesh(devices, data)


def _all_gather(parts: list, dev: torch.device) -> torch.Tensor:
    """The shards' totals, stacked on `dev` (a fresh tensor)."""
    return torch.stack([t.to(dev) for t in parts])


def _block_compose(prefixes: list, s0: list, S: int):
    """The block-composed table scan over the 'seq' shards: prefixes[s] is
    shard s's local prefix [F_loc, S] on its device, s0[s] the global
    initial carry index (int64 [1]) there. Returns per shard the global
    carry index after each local frame, and the global final carry (the
    same on every shard; shard 0's is returned)."""
    totals = [p[-1] for p in prefixes]
    finals, carry_out = [], None
    for idx, prefix in enumerate(prefixes):
        dev = prefix.device
        tot = _all_gather(totals, dev)                       # [n_seq, S]
        ident = torch.arange(S, dtype=torch.int64, device=dev)
        excl = full = ident
        for i in range(tot.shape[0]):
            if i < idx:
                excl = gate_ops.compose_tables(excl, tot[i])
            full = gate_ops.compose_tables(full, tot[i])
        s0_loc = excl.gather(0, s0[idx])                      # entering idx
        finals.append(prefix.gather(1, s0_loc.expand(prefix.shape[0], 1))
                      [:, 0])
        if carry_out is None:
            carry_out = full.gather(0, s0[idx])[0]
    return finals, carry_out


def _sharded_gate_updelay(levels: list, ton, toff, delay_frames: int, s0,
                          valid: list):
    """Block-composed variant-A gate over the shards of one file.

    levels/valid: one [F_loc] tensor per shard, on its device; s0: the
    global initial carry index (a 0-d or [1] integer tensor). Returns the
    local states per shard and the global final carry index (int32)."""
    D = int(delay_frames)
    prefixes = [gate_ops.prefix_compose(gate_ops.updelay_tables(
        lv, ton, toff, D, valid=v)) for lv, v in zip(levels, valid)]
    s0s = [s0.to(p.device).long().reshape(1) for p in prefixes]
    finals, carry = _block_compose(prefixes, s0s, D + 2)
    return ([gate_ops.updelay_states_from_index(f, D) for f in finals],
            carry.to(torch.int32))


def _sharded_gate_minhold(levels: list, ton, toff, min_hold_frames: int,
                          s0, valid: list):
    """Block-composed variant-B (min-hold) gate over the shards of one
    file: the scheme of _sharded_gate_updelay over the 2*(H+1)-state carry
    space of ops/gate.py::minhold_tables."""
    H = int(min_hold_frames)
    prefixes = [gate_ops.prefix_compose(gate_ops.minhold_tables(
        lv, ton, toff, H, valid=v)) for lv, v in zip(levels, valid)]
    s0s = [s0.to(p.device).long().reshape(1) for p in prefixes]
    finals, carry = _block_compose(prefixes, s0s, 2 * (H + 1))
    return ([gate_ops.minhold_states_from_index(f, H) for f in finals],
            carry.to(torch.int32))


def _sharded_alpha_ramp(targets: list, step: float, alpha0, valid: list):
    """Block-composed crossfade ramp over the shards of one file.

    The per-frame update x -> min(hi, max(lo, x + a)) is a clip-affine map
    (ops/gate.py); each shard composes its local maps, the shard totals
    (a, lo, hi) are gathered, and every shard applies its exclusive prefix:
    the gate's scheme in the clip-affine algebra, with the +-1e9 sentinels
    and invalid frames as the identity. alpha0: the alpha before the
    file's first frame (0-d float tensor). Returns (alpha per shard
    [F_loc], the global final alpha)."""
    prefixes = [gate_ops.prefix_clip(gate_ops.clip_maps(t, step, valid=v))
                for t, v in zip(targets, valid)]
    totals = [tuple(q[-1] for q in p) for p in prefixes]
    alphas, final = [], None
    for idx, prefix in enumerate(prefixes):
        dev = prefix[0].device
        tot = [_all_gather([t[k] for t in totals], dev) for k in range(3)]
        big = torch.full((), gate_ops._BIG, dtype=torch.float32, device=dev)
        ident = (torch.zeros_like(big), -big, big)
        excl = full = ident
        for i in range(tot[0].shape[0]):
            t_i = (tot[0][i], tot[1][i], tot[2][i])
            if i < idx:
                excl = gate_ops.compose_clip(excl, t_i)
            full = gate_ops.compose_clip(full, t_i)
        a0 = alpha0.to(dev, torch.float32).reshape(())
        alphas.append(gate_ops.apply_clip(prefix,
                                          gate_ops.apply_clip(excl, a0)))
        if final is None:
            final = gate_ops.apply_clip(full, a0)
    return alphas, final


def check_halo_span(n_fft: int, hop: int, frames_per_shard: int) -> None:
    """The OLA halo copy moves ONE shard hop, so a frame's overlap span
    (n_fft - hop samples) must fit inside a single shard's emit region
    (frames_per_shard * hop samples). Beyond that, shard i's tail would
    also overlap shard i+2's head and the output would silently diverge
    from the single-device engine. Every sharded step factory calls this;
    raise instead of producing wrong audio."""
    if frames_per_shard * hop < n_fft - hop:
        raise ValueError(
            f"frames_per_shard={frames_per_shard} too small: the OLA "
            f"overlap span is {n_fft - hop} samples but a shard emits "
            f"only {frames_per_shard * hop}; need frames_per_shard >= "
            f"{-(-(n_fft - hop) // hop)} at n_fft={n_fft}, hop={hop}")


def _ola_halo_emit(ys: list, win2, masks: list, hop: int, F_loc: int,
                   in_ty=None, in_tw=None, norm: str = "eps"):
    """Shared tail of every sharded per-file step: overlap-add per shard
    (overlap_add_cuda on a CUDA shard: y at [F_loc, C, n_fft], the weights
    at [F_loc, 1, n_fft]), the forward halo copy (shard i's trailing
    n_fft - hop samples overlap shard i+1's head), the carried head tails
    on shard 0 (super-chunk streaming) and the normalisation.

    ys/masks: one per shard, on its device; win2 on the first shard's
    device is copied to the others. Returns per shard (emit [F_loc*hop,
    C], tail_y [tail, C], tail_w [tail]): the tails are the shard's raw
    trailing accumulations (only the LAST shard's are meaningful to a
    streaming caller)."""
    olas, ws = [], []
    for y, mask in zip(ys, masks):
        w2 = win2.to(y.device)
        olas.append(stft.overlap_add(y, hop))
        ws.append(stft.overlap_add(w2[None, None, :] * mask[:, None, None],
                                   hop)[:, 0])
    n_emit = F_loc * hop
    out = []
    for i, (ola, w) in enumerate(zip(olas, ws)):
        dev = ola.device
        if i > 0:    # the ppermute i-1 -> i: a copy, never a view
            recv_y = olas[i - 1][n_emit:].to(dev, copy=True)
            recv_w = ws[i - 1][n_emit:].to(dev, copy=True)
        elif in_ty is not None:
            recv_y = in_ty.to(dev, copy=True)
            recv_w = in_tw.to(dev, copy=True)
        else:
            recv_y = recv_w = None
        if recv_y is not None:
            tail = recv_y.shape[0]
            ola[:tail] += recv_y
            w[:tail] += recv_w
        if norm == "floor8":   # the adaptive processor's normaliser floor
            emit = ola[:n_emit] / torch.clamp(w[:n_emit, None], min=FLOOR8)
        else:
            emit = ola[:n_emit] / (w[:n_emit, None] + EPS)
        out.append((emit, ola[n_emit:], w[n_emit:]))
    return out


class _Step:
    """A sharded step over `mesh`: fn(frames [B, F, C, n_fft], per-file
    [B] tensors ...) with B split over 'data' rows and F over 'seq'
    shards. Each row's files run per_file(b, frames, *args) in turn; the
    per-file outputs are gathered onto the mesh's first device and stacked
    over B."""

    def __init__(self, mesh: Mesh, n_fft: int, hop: int,
                 frames_per_shard: int, window=None):
        check_halo_span(n_fft, hop, frames_per_shard)
        self.mesh = mesh
        self.hop, self.F_loc = hop, frames_per_shard
        win = (stft.hann_symmetric(n_fft) if window is None
               else np.asarray(window, np.float32))
        self.consts = {"win": win, "win2": win * win}
        self._on = {}

    def const(self, name: str, dev) -> torch.Tensor:
        """The host constant `name` on dev, uploaded once per device."""
        key = (name, str(dev))
        if key not in self._on:
            self._on[key] = torch.from_numpy(self.consts[name]).to(dev)
        return self._on[key]

    def shards(self, frames, b: int, row: int, n_valid_b):
        """Shard s of file b on its device: (dev, frames, valid, levels)."""
        out, F_loc = [], self.F_loc
        for s, dev in enumerate(self.mesh.devices[row]):
            fr = frames[b, s * F_loc:(s + 1) * F_loc].to(dev)
            valid = (s * F_loc + torch.arange(F_loc, device=dev)
                     < n_valid_b.to(dev))
            out.append((dev, fr, valid,
                        frame_levels_dbfs(fr.permute(0, 2, 1))))
        return out

    def __call__(self, frames, *per_file_args):
        B = frames.shape[0]
        n_data, n_seq = self.mesh.shape["data"], self.mesh.shape["seq"]
        if B % n_data:
            raise ValueError(f"{B} files do not split over data={n_data}")
        if frames.shape[1] != n_seq * self.F_loc:
            raise ValueError(f"{frames.shape[1]} frames, expected "
                             f"{n_seq} shards x {self.F_loc}")
        B_loc = B // n_data
        first = self.mesh.first
        results = []
        for b in range(B):
            r = self.per_file(b, b // B_loc, frames,
                              *[a[b] for a in per_file_args])
            results.append([torch.cat([t.to(first) for t in x])
                            if isinstance(x, list) else x.to(first)
                            for x in r])
        return tuple(torch.stack(list(parts)) for parts in zip(*results))


class _GateStep(_Step):
    """Standard processor: up-delay gate block scan, C1/C2 gain rows."""

    def __init__(self, mesh, n_fft, hop, frames_per_shard, ton, toff,
                 delay_frames, g1_lin, g2_lin, window=None, streaming=False):
        super().__init__(mesh, n_fft, hop, frames_per_shard, window)
        self.ton, self.toff, self.D = ton, toff, int(delay_frames)
        self.consts["table"] = np.stack([np.asarray(g1_lin, np.float32),
                                         np.asarray(g2_lin, np.float32)])
        self.streaming = streaming

    def per_file(self, b, row, frames, s0, n_valid, in_ty=None, in_tw=None):
        sh = self.shards(frames, b, row, n_valid)
        states, carry = _sharded_gate_updelay(
            [x[3] for x in sh], self.ton, self.toff, self.D, s0,
            [x[2] for x in sh])
        ys, masks = [], []
        for (dev, fr, valid, _), st in zip(sh, states):
            table = self.const("table", dev)
            mask = valid.to(torch.float32)
            y = stft.apply_gain_bank(fr, self.const("win", dev),
                                     table.index_select(0, (st - 1).long()))
            ys.append(y * mask[:, None, None])
            masks.append(mask)
        out = _ola_halo_emit(ys, self.const("win2", sh[0][0]), masks, self.hop,
                             self.F_loc, in_ty, in_tw)
        emit = [o[0] for o in out]
        if not self.streaming:
            return emit, states, carry
        return (emit, [x[3] for x in sh], states, carry,
                [o[1] for o in out], [o[2] for o in out])


class _RampStep(_Step):
    """Crossfade and adaptive processors: a gate block scan (up-delay, or
    min-hold for the adaptive one), the alpha ramp block scan and the
    dB-domain gain blend."""

    def __init__(self, mesh, n_fft, hop, frames_per_shard, ton, toff,
                 hold_frames, alpha_step, g1_db, g2_db, window=None,
                 streaming=False, adaptive=False):
        super().__init__(mesh, n_fft, hop, frames_per_shard, window)
        self.ton, self.toff, self.hold = ton, toff, int(hold_frames)
        self.alpha_step = float(alpha_step)
        self.consts["g1_db"] = np.asarray(g1_db, np.float32)
        self.consts["g2_db"] = np.asarray(g2_db, np.float32)
        self.streaming, self.adaptive = streaming, adaptive

    def per_file(self, b, row, frames, s0, alpha0, n_valid, in_ty=None,
                 in_tw=None):
        sh = self.shards(frames, b, row, n_valid)
        levels, valid = [x[3] for x in sh], [x[2] for x in sh]
        gate = _sharded_gate_minhold if self.adaptive else \
            _sharded_gate_updelay
        states, gate_carry = gate(levels, self.ton, self.toff, self.hold,
                                  s0, valid)
        targets = [(st == 2).to(torch.float32) for st in states]
        a0 = alpha0
        if self.adaptive:
            # snap-first (ref adaptive: alpha[0] = target[0]): alpha0 < 0
            # is the "stream start" sentinel -> snap to the global first
            # target, gathered from shard 0
            t0 = targets[0][0].to(alpha0.device)
            a0 = torch.where(alpha0 < 0, t0, alpha0)
        alphas, alpha_carry = _sharded_alpha_ramp(
            targets, self.alpha_step, a0, valid)
        ys, masks = [], []
        for (dev, fr, v, _), alpha in zip(sh, alphas):
            mask = v.to(torch.float32)
            y = stft.apply_gain_bank(fr, self.const("win", dev), _blend_db(
                alpha, self.const("g1_db", dev), self.const("g2_db", dev)))
            ys.append(y * mask[:, None, None])
            masks.append(mask)
        out = _ola_halo_emit(ys, self.const("win2", sh[0][0]), masks, self.hop,
                             self.F_loc, in_ty, in_tw,
                             norm="floor8" if self.adaptive else "eps")
        emit = [o[0] for o in out]
        if not self.streaming:
            return emit, states, alphas, gate_carry, alpha_carry
        return (emit, levels, states, alphas, gate_carry, alpha_carry,
                [o[1] for o in out], [o[2] for o in out])


def sharded_process_step(mesh: Mesh, n_fft: int, hop: int,
                         frames_per_shard: int, channels: int,
                         ton: float, toff: float, delay_frames: int,
                         g1_lin, g2_lin, window=None):
    """The dp x sp processing step.

    Returns fn(frames [B, F, C, n_fft], s0 [B] int32, n_valid [B] int32)
    -> (emit [B, F*hop, C] normalised output, states [B, F], carry [B]),
    on the mesh's first device, with B split over 'data' and F over 'seq'.
    The trailing n_fft - hop samples of the last shard (the stream tail)
    are dropped: callers keep chunk boundaries aligned to shard boundaries,
    as the stream driver does."""
    return _GateStep(mesh, n_fft, hop, frames_per_shard, ton, toff,
                     delay_frames, g1_lin, g2_lin, window)


def sharded_stream_step(mesh: Mesh, n_fft: int, hop: int,
                        frames_per_shard: int, channels: int,
                        ton: float, toff: float, delay_frames: int,
                        g1_lin, g2_lin, window=None):
    """sharded_process_step with OLA tail carry across super-chunks: the
    building block of the file-to-file sharded path (parallel.stream).

    Returns fn(frames [B, F, C, n_fft], s0 [B], n_valid [B],
               in_tail_y [B, n_fft-hop, C], in_tail_w [B, n_fft-hop]) ->
        (emit [B, F*hop, C], levels [B, F], states [B, F], carry [B],
         out_tail_y [B, n_seq*(n_fft-hop), C], out_tail_w [B, n_seq*...])
    where only the LAST tail block of out_tail_* (the stream tail of the
    last 'seq' shard) is meaningful. The in_tails are added to shard 0's
    head (the previous super-chunk's carried overlap), exactly like the
    single-device engine's carried (out_tail, w_tail)."""
    return _GateStep(mesh, n_fft, hop, frames_per_shard, ton, toff,
                     delay_frames, g1_lin, g2_lin, window, streaming=True)


def sharded_xfade_step(mesh: Mesh, n_fft: int, hop: int,
                       frames_per_shard: int, channels: int,
                       ton: float, toff: float, delay_frames: int,
                       alpha_step: float, g1_db, g2_db, window=None):
    """dp x sp step for the CROSSFADE processor: block-scanned gate +
    block-scanned alpha ramp + per-frame dB-domain gain blend + OLA halo.

    fn(frames [B, F, C, n_fft], s0 [B], alpha0 [B], n_valid [B]) ->
        (emit [B, F*hop, C], states [B, F], alpha [B, F],
         gate_carry [B], alpha_carry [B])"""
    return _RampStep(mesh, n_fft, hop, frames_per_shard, ton, toff,
                     delay_frames, alpha_step, g1_db, g2_db, window)


def sharded_xfade_stream_step(mesh: Mesh, n_fft: int, hop: int,
                              frames_per_shard: int, channels: int,
                              ton: float, toff: float, delay_frames: int,
                              alpha_step: float, g1_db, g2_db,
                              window=None):
    """sharded_xfade_step with OLA tail carry across super-chunks.

    fn(frames, s0, alpha0, n_valid, in_tail_y [B, tail, C],
       in_tail_w [B, tail]) ->
        (emit, levels, states, alpha, gate_carry, alpha_carry,
         out_tail_y [B, n_seq*tail, C], out_tail_w [B, n_seq*tail])
    with only the last tail block of out_tail_* meaningful."""
    return _RampStep(mesh, n_fft, hop, frames_per_shard, ton, toff,
                     delay_frames, alpha_step, g1_db, g2_db, window,
                     streaming=True)


def sharded_adaptive_step(mesh: Mesh, n_fft: int, hop: int,
                          frames_per_shard: int, channels: int,
                          ton: float, toff: float, min_hold_frames: int,
                          alpha_step: float, g1_db, g2_db, window=None):
    """dp x sp step for the ADAPTIVE processor's streaming pass: min-hold
    gate (block scan) + snap-first alpha ramp (clip-affine block scan) +
    per-frame dB-domain gain blend + OLA halo with the max(w, 1e-8)
    normaliser. Threshold search and headroom handling stay host-side as
    in models/adaptive.py.

    fn(frames [B, F, C, n_fft], s0 [B], alpha0 [B], n_valid [B]) ->
        (emit [B, F*hop, C], states [B, F], alpha [B, F],
         gate_carry [B], alpha_carry [B])
    Stream start: s0 = min_hold_frames (the gate may switch on frame 0),
    alpha0 = -1.0 (the snap-first sentinel)."""
    return _RampStep(mesh, n_fft, hop, frames_per_shard, ton, toff,
                     min_hold_frames, alpha_step, g1_db, g2_db, window,
                     adaptive=True)


def sharded_adaptive_stream_step(mesh: Mesh, n_fft: int, hop: int,
                                 frames_per_shard: int, channels: int,
                                 ton: float, toff: float,
                                 min_hold_frames: int, alpha_step: float,
                                 g1_db, g2_db, window=None):
    """sharded_adaptive_step with OLA tail carry across super-chunks (the
    adaptive variant of the file-to-file sharded path); outputs as
    sharded_xfade_stream_step's."""
    return _RampStep(mesh, n_fft, hop, frames_per_shard, ton, toff,
                     min_hold_frames, alpha_step, g1_db, g2_db, window,
                     streaming=True, adaptive=True)


def frame_batch(signals: np.ndarray, n_fft: int, hop: int,
                n_frames: int) -> torch.Tensor:
    """Host helper: frame a [B, S, C] batch into [B, F, C, n_fft] (CPU)."""
    return torch.stack([stft.frame_signal(
        torch.from_numpy(np.ascontiguousarray(s, np.float32)), n_fft, hop,
        n_frames) for s in signals])
