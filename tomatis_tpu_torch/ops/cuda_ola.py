"""K-way overlap-add and the fused chunk tail: the hand-written CUDA
kernel's three entry points and their plain versions.

``overlap_add_cuda`` replaces the Pallas TPU kernel
tomatis_tpu/ops/pallas_ola.py::overlap_add_pallas one to one.
``chunk_tail_cuda`` replaces it together with the passes that follow it in
the chunk step (window, mask, the two overlap-adds, tail adds, normalise
and, for pcm24, output gain, peaks and PCM_24 quantise), in one launch.
``chunk_tail_batched_cuda`` is that chunk tail over B file lanes in one
launch, the counterpart of the kernel under jax.vmap in
tomatis_tpu/parallel/batch.py. csrc/ola.cu holds all three and its design
note. The library is built with
nvcc for sm_90a at first use, and each launch goes on the current CUDA
stream. A failed build or launch raises; nothing falls back to a plain
version on the card.

``overlap_add_plain``, ``chunk_tail_plain`` and ``chunk_tail_batched_plain``
are the same functions in torch ops: the CPU path, the tests' oracle and
the card check's yardstick.

With K = n_fft/hop, (F + K - 1)*hop == (F - 1)*hop + n_fft, so the
overlap-adds return exactly the L = (F-1)*hop + n_fft rows of
stft.overlap_add.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from tomatis_tpu_torch.ops.dsp import EPS

NORMS = ("eps", "floor8")
# the "floor8" normaliser floor, y/max(w, FLOOR8): one value for
# chunk_tail_plain, the adaptive processor's closing tail piece and the
# kernel (csrc/ola.cu writes the same number as 1e-8f)
FLOOR8 = 1e-8
TRANSPORTS = ("f32", "pcm24")


def _check_hop(y: torch.Tensor, hop: int):
    if y.ndim != 3:
        raise ValueError(f"expected frames [F, C, n_fft], got {tuple(y.shape)}")
    F, C, n_fft = y.shape
    if hop <= 0 or n_fft % hop:
        raise ValueError("the K-way overlap-add requires hop | n_fft")
    return F, C, n_fft, n_fft // hop


def overlap_add_plain(y: torch.Tensor, hop: int) -> torch.Tensor:
    """y [F, C, n_fft] -> [(F+K-1)*hop, C], K shifted adds."""
    F, C, n_fft, k = _check_hop(y, hop)
    yb = y.reshape(F, C, k, hop)
    out = torch.zeros((F + k - 1, C, hop), dtype=torch.float32,
                      device=y.device)
    for i in range(k):
        out[i:i + F] += yb[:, :, i, :]
    return out.permute(0, 2, 1).reshape((F + k - 1) * hop, C)


def _check_tail(z, win, win2, out_tail, w_tail, norm, transport):
    """Shapes of a chunk tail; hop is n_fft minus the carried tail length."""
    if norm not in NORMS:
        raise ValueError(f"norm must be one of {NORMS}, got {norm!r}")
    if transport not in TRANSPORTS:
        raise ValueError(
            f"transport must be one of {TRANSPORTS}, got {transport!r}")
    if z.ndim != 3 or z.shape[0] < 1:
        raise ValueError(f"expected frames [F, C, n_fft], got {tuple(z.shape)}")
    tail = out_tail.shape[0]
    F, C, n_fft, k = _check_hop(z, z.shape[-1] - tail)
    if (win.shape != (n_fft,) or win2.shape != (n_fft,)
            or out_tail.shape != (tail, C) or w_tail.shape != (tail,)):
        raise ValueError(
            f"chunk tail shapes: z {tuple(z.shape)}, win {tuple(win.shape)},"
            f" win2 {tuple(win2.shape)}, out_tail {tuple(out_tail.shape)},"
            f" w_tail {tuple(w_tail.shape)}")
    return F, C, n_fft, n_fft - tail, k


def chunk_tail_plain(z, win, win2, n_valid: int, out_tail, w_tail, gain_lin,
                     norm: str = "eps", transport: str = "f32"):
    """The chunk step after the irFFT, in torch ops.

    z [F, C, n_fft] raw irFFT frames; win, win2 [n_fft]; out_tail
    [tail, C] and w_tail [tail] the carried raw sums (tail = n_fft - hop);
    gain_lin a 0-d tensor (pcm24 only). Frames f >= n_valid are masked.

    Returns (out, peaks, pcm, ola_carry, w_carry): out is the normalised
    emit [L, C] (f32) or emit*gain (pcm24), L = (F + K - 1)*hop; peaks [W]
    the per-hop-block max |out| and pcm the [L*C*3] little-endian PCM_24
    bytes of clip(round(out * 2^23)), half to even (both None for f32);
    the carries are the raw sums past F*hop.

    norm: "eps" y/(w + 1e-12), the streaming processors' convention;
    "floor8" y/max(w, 1e-8), the adaptive processor's."""
    F, C, n_fft, hop, _ = _check_tail(z, win, win2, out_tail, w_tail, norm,
                                      transport)
    tail = n_fft - hop
    mask = (torch.arange(F, device=z.device) < n_valid).to(torch.float32)
    y = z * win * mask[:, None, None]
    ola = overlap_add_plain(y, hop)                         # [L, C]
    w = overlap_add_plain(win2[None, None, :] * mask[:, None, None],
                          hop)[:, 0]
    ola[:tail] += out_tail
    w[:tail] += w_tail
    if norm == "floor8":
        emit = ola / torch.clamp(w[:, None], min=FLOOR8)
    else:
        emit = ola / (w[:, None] + EPS)
    carries = (ola[F * hop:].clone(), w[F * hop:].clone())
    if transport == "f32":
        return (emit, None, None) + carries
    out = emit * gain_lin
    peaks = out.abs().reshape(-1, hop * C).amax(dim=1)
    v = torch.clamp(torch.round(out * 8388608.0),
                    -8388608, 8388607).to(torch.int32)
    # little-endian PCM_24: the low three bytes of each int32
    pcm = v.view(torch.uint8).reshape(-1, 4)[:, :3].reshape(-1)
    return (out, peaks, pcm) + carries


def _check_batched(z, win, win2, n_valid, out_tail, w_tail, norm,
                   transport):
    """Shapes of a batched chunk tail: lane 0 as _check_tail, then the
    lane axis of every per-lane tensor. Returns (B, F, C, n_fft, hop, k)."""
    if z.ndim != 4 or z.shape[0] < 1 or out_tail.ndim != 3 \
            or w_tail.ndim != 2:
        raise ValueError(f"expected frames [B, F, C, n_fft], tails [B, tail,"
                         f" C] and [B, tail], got {tuple(z.shape)}, "
                         f"{tuple(out_tail.shape)}, {tuple(w_tail.shape)}")
    B = z.shape[0]
    F, C, n_fft, hop, k = _check_tail(z[0], win, win2, out_tail[0],
                                      w_tail[0], norm, transport)
    if (out_tail.shape[0] != B or w_tail.shape[0] != B
            or n_valid.shape != (B,) or n_valid.dtype != torch.int32):
        raise ValueError(
            f"batched chunk tail: {B} lanes of frames, out_tail "
            f"{tuple(out_tail.shape)}, w_tail {tuple(w_tail.shape)}, n_valid "
            f"{tuple(n_valid.shape)} {n_valid.dtype} (int32 [B] expected)")
    return B, F, C, n_fft, hop, k


def chunk_tail_batched_plain(z, win, win2, n_valid, out_tail, w_tail,
                             gain_lin, norm: str = "eps",
                             transport: str = "f32"):
    """chunk_tail_plain lane by lane, each lane frozen when it has no valid
    frame.

    z [B, F, C, n_fft]; win, win2 [n_fft] and gain_lin shared; n_valid an
    int32 tensor [B]; out_tail [B, tail, C], w_tail [B, tail]. Returns
    (out [B, L, C], peaks [B, W], pcm [B, L*C*3], ola_carry [B, tail, C],
    w_carry [B, tail]), peaks and pcm None for f32. A lane with n_valid
    <= 0 returns its input tails as its carries (the reference's
    jnp.where(n_valid > 0, ...) under jax.vmap); its other outputs are
    what chunk_tail_plain computes for it."""
    _check_batched(z, win, win2, n_valid, out_tail, w_tail, norm, transport)
    lanes = []
    for b, nv in enumerate(n_valid.tolist()):
        r = chunk_tail_plain(z[b], win, win2, nv, out_tail[b], w_tail[b],
                             gain_lin, norm=norm, transport=transport)
        if nv <= 0:
            r = r[:3] + (out_tail[b].clone(), w_tail[b].clone())
        lanes.append(r)
    return tuple(None if parts[0] is None else torch.stack(parts)
                 for parts in zip(*lanes))


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from tomatis_tpu_torch.native.build import load_library
        lib = load_library("ola")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tomatis_ola_f32.argtypes = [p, p, i, i, i, i, p]
        lib.tomatis_ola_f32.restype = i
        lib.tomatis_chunk_tail_f32.argtypes = [p] * 11 + [i] * 7 + [p]
        lib.tomatis_chunk_tail_f32.restype = i
        lib.tomatis_chunk_tail_batched_f32.argtypes = [p] * 12 + [i] * 7 + [p]
        lib.tomatis_chunk_tail_batched_f32.restype = i
        lib.tomatis_cuda_error_string.argtypes = [i]
        lib.tomatis_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def build() -> None:
    """Build (if stale) and load the kernel library."""
    _lib()


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + _lib().tomatis_cuda_error_string(err).decode())


def overlap_add_cuda(y: torch.Tensor, hop: int) -> torch.Tensor:
    """y [F, C, n_fft] float32 on CUDA -> [(F+K-1)*hop, C] on CUDA.

    Counts each launch in ``overlap_add_cuda.launches``."""
    F, C, n_fft, k = _check_hop(y, hop)
    if not y.is_cuda:
        raise ValueError("overlap_add_cuda takes a CUDA tensor")
    if y.dtype != torch.float32:
        raise TypeError(f"overlap_add_cuda takes float32, got {y.dtype}")
    y = y.contiguous()
    out = torch.empty(((F + k - 1) * hop, C), dtype=torch.float32,
                      device=y.device)
    lib = _lib()
    stream = torch.cuda.current_stream(y.device).cuda_stream
    with torch.cuda.device(y.device):
        err = lib.tomatis_ola_f32(y.data_ptr(), out.data_ptr(), F, C, n_fft,
                                  hop, stream)
    _raise_on(err, "overlap-add")
    overlap_add_cuda.launches += 1
    return out


overlap_add_cuda.launches = 0


def chunk_tail_cuda(z, win, win2, n_valid: int, out_tail, w_tail, gain_lin,
                    norm: str = "eps", transport: str = "f32"):
    """chunk_tail_plain's function in one launch of the fused kernel, on
    CUDA tensors: float32, contiguous, on one device (gain_lin too, for
    pcm24; it is read through its pointer, so there is no host sync).
    Returns fresh tensors, as chunk_tail_plain does.

    Counts each launch in ``chunk_tail_cuda.launches``, per variant in
    ``chunk_tail_cuda.by_variant[(norm, transport, C)]`` and per chunk
    size in ``chunk_tail_cuda.by_frames[F]``."""
    F, C, n_fft, hop, k = _check_tail(z, win, win2, out_tail, w_tail, norm,
                                      transport)
    pcm24 = transport == "pcm24"
    ins = [z, win, win2, out_tail, w_tail] + ([gain_lin] if pcm24 else [])
    if pcm24 and gain_lin.numel() != 1:
        raise ValueError("gain_lin must hold one value")
    for t in ins:
        if t.dtype != torch.float32:
            raise TypeError(f"chunk_tail_cuda takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("chunk_tail_cuda takes contiguous tensors")
        if not t.is_cuda or t.device != z.device:
            raise ValueError("chunk_tail_cuda takes CUDA tensors on one "
                             "device")
    dev, tail, W = z.device, n_fft - hop, F + k - 1
    out = torch.empty((W * hop, C), dtype=torch.float32, device=dev)
    ola_carry = torch.empty((tail, C), dtype=torch.float32, device=dev)
    w_carry = torch.empty((tail,), dtype=torch.float32, device=dev)
    peaks = pcm = None
    if pcm24:
        peaks = torch.empty((W,), dtype=torch.float32, device=dev)
        pcm = torch.empty((W * hop * C * 3,), dtype=torch.uint8, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.tomatis_chunk_tail_f32(
            ptr(z), ptr(win), ptr(win2), ptr(out_tail), ptr(w_tail),
            ptr(gain_lin) if pcm24 else None, ptr(out), ptr(peaks), ptr(pcm),
            ptr(ola_carry), ptr(w_carry), F, C, n_fft, hop,
            max(0, min(int(n_valid), F)), NORMS.index(norm),
            TRANSPORTS.index(transport), stream)
    _raise_on(err, "chunk-tail")
    chunk_tail_cuda.launches += 1
    chunk_tail_cuda.by_variant[(norm, transport, C)] += 1
    chunk_tail_cuda.by_frames[F] += 1
    return out, peaks, pcm, ola_carry, w_carry


chunk_tail_cuda.launches = 0
chunk_tail_cuda.by_variant = collections.Counter()
chunk_tail_cuda.by_frames = collections.Counter()


def chunk_tail_batched_cuda(z, win, win2, n_valid, out_tail, w_tail,
                            gain_lin, norm: str = "eps",
                            transport: str = "f32"):
    """chunk_tail_batched_plain's function in ONE launch of the fused
    kernel for all B lanes, on CUDA tensors: float32 (n_valid int32),
    contiguous, on one device. The kernel reads n_valid and gain_lin
    through their pointers, so there is no host sync.

    Counts each launch in ``chunk_tail_batched_cuda.launches``, and per
    variant in ``chunk_tail_batched_cuda.by_variant[(norm, transport,
    C)]``."""
    B, F, C, n_fft, hop, k = _check_batched(z, win, win2, n_valid, out_tail,
                                            w_tail, norm, transport)
    pcm24 = transport == "pcm24"
    if pcm24 and gain_lin.numel() != 1:
        raise ValueError("gain_lin must hold one value")
    ins = [z, win, win2, out_tail, w_tail, n_valid] + (
        [gain_lin] if pcm24 else [])
    for t in ins:
        if t is not n_valid and t.dtype != torch.float32:
            raise TypeError(
                f"chunk_tail_batched_cuda takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("chunk_tail_batched_cuda takes contiguous "
                             "tensors")
        if not t.is_cuda or t.device != z.device:
            raise ValueError("chunk_tail_batched_cuda takes CUDA tensors on "
                             "one device")
    if B > 65535:
        raise ValueError(f"{B} lanes: the launch takes at most 65535")
    dev, tail, W = z.device, n_fft - hop, F + k - 1
    out = torch.empty((B, W * hop, C), dtype=torch.float32, device=dev)
    ola_carry = torch.empty((B, tail, C), dtype=torch.float32, device=dev)
    w_carry = torch.empty((B, tail), dtype=torch.float32, device=dev)
    peaks = pcm = None
    if pcm24:
        peaks = torch.empty((B, W), dtype=torch.float32, device=dev)
        pcm = torch.empty((B, W * hop * C * 3), dtype=torch.uint8,
                          device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.tomatis_chunk_tail_batched_f32(
            ptr(z), ptr(win), ptr(win2), ptr(out_tail), ptr(w_tail),
            ptr(gain_lin) if pcm24 else None, ptr(n_valid), ptr(out),
            ptr(peaks), ptr(pcm), ptr(ola_carry), ptr(w_carry), B, F, C,
            n_fft, hop, NORMS.index(norm), TRANSPORTS.index(transport),
            stream)
    _raise_on(err, "batched chunk-tail")
    chunk_tail_batched_cuda.launches += 1
    chunk_tail_batched_cuda.by_variant[(norm, transport, C)] += 1
    return out, peaks, pcm, ola_carry, w_carry


chunk_tail_batched_cuda.launches = 0
chunk_tail_batched_cuda.by_variant = collections.Counter()
