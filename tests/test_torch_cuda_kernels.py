"""The CUDA kernels of csrc/ola.cu against their plain PyTorch versions on
a card: the standalone overlap-add, the fused chunk tail and the batched
chunk tail (a lane axis, one launch for every lane).

This file imports no jax and nothing of the JAX package, so it runs on a
machine with a card and no jax. There tests/conftest.py (which imports
jax) is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Without a card the kernel cases skip; the wrapper contracts run anywhere.
"""
import numpy as np
import pytest
import torch

from tomatis_tpu_torch.ops import cuda_ola

torch.set_num_threads(2)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _tail_args(F_=4, C=2, n_fft=16, hop=8, dev="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    z = torch.randn((F_, C, n_fft), generator=g)
    win = torch.rand((n_fft,), generator=g)
    tail = n_fft - hop
    args = (z, win, win * win, F_, torch.randn((tail, C), generator=g),
            torch.rand((tail,), generator=g), torch.tensor(0.9))
    return tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                 for a in args)


def _batched_args(B, F_, C, n_fft, hop, n_valid, dev="cpu", seed=0):
    """Batched chunk-tail inputs: z [B, F, C, n_fft], shared windows and
    gain, n_valid int32 [B], tails [B, tail, C] and [B, tail]."""
    g = torch.Generator().manual_seed(seed)
    tail = n_fft - hop
    win = torch.rand((n_fft,), generator=g)
    return dict(
        z=torch.randn((B, F_, C, n_fft), generator=g).to(dev),
        win=win.to(dev), win2=(win * win).to(dev),
        n_valid=torch.tensor(n_valid, dtype=torch.int32, device=dev),
        out_tail=torch.randn((B, tail, C), generator=g).to(dev),
        w_tail=torch.rand((B, tail), generator=g).to(dev),
        gain_lin=torch.tensor(0.9, device=dev))


def _assert_same(got, ref, what):
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if r is not None:
            assert g.shape == r.shape and g.dtype == r.dtype, what
            assert torch.equal(g, r), what


@pytest.mark.cuda
def test_cuda_ola_matches_plain_on_card():
    _card()
    rng = np.random.default_rng(7)
    F, C, n_fft, hop = 64, 2, 4096, 2048
    y = torch.from_numpy(
        rng.standard_normal((F, C, n_fft)).astype(np.float32)).cuda()
    n0 = cuda_ola.overlap_add_cuda.launches
    got = cuda_ola.overlap_add_cuda(y, hop)
    torch.cuda.synchronize()
    assert cuda_ola.overlap_add_cuda.launches == n0 + 1
    ref = cuda_ola.overlap_add_plain(y, hop)
    assert torch.equal(got, ref)   # K=2: one add per sample, exact


@pytest.mark.cuda
@pytest.mark.parametrize("F,C,n_fft,hop", [(256, 2, 4096, 2048),
                                           (256, 1, 4096, 2048),
                                           (23, 2, 1024, 512),
                                           (23, 1, 1024, 512)])
def test_cuda_ola_at_the_sharded_shapes_on_card(F, C, n_fft, hop):
    """The shapes process-sharded gives the standalone overlap-add: a
    shard of frames_per_shard frames (256 in production, 23 in the CPU
    tests, a count no tile divides), the frames at C = 2 and the window
    weights at C = 1. K = 2: equal to the plain version bit for bit."""
    _card()
    rng = np.random.default_rng(F * 10 + C)
    y = torch.from_numpy(
        rng.standard_normal((F, C, n_fft)).astype(np.float32)).cuda()
    n0 = cuda_ola.overlap_add_cuda.launches
    got = cuda_ola.overlap_add_cuda(y, hop)
    torch.cuda.synchronize()
    assert cuda_ola.overlap_add_cuda.launches == n0 + 1
    assert got.shape == ((F - 1) * hop + n_fft, C)
    assert torch.equal(got, cuda_ola.overlap_add_plain(y, hop))


@pytest.mark.cuda
def test_chunk_tail_cuda_equals_plain_on_card():
    _card()
    cases = [(64, 2, 4096, 2048, 64), (64, 2, 4096, 2048, 30),
             (9, 2, 384, 128, 9), (7, 1, 512, 128, 7), (6, 2, 300, 150, 6),
             (5, 3, 256, 128, 5), (3, 2, 256, 128, 0)]
    for F_, C, n_fft, hop, n_valid in cases:
        z, win, win2, _, ot, wt, gain = _tail_args(F_, C, n_fft, hop, "cuda",
                                                   seed=F_)
        for transport in ("f32", "pcm24"):
            for norm in ("eps", "floor8"):
                n0 = cuda_ola.chunk_tail_cuda.launches
                got = cuda_ola.chunk_tail_cuda(z, win, win2, n_valid, ot, wt,
                                               gain, norm, transport)
                torch.cuda.synchronize()
                assert cuda_ola.chunk_tail_cuda.launches == n0 + 1
                ref = cuda_ola.chunk_tail_plain(z, win, win2, n_valid, ot, wt,
                                                gain, norm, transport)
                _assert_same(got, ref, (F_, C, n_fft, hop, transport, norm))


@pytest.mark.cuda
def test_chunk_tail_batched_cuda_equals_plain_on_card():
    """Every lane bit for bit, frozen lanes (n_valid 0 or below) included,
    in one launch."""
    _card()
    cases = [(64, 2, 4096, 2048, [64, 0, 30, 64]),
             (9, 2, 384, 128, [0, 9, 4]), (7, 1, 512, 128, [7, 0]),
             (6, 2, 300, 150, [6, -1]), (5, 3, 256, 128, [0, 5]),
             (3, 2, 256, 128, [0])]
    for F_, C, n_fft, hop, n_valid in cases:
        a = _batched_args(len(n_valid), F_, C, n_fft, hop, n_valid, "cuda",
                          seed=F_)
        for transport in ("f32", "pcm24"):
            for norm in ("eps", "floor8"):
                n0 = cuda_ola.chunk_tail_batched_cuda.launches
                got = cuda_ola.chunk_tail_batched_cuda(
                    norm=norm, transport=transport, **a)
                torch.cuda.synchronize()
                assert cuda_ola.chunk_tail_batched_cuda.launches == n0 + 1
                ref = cuda_ola.chunk_tail_batched_plain(
                    norm=norm, transport=transport, **a)
                _assert_same(got, ref, (F_, C, n_fft, hop, n_valid,
                                        transport, norm))


@pytest.mark.cuda
def test_chunk_tail_batched_one_lane_equals_chunk_tail_cuda_on_card():
    """B = 1 is today's single-file launch, bit for bit in every output."""
    _card()
    for F_, C, n_fft, hop, n_valid in [(64, 2, 4096, 2048, 64),
                                       (64, 2, 4096, 2048, 30),
                                       (7, 1, 512, 128, 7),
                                       (5, 3, 256, 128, 5)]:
        a = _batched_args(1, F_, C, n_fft, hop, [n_valid], "cuda", seed=C)
        for transport in ("f32", "pcm24"):
            got = cuda_ola.chunk_tail_batched_cuda(transport=transport, **a)
            one = cuda_ola.chunk_tail_cuda(
                a["z"][0], a["win"], a["win2"], n_valid, a["out_tail"][0],
                a["w_tail"][0], a["gain_lin"], transport=transport)
            torch.cuda.synchronize()
            _assert_same([None if g is None else g[0] for g in got], one,
                         (F_, C, n_fft, hop, n_valid, transport))


def test_chunk_tail_batched_cuda_refuses_what_it_cannot_launch():
    a = _batched_args(2, 4, 2, 16, 8, [4, 0])
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ola.chunk_tail_batched_cuda(transport="pcm24", **a)
    with pytest.raises(TypeError, match="float32"):
        cuda_ola.chunk_tail_batched_cuda(**dict(a, z=a["z"].double()))
    z_nc = a["z"].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ola.chunk_tail_batched_cuda(**dict(a, z=z_nc))
    for bad in (dict(n_valid=a["n_valid"].long()),          # not int32
                dict(n_valid=a["n_valid"][:1]),             # not [B]
                dict(w_tail=a["w_tail"][:1]),               # lanes differ
                dict(z=a["z"][0])):                         # no lane axis
        for fn in (cuda_ola.chunk_tail_batched_plain,
                   cuda_ola.chunk_tail_batched_cuda):
            with pytest.raises(ValueError):
                fn(**dict(a, **bad))
