"""Port's K-way overlap-add vs the JAX package's (XLA path and the Pallas
kernel in interpret mode). The CUDA kernel runs against its plain version
in the jax-free tests/test_torch_cuda_kernels.py, where a card exists."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tomatis_tpu.ops import stft as jstft
from tomatis_tpu.ops.pallas_ola import overlap_add_pallas
from tomatis_tpu_torch.ops import cuda_ola, stft

torch.set_num_threads(2)

SHAPES = [
    (7, 2, 256, 128),      # k=2 (the engine's default shape family)
    (5, 1, 512, 128),      # k=4
    (1, 2, 256, 128),      # single frame
    (12, 2, 384, 128),     # k=3, odd frame count
]


def _frames(F, C, n_fft):
    rng = np.random.default_rng(F * 1000 + n_fft)
    return rng.standard_normal((F, C, n_fft)).astype(np.float32)


@pytest.mark.parametrize("F,C,n_fft,hop", SHAPES)
def test_plain_ola_matches_jax(F, C, n_fft, hop):
    y = _frames(F, C, n_fft)
    ref = np.asarray(jstft.overlap_add(jnp.asarray(y), hop))
    got = cuda_ola.overlap_add_plain(torch.from_numpy(y), hop).numpy()
    assert got.shape == ref.shape == ((F - 1) * hop + n_fft, C)
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("F,C,n_fft,hop", SHAPES)
def test_stft_overlap_add_matches_pallas_interpret(F, C, n_fft, hop):
    y = _frames(F, C, n_fft)
    pal = np.asarray(overlap_add_pallas(jnp.asarray(y), hop, interpret=True))
    got = stft.overlap_add(torch.from_numpy(y), hop).numpy()
    # the pallas tile span (F+K-1)*hop equals L, so the shapes agree
    assert got.shape == pal.shape
    np.testing.assert_allclose(got, pal, atol=1e-6)


@pytest.mark.parametrize("F,C,n_fft,hop", [(6, 2, 300, 128), (3, 1, 250, 100)])
def test_scatter_ola_matches_jax(F, C, n_fft, hop):
    """hop does not divide n_fft: the index_add_ scatter path."""
    y = _frames(F, C, n_fft)
    ref = np.asarray(jstft.overlap_add(jnp.asarray(y), hop))
    got = stft.overlap_add(torch.from_numpy(y), hop).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_window_ola_matches_jax():
    win2 = jstft.hann_symmetric(256) ** 2
    ref = np.asarray(jstft.window_ola(jnp.asarray(win2), 9, 128))
    got = stft.window_ola(torch.from_numpy(win2), 9, 128).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_ola_rejects_bad_hop():
    y = torch.zeros((3, 2, 300))
    with pytest.raises(ValueError):
        cuda_ola.overlap_add_plain(y, 128)
    with pytest.raises(ValueError):
        cuda_ola.overlap_add_cuda(y, 128)


def test_cuda_wrapper_refuses_cpu_tensor():
    """On the CPU the kernel's wrapper raises; only stft.overlap_add picks
    the plain version, and only for a CPU tensor."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_ola.overlap_add_cuda(torch.zeros((2, 2, 256)), 128)
