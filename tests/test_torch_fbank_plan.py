"""The host side of the redesigned fbank and maxpool forward kernels: the
mel band table and the twiddles the FFT fbank kernel reads, the functions
that pick a kernel by shape and alignment before the launch, and the
float64 plain fbank that the card's FFT kernel is held against.  The
kernels themselves run on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from kaldi_cnn_tpu.features import functional as JF
from kaldi_cnn_tpu.ops.fbank_pallas import fbank_pallas
from kaldi_cnn_tpu_torch.features import functional as F
from kaldi_cnn_tpu_torch.ops import fbank as fb
from kaldi_cnn_tpu_torch.ops import maxpool as mp

ATOL = 1e-3     # log-mel and log energy against the f32 Pallas/plain path


def _opts(pkg, sr, bins, pow2=True):
    o = pkg.FbankOptions()
    o.frame_opts.samp_freq = float(sr)
    o.frame_opts.dither = 0.0
    o.frame_opts.round_to_power_of_two = pow2
    o.mel_opts.num_bins = bins
    o.use_energy = True
    return o


@pytest.mark.parametrize("sr", [8000, 16000])
@pytest.mark.parametrize("bins", [23, 36, 40])
def test_mel_bands_rebuild_mel_banks_exactly(sr, bins):
    fo, mo = _opts(F, sr, bins).frame_opts, _opts(F, sr, bins).mel_opts
    mel = F.mel_banks(mo, fo)
    bands, weights = fb.mel_bands(mel)
    assert bands.dtype == np.int32 and bands.shape == (2, bins)
    first, length = bands
    assert weights.dtype == np.float32
    assert weights.shape == (length.max(), bins)
    assert weights.size < mel.size // 2              # bands, not rows
    assert (length > 0).all()
    dense = np.zeros_like(mel)
    for m in range(bins):
        dense[m, first[m]:first[m] + length[m]] = weights[:length[m], m]
        assert (weights[length[m]:, m] == 0).all()
    np.testing.assert_array_equal(dense, mel)
    # each band starts and ends on a nonzero weight
    assert (mel[np.arange(bins), first] != 0).all()
    assert (mel[np.arange(bins), first + length - 1] != 0).all()


@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024, 2048])
def test_twiddles_match_numpy_fft(n):
    tw = fb.fft_twiddles(n)
    assert tw.dtype == np.float32 and tw.shape == (n + 64, 2)
    # exp(-2 pi i t / n), t < n, then exp(-2 pi i j / 64), j < 64
    want = np.concatenate([np.fft.fft(np.eye(n)[1]),
                           np.fft.fft(np.eye(64)[1])])
    np.testing.assert_allclose(tw[:, 0], want.real, rtol=0, atol=1e-7)
    np.testing.assert_allclose(tw[:, 1], want.imag, rtol=0, atol=1e-7)


@pytest.mark.parametrize("sr,pow2,length_ms,want", [
    (8000, True, 25.0, "fft"),           # N 256, the slice
    (16000, True, 25.0, "fft"),          # N 512, the bench
    (8000, False, 25.0, "table"),        # N = ws = 200
    (16000, False, 25.0, "table"),       # 400
    (16000, False, 16.0, "fft"),         # ws = 256: a power of two anyway
    (2000, True, 16.0, "table"),         # ws 32 -> N 32 < 64
    (48000, True, 40.0, "fft"),          # ws 1920 -> N 2048
    (48000, True, 50.0, "table"),        # ws 2400 -> N 4096 > 2048
])
def test_fbank_kernel_choice(sr, pow2, length_ms, want):
    fo = F.FrameExtractionOptions(samp_freq=float(sr),
                                  frame_length_ms=length_ms,
                                  round_to_power_of_two=pow2)
    assert fb.fbank_kernel(fo) == want


@pytest.mark.parametrize("shape,dtype,offset,want", [
    ((8, 30, 64, 2, 3, 1), torch.float32, 0, "vector"),     # the recipe
    ((8, 30, 128, 2, 3, 1), torch.float32, 0, "vector"),    # the bench
    ((8, 30, 64, 2, 3, 1), torch.bfloat16, 0, "vector"),
    ((8, 30, 128, 1, 2, 1), torch.bfloat16, 0, "vector"),
    ((8, 30, 64, 2, 3, 2), torch.float32, 0, "scalar"),     # pool_c = 2
    ((8, 30, 63, 2, 3, 1), torch.float32, 0, "scalar"),     # odd in_c
    ((8, 30, 4, 2, 3, 1), torch.bfloat16, 0, "scalar"),     # 4 % 8 lanes
    ((8, 30, 64, 2, 3, 1), torch.float32, 4, "scalar"),     # misaligned
    ((8, 30, 64, 2, 3, 1), torch.bfloat16, 8, "scalar"),
    ((8, 30, 64, 2, 3, 1), torch.float32, 32, "vector"),
])
def test_maxpool_forward_kernel_choice(shape, dtype, offset, want):
    pool = mp.Pool3D(*shape)
    # a view that starts ``offset`` bytes into a 16-byte aligned buffer
    # (PyTorch's CPU allocator aligns to 64 bytes)
    in_dim = shape[0] * shape[1] * shape[2]
    esize = dtype.itemsize
    buf = torch.zeros(3 * in_dim + offset // esize, dtype=dtype)
    view = buf[offset // esize:].view(3, in_dim)
    assert buf.data_ptr() % 16 == 0 and view.is_contiguous()
    assert mp.forward_kernel(pool, dtype, view.data_ptr()) == want
    out = torch.empty(3, 10, dtype=dtype)
    assert mp.forward_kernel(pool, dtype, view.data_ptr(),
                             out.data_ptr()) == want


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU neither wrapper launches or counts a kernel."""
    pool = mp.Pool3D(8, 30, 64, 2, 3, 1)
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(3, 15360))
                        .astype(np.float32))
    before = (mp.maxpool3d.launches, mp.maxpool3d_scalar.launches)
    y, arg = mp.maxpool3d(x, pool, with_argmax=True)
    ys, args = mp.maxpool3d_scalar(x, pool, with_argmax=True)
    want, want_arg = mp.maxpool3d_reference(x, pool, with_argmax=True)
    assert (mp.maxpool3d.launches, mp.maxpool3d_scalar.launches) == before
    assert torch.equal(y, want) and torch.equal(ys, want)
    assert torch.equal(arg, want_arg) and torch.equal(args, want_arg)
    frames = torch.as_tensor(np.random.default_rng(1).normal(size=(7, 200))
                             .astype(np.float32))
    opts = _opts(F, 8000, 36)
    before = (fb.fbank_frames.launches, fb.fbank_frames_table.launches)
    a = fb.fbank_frames(frames, opts)
    b = fb.fbank_frames_table(frames, opts)
    assert (fb.fbank_frames.launches, fb.fbank_frames_table.launches) == \
        before
    for got, want in zip(a + b, 2 * fb.fbank_reference_frames(frames, opts)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("sr,bins", [(8000, 36), (16000, 23)])
def test_float64_plain_fbank_matches_pallas(sr, bins):
    """The plain version in float64 (float64 DFT tables), which the card's
    FFT kernel is held against, agrees with the JAX package's Pallas
    kernel and with the float32 plain version."""
    wave = (np.random.default_rng(sr).normal(size=sr // 2) * 1000
            ).astype(np.float32)
    want = np.asarray(fbank_pallas(jnp.asarray(wave), _opts(JF, sr, bins)))
    opts = _opts(F, sr, bins)
    frames = F.extract_frames(torch.as_tensor(wave), opts.frame_opts)
    out64, e64 = fb.fbank_reference_frames(frames.double(), opts)
    out32, e32 = fb.fbank_reference_frames(frames, opts)
    assert out64.dtype == e64.dtype == torch.float64
    got = torch.cat([e64[:, None], out64], dim=1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(out32.numpy(), out64.numpy(), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(e32.numpy(), e64.numpy(), rtol=0, atol=ATOL)


def test_table_fbank_plain_without_power_of_two_matches_pallas():
    """round_to_power_of_two=False, the table kernel's shape: the plain
    version against the Pallas kernel at N = ws = 200."""
    wave = (np.random.default_rng(7).normal(size=4000) * 1000
            ).astype(np.float32)
    want = np.asarray(fbank_pallas(jnp.asarray(wave),
                                   _opts(JF, 8000, 36, pow2=False)))
    got = fb.fbank_reference(torch.as_tensor(wave),
                             _opts(F, 8000, 36, pow2=False)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
