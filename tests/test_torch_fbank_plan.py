"""The host side of the redesigned fbank and maxpool kernels: the mel band
table and the twiddles the FFT fbank kernels read, the mixed-radix
kernel's steps in float64, the functions that pick a kernel by shape and
alignment before the launch, and the float64 plain fbank that the card's
FFT kernels are held against.  The kernels themselves run on the card
(tests/test_torch_cuda.py)."""

import math

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


@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024, 2048]
                         + list(fb.MIXED_SIZES))
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
    (8000, False, 25.0, "mixed"),        # N = ws = 200 = 50 x 4
    (16000, False, 25.0, "mixed"),       # 400 = 50 x 8
    (4000, False, 25.0, "mixed"),        # 100 = 50 x 2
    (32000, False, 25.0, "mixed"),       # 800
    (64000, False, 25.0, "mixed"),       # 1600 = 50 x 32
    (128000, False, 25.0, "table"),      # 3200 = 50 x 64: too many lanes
    (16000, False, 20.0, "table"),       # 320: not 50 L
    (8000, False, 30.0, "table"),        # 240
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


# (in_t, in_f, in_c, pool_t, pool_f, pool_c): tests/test_torch_cuda.py's
# POOL_SHAPES (the bench/recipe conv outputs with the recipe's pool and
# F = 48, pool_c > 1, a 128-element window, a 1x1x1 window on odd in_c)
POOL_SHAPES = [(8, 30, 128, 2, 3, 1), (8, 30, 64, 2, 3, 1),
               (8, 30, 48, 2, 3, 1), (4, 6, 8, 2, 3, 2), (4, 8, 16, 4, 4, 8),
               (3, 5, 7, 1, 1, 1)]


@pytest.mark.parametrize("shape", POOL_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("misaligned", [None, 0, 1, 2])
def test_maxpool_backward_kernel_choice(shape, dtype, misaligned):
    """backward_kernel picks as forward_kernel does: the vector kernel on
    pool_c = 1 and in_c a multiple of the 16-byte vector's lanes with
    the derivative, the argmax and the input derivative 16-byte aligned,
    the scalar one if any of the three is not."""
    pool = mp.Pool3D(*shape)
    lanes = 16 // dtype.itemsize
    *_, in_dim, out_dim = mp._dims(pool)
    adt = mp.argmax_dtype(pool)
    bufs = [torch.zeros(2 * out_dim + 1, dtype=dtype),
            torch.zeros(2 * out_dim + 1, dtype=adt),
            torch.zeros(2 * in_dim + 1, dtype=dtype)]
    assert all(b.data_ptr() % 16 == 0 for b in bufs)
    views = [b[int(i == misaligned):][:b.numel() - 1]
             for i, b in enumerate(bufs)]
    ptrs = [v.data_ptr() for v in views]
    want = ("vector" if pool.pool_c == 1 and pool.in_c % lanes == 0
            and misaligned is None else "scalar")
    assert mp.backward_kernel(pool, dtype, *ptrs) == want
    assert mp.backward_kernel(pool, dtype, *ptrs) == mp.forward_kernel(
        pool, dtype, *ptrs)


def _bitrev(i, bits):
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def _mixed_rfft(x: np.ndarray, n: int) -> np.ndarray:
    """csrc/fbank.cu's fbank_mixed_kernel, step for step in float64 on
    [T, n] real frames -> [T, n / 2 + 1] complex: lane l < L = n / 50 of a
    frame holds z[q] = x[2q] + i x[2q+1] for q = l + L m in register m <
    25; the 25-point DFT as 5 x 5 radix-5 butterflies with the W_25
    twiddles between (register 5 c + d then holds bin c + 5 d), W_H^{l
    k1}, the radix-2 DIF across the lanes (lane l then holds k2 =
    bitrev(l)), and the real-FFT post-pass, every twiddle a power of
    W_N = exp(-2 pi i / n), as the kernel reads them from the first n
    rows of ``fft_twiddles(n)``."""
    L, P, H = n // 50, 25, n // 2
    lb = L.bit_length() - 1
    W = np.exp(-2j * np.pi * np.arange(n) / n)
    z = x[:, 0::2] + 1j * x[:, 1::2]                      # [T, H]
    reg = z.reshape(-1, P, L).transpose(0, 2, 1).copy()  # [T, lane, m]
    c1, c2 = math.cos(2 * math.pi / 5), math.cos(4 * math.pi / 5)
    s1, s2 = math.sin(2 * math.pi / 5), math.sin(4 * math.pi / 5)

    def dft5(idx):
        a0, a1, a2, a3, a4 = (reg[..., i].copy() for i in idx)
        t1, t2, t3, t4 = a1 + a4, a2 + a3, a1 - a4, a2 - a3
        b1, b2 = a0 + c1 * t1 + c2 * t2, a0 + c2 * t1 + c1 * t2
        u, v = s1 * t3 + s2 * t4, s2 * t3 - s1 * t4
        for i, val in zip(idx, (a0 + t1 + t2, b1 - 1j * u, b2 - 1j * v,
                                b2 + 1j * v, b1 + 1j * u)):
            reg[..., i] = val

    for b in range(5):
        dft5([b + 5 * j for j in range(5)])
    for c in range(1, 5):
        for b in range(1, 5):
            reg[..., 5 * c + b] *= W[2 * L * b * c]
    for c in range(5):
        dft5([5 * c + j for j in range(5)])
    k1 = [r // 5 + 5 * (r % 5) for r in range(P)]
    lanes = np.arange(L)
    for r in range(P):
        reg[:, :, r] *= W[2 * lanes * k1[r]]
    d = L // 2
    while d >= 1:
        upper = (lanes & d) != 0
        other = reg[:, lanes ^ d, :]
        s = np.where(upper[None, :, None], other - reg, reg + other)
        if d > 1:
            w = np.where(upper, W[(lanes & (d - 1)) * (P * L // d)], 1)
            s = s * w[None, :, None]
        reg, d = s, d // 2
    k2 = np.array([_bitrev(i, lb) for i in lanes])
    mirror = np.array([_bitrev((L - k) % L, lb) for k in k2])
    out = np.empty((x.shape[0], H + 1), complex)
    for r in range(P):
        if k1[r]:
            k = P - k1[r]
            b = reg[:, lanes ^ (L - 1), 5 * (k % 5) + k // 5]
        else:
            b = reg[:, mirror, 0]
        a = reg[:, :, r]
        e, o = 0.5 * (a + b.conj()), -0.5j * (a - b.conj())
        k = k1[r] + P * k2
        out[:, k] = e + W[k] * o
    out[:, H] = reg[:, 0, 0].real - reg[:, 0, 0].imag
    return out


@pytest.mark.parametrize("n", fb.MIXED_SIZES)
def test_mixed_radix_steps_give_numpy_rfft(n):
    """The mixed-radix kernel's decomposition and index maps, run in
    float64 on random frames, give numpy's rfft to 1e-9 relative."""
    x = np.random.default_rng(n).normal(size=(5, n))
    got, want = _mixed_rfft(x, n), np.fft.rfft(x, axis=1)
    assert got.shape == want.shape == (5, n // 2 + 1)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-9, err


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


def test_cpu_tensors_take_the_plain_mixed_fbank_and_backward():
    """On the CPU the mixed-radix fbank wrapper and both maxpool
    backward wrappers launch and count nothing."""
    frames = torch.as_tensor(np.random.default_rng(2).normal(size=(7, 400))
                             .astype(np.float32))
    opts = _opts(F, 16000, 23, pow2=False)
    assert fb.fbank_kernel(opts.frame_opts) == "mixed"
    before = (fb.fbank_frames.launches, fb.fbank_frames_mixed.launches,
              fb.fbank_frames_table.launches)
    want = fb.fbank_reference_frames(frames, opts)
    for got in (fb.fbank_frames(frames, opts),
                fb.fbank_frames_mixed(frames, opts)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (fb.fbank_frames.launches, fb.fbank_frames_mixed.launches,
            fb.fbank_frames_table.launches) == before
    pool = mp.Pool3D(8, 30, 64, 2, 3, 1)
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(3, 15360))
                        .astype(np.float32))
    y, arg = mp.maxpool3d(x, pool, with_argmax=True)
    before = (mp.maxpool3d_backward.launches,
              mp.maxpool3d_backward_scalar.launches)
    want = mp.maxpool3d_backward_reference(y, arg, pool)
    assert torch.equal(mp.maxpool3d_backward(y, arg, pool), want)
    assert torch.equal(mp.maxpool3d_backward_scalar(y, arg, pool), want)
    assert (mp.maxpool3d_backward.launches,
            mp.maxpool3d_backward_scalar.launches) == before


@pytest.mark.parametrize("bins", [23, 40])
def test_plain_fbank_at_400_points_without_power_of_two_matches_pallas(bins):
    """round_to_power_of_two=False at 16 kHz (N = ws = 400, the mixed-radix
    kernel's size): the plain version in float32 and float64 against the
    Pallas kernel."""
    wave = (np.random.default_rng(bins).normal(size=8000) * 1000
            ).astype(np.float32)
    want = np.asarray(fbank_pallas(jnp.asarray(wave),
                                   _opts(JF, 16000, bins, pow2=False)))
    opts = _opts(F, 16000, bins, pow2=False)
    assert opts.frame_opts.padded_window_size == 400
    got = fb.fbank_reference(torch.as_tensor(wave), opts).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    frames = F.extract_frames(torch.as_tensor(wave), opts.frame_opts)
    out64, e64 = fb.fbank_reference_frames(frames.double(), opts)
    got64 = torch.cat([e64[:, None], out64], dim=1).numpy()
    np.testing.assert_allclose(got64, want, rtol=0, atol=ATOL)
