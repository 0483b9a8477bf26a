"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA GPU and skips elsewhere.  The file
imports no jax (the card's machine has none), so it runs there without
the suite's conftest:

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import contextlib

import numpy as np
import pytest
import torch

from kaldi_cnn_tpu_torch.core.rng import np_rng, torch_generator
from kaldi_cnn_tpu_torch.decode import topk_decoder as TK
from kaldi_cnn_tpu_torch.decode.graph import CompiledGraph
from kaldi_cnn_tpu_torch.features import functional as F
from kaldi_cnn_tpu_torch.lang.arpa import make_unigram_arpa
from kaldi_cnn_tpu_torch.lang.hclg import Lang, make_hclg_from_arpa
from kaldi_cnn_tpu_torch.models.components import Conv2DComponent
from kaldi_cnn_tpu_torch.ops import conv as tc
from kaldi_cnn_tpu_torch.ops import fbank as fb
from kaldi_cnn_tpu_torch.ops import maxpool as mp
from kaldi_cnn_tpu_torch.recipes import synthetic

pytestmark = pytest.mark.cuda

FBANK_ATOL = 1e-3   # log-mel / log energy: two f32 sums in other orders
# (the FFT kernel against the float64 plain version: f32 rounding alone)
CONV_TOL = 2e-4     # rtol = atol, f32 kernel vs plain with the same operands
# wgmma kernel vs the bf16 plain version: max abs error / max|ref| (the
# same bf16 operands, f32 sums in another order), and vs the f32 plain
CONV_BF16_TOL = 1e-3
CONV_BF16_REL = 0.02
# (in_t, in_f, in_c, pool_t, pool_f, pool_c): the bench/recipe conv output
# with the recipe's pool (and the Switchboard recipe's F = 48), pool_c > 1,
# a window of 128 (int32 argmax), and a 1x1x1 window
POOL_SHAPES = [(8, 30, 128, 2, 3, 1), (8, 30, 64, 2, 3, 1),
               (8, 30, 48, 2, 3, 1), (4, 6, 8, 2, 3, 2), (4, 8, 16, 4, 4, 8),
               (3, 5, 7, 1, 1, 1)]
# (in_t, in_f, in_c, filt_t, filt_f, F, pool_t, pool_f); the last has
# K = 105 > 96: two groups of k16 steps chained into one accumulator; the
# Switchboard recipe's F = 48, padded to a 64-filter wgmma
CONV_SHAPES = [(8, 12, 2, 3, 5, 16, 3, 4), (6, 10, 1, 2, 3, 8, 1, 2),
               (11, 36, 3, 4, 7, 64, 2, 3), (11, 36, 3, 4, 7, 40, 1, 1),
               (12, 36, 3, 5, 7, 64, 2, 3), (11, 36, 3, 4, 7, 48, 2, 3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("sr,bins,frames", [
    (8000, 36, 238), (16000, 23, 1001), (16000, 40, 3),
    (16000, 23, 12000)])         # enough frames for 32 frames per block
def test_fbank_kernel_matches_plain(cuda, sr, bins, frames):
    opts = F.FbankOptions()
    opts.frame_opts.samp_freq = float(sr)
    opts.mel_opts.num_bins = bins
    opts.use_energy = True
    fo = opts.frame_opts
    n = (frames - 1) * fo.window_shift + fo.window_size
    wave = torch.as_tensor((np_rng(1, "w").normal(size=n) * 1000)
                           .astype(np.float32), device=cuda)
    before = fb.fbank_frames.launches
    got = fb.fbank(wave, opts, torch_generator(1, "k"))
    want = fb.fbank_reference(wave, opts, torch_generator(1, "k"))
    torch.cuda.synchronize()
    assert fb.fbank_frames.launches == before + 1
    assert got.device.type == "cuda" and got.shape == (frames, bins + 1)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=FBANK_ATOL)


def _conv_case(cuda, shape, rows, seed=2):
    in_t, in_f, in_c, ft, ff, nf = shape
    conv = Conv2DComponent(in_t, in_f, in_c, ft, ff, nf, device=cuda)
    conv.init(torch_generator(seed, "c"))
    x = torch.as_tensor(np_rng(seed, "x").normal(size=(rows, conv.input_dim))
                        .astype(np.float32), device=cuda)
    return conv, x, conv.w.detach(), conv.b.detach()


def _assert_bf16_close(got, want, want32=None):
    """The wgmma kernel against the bf16 plain version: the same rounded
    operands, f32 sums in another order; NaN where the plain has NaN."""
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape
    assert torch.equal(got.isnan(), want.isnan())
    fin = torch.isfinite(want)
    inf = want.isinf()
    assert torch.equal(got[inf], want[inf])
    scale = float(want[fin].abs().max())
    assert float((got[fin] - want[fin]).abs().max()) <= CONV_BF16_TOL * scale
    if want32 is not None:      # rounding to bf16 moves < 2 % of max|ref|
        want32 = want32.cpu()
        assert float((got - want32).abs().max()) < CONV_BF16_REL * float(
            want32.abs().max())


@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("bf16", [False, True])
def test_conv_maxpool_kernel_matches_plain(cuda, shape, bf16):
    pt, pf = shape[6:]
    conv, x, w, b = _conv_case(cuda, shape[:6], 67)
    counter = tc.conv2d_maxpool if bf16 else tc.conv2d_maxpool_f32
    before = counter.launches
    got = tc.conv2d_maxpool(x, w, b, conv, pt, pf, relu=True, bf16=bf16)
    want = tc.conv2d_maxpool_reference(x, w, b, conv, pt, pf, relu=True,
                                       bf16=bf16)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    if bf16:
        _assert_bf16_close(got, want)
    else:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=CONV_TOL, atol=CONV_TOL)


@pytest.mark.parametrize("rows", [1, 63, 512, 3050, 4096])
@pytest.mark.parametrize("nf", [8, 48, 64, 128, 264])
def test_conv_maxpool_wgmma_rows_and_filters(cuda, rows, nf):
    """The recipe's 11x36x3 volumes and 4x7 filters, pool 2x3: ragged row
    tiles, one wgmma of 16, 64 or 128 filters, 48 padded to 64 (the
    Switchboard recipe), and 264 = 3 chunks."""
    conv, x, w, b = _conv_case(cuda, (11, 36, 3, 4, 7, nf), rows)
    before = tc.conv2d_maxpool.launches
    got = tc.conv2d_maxpool(x, w, b, conv, 2, 3)
    want = tc.conv2d_maxpool_reference(x, w, b, conv, 2, 3, bf16=True)
    want32 = tc.conv2d_maxpool_reference(x, w, b, conv, 2, 3, bf16=False)
    torch.cuda.synchronize()
    assert tc.conv2d_maxpool.launches == before + 1
    _assert_bf16_close(got, want, want32)


@pytest.mark.parametrize("shape", [(12, 36, 3, 5, 7, 128),
                                   (12, 36, 5, 5, 7, 64)])
def test_conv_maxpool_wgmma_chained_k_groups(cuda, shape):
    """K = 105 and 175 take twelve k16 steps: each conv position's
    products are two commit groups chained into one accumulator, and the
    max waits for the second.  3050 rows give blocks several items."""
    conv, x, w, b = _conv_case(cuda, shape, 3050, seed=5)
    before = tc.conv2d_maxpool.launches
    got = tc.conv2d_maxpool(x, w, b, conv, 2, 3, relu=True)
    want = tc.conv2d_maxpool_reference(x, w, b, conv, 2, 3, relu=True,
                                       bf16=True)
    want32 = tc.conv2d_maxpool_reference(x, w, b, conv, 2, 3, relu=True,
                                         bf16=False)
    torch.cuda.synchronize()
    assert tc.conv2d_maxpool.launches == before + 1
    _assert_bf16_close(got, want, want32)


@pytest.mark.parametrize("pool", [(1, 1), (2, 3), (1, 2)])
@pytest.mark.parametrize("relu", [False, True])
def test_conv_maxpool_wgmma_pools(cuda, pool, relu):
    conv, x, w, b = _conv_case(cuda, (11, 36, 3, 4, 7, 64), 3050, seed=4)
    got = tc.conv2d_maxpool(x, w, b, conv, *pool, relu=relu)
    want = tc.conv2d_maxpool_reference(x, w, b, conv, *pool, relu=relu,
                                       bf16=True)
    torch.cuda.synchronize()
    _assert_bf16_close(got, want)


def test_conv_maxpool_wgmma_inf_and_nan_rows(cuda):
    """Rows holding inf and NaN give what the bf16 plain version gives,
    NaN for NaN: the padded k of A are zeros, not neighbouring inputs."""
    conv, x, w, b = _conv_case(cuda, (11, 36, 3, 4, 7, 64), 130)
    x[3, 7] = float("inf")
    x[5, 500] = float("-inf")
    x[64, 1000] = float("nan")
    x[100, :] = float("inf")
    x[101, 20] = float("inf")
    x[101, 700] = float("nan")
    for relu in (False, True):
        got = tc.conv2d_maxpool(x, w, b, conv, 2, 3, relu=relu)
        want = tc.conv2d_maxpool_reference(x, w, b, conv, 2, 3, relu=relu,
                                           bf16=True)
        torch.cuda.synchronize()
        assert bool(want.isnan().any()) and bool(want.isinf().any())
        _assert_bf16_close(got, want)


def test_conv_maxpool_wgmma_refuses_tiles_that_do_not_fit(cuda):
    conv, x, w, b = _conv_case(cuda, (11, 36, 3, 4, 7, 1024), 8)
    with pytest.raises(RuntimeError, match="kcnn_conv_maxpool_wgmma"):
        tc.conv2d_maxpool(x, w, b, conv, 2, 3)


def test_kernel_wrappers_raise_on_what_they_do_not_take(cuda):
    conv = Conv2DComponent(6, 10, 1, 2, 3, 12, device=cuda)
    x = torch.zeros(4, 60, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        tc.conv2d_maxpool(x, conv.w, conv.b, conv, 1, 2)
    conv = Conv2DComponent(6, 10, 1, 2, 3, 8, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        tc.conv2d_maxpool(x.double(), conv.w.double(), conv.b.double(),
                          conv, 1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tc.conv2d_maxpool(torch.zeros(60, 4, device=cuda).T, conv.w,
                          conv.b, conv, 1, 2)
    opts = F.FbankOptions()
    frames = torch.zeros(5, 399, device=cuda)
    with pytest.raises(ValueError, match="shape"):
        fb.fbank_frames(frames, opts)


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-for-bit equal values, NaN matching NaN."""
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        ((a == b) | (a.isnan() & b.isnan())).all())


@pytest.mark.parametrize("shape", POOL_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 67])
def test_maxpool_kernels_match_plain(cuda, shape, dtype, rows):
    pool = mp.Pool3D(*shape)
    rng = np_rng(3, "pool")
    in_dim = shape[0] * shape[1] * shape[2]
    x = torch.as_tensor(rng.normal(size=(rows, in_dim)).astype(np.float32),
                        device=cuda).to(dtype)
    x[0, 5] = float("nan")                   # one window pools to NaN
    counter = (mp.maxpool3d if mp.forward_kernel(pool, dtype, x.data_ptr())
               == "vector" else mp.maxpool3d_scalar)
    bwd = _backward_counter(pool, dtype)
    before = (counter.launches, bwd.launches)
    y = mp.maxpool3d(x, pool)
    y2, arg = mp.maxpool3d(x, pool, with_argmax=True)
    want, want_arg = mp.maxpool3d_reference(x, pool, with_argmax=True)
    d = torch.as_tensor(rng.normal(size=tuple(y.shape)).astype(np.float32),
                        device=cuda).to(dtype)
    dx = mp.maxpool3d_backward(d, arg, pool)
    want_dx = mp.maxpool3d_backward_reference(d, want_arg, pool)
    torch.cuda.synchronize()
    assert (counter.launches, bwd.launches) == (before[0] + 2, before[1] + 1)
    assert _equal(y, want) and _equal(y2, want)
    assert arg.dtype == mp.argmax_dtype(pool) and torch.equal(arg, want_arg)
    assert int(arg.max()) == mp.window(pool)  # the NaN window's argmax
    assert _equal(dx, want_dx)


def _backward_counter(pool, dtype):
    """The wrapper whose count a backward on PyTorch-allocated (aligned)
    tensors of this pool and dtype moves."""
    return (mp.maxpool3d_backward
            if mp.backward_kernel(pool, dtype) == "vector"
            else mp.maxpool3d_backward_scalar)


def test_maxpool_autograd_runs_the_kernels(cuda):
    pool = mp.Pool3D(4, 6, 8, 2, 3, 2)        # pool_c = 2: the scalar ones
    x = torch.randn(9, 192, device=cuda, requires_grad=True)
    bwd = _backward_counter(pool, x.dtype)
    before = bwd.launches
    y = mp.MaxPool3D.apply(x, pool)
    (g,) = torch.autograd.grad((y * y).sum(), x)
    xr = x.detach().cpu().requires_grad_()
    (gr,) = torch.autograd.grad(
        (mp.MaxPool3D.apply(xr, pool) ** 2).sum(), xr)
    assert bwd.launches == before + 1
    assert torch.equal(g.cpu(), gr)


def test_maxpool_wrappers_raise_on_what_they_do_not_take(cuda):
    pool = mp.Pool3D(4, 6, 8, 2, 3, 2)
    x = torch.zeros(4, 192, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        mp.maxpool3d(x.double(), pool)
    with pytest.raises(ValueError, match="shape"):
        mp.maxpool3d(x[:, :96], pool)
    with pytest.raises(ValueError, match="contiguous"):
        mp.maxpool3d(torch.zeros(192, 4, device=cuda).T, pool)
    with pytest.raises(ValueError, match="divide"):
        mp.maxpool3d(x, mp.Pool3D(4, 6, 8, 3, 3, 2))
    y, arg = mp.maxpool3d(x, pool, with_argmax=True)
    with pytest.raises(TypeError, match="dtype"):
        mp.maxpool3d_backward(y, arg.int(), pool)
    with pytest.raises(ValueError, match="shape"):
        mp.maxpool3d_backward(y[:2], arg, pool)
    with pytest.raises(ValueError, match="devices"):
        mp.maxpool3d_backward(y, arg.cpu(), pool)


def _fbank_frames(cuda, sr, frames, dither, bins=None, pow2=True):
    opts = F.FbankOptions()
    fo = opts.frame_opts
    fo.samp_freq = float(sr)
    fo.dither = float(dither)
    fo.round_to_power_of_two = pow2
    opts.mel_opts.num_bins = bins or (36 if sr == 8000 else 23)
    n = (frames - 1) * fo.window_shift + fo.window_size
    wave = torch.as_tensor((np_rng(sr, "fft").normal(size=n) * 1000)
                           .astype(np.float32), device=cuda)
    x = F.add_dither(F.extract_frames(wave, fo), fo,
                     torch_generator(frames, "fft")).contiguous()
    return x, opts


@pytest.mark.parametrize("sr", [8000, 16000])
@pytest.mark.parametrize("frames", [1, 7, 238, 12000])
@pytest.mark.parametrize("dither", [0, 1])
def test_fbank_fft_kernel_matches_float64_plain(cuda, sr, frames, dither):
    """The FFT kernel (ws 200 -> N 256, ws 400 -> N 512) against the plain
    version in float64 with float64 DFT tables."""
    x, opts = _fbank_frames(cuda, sr, frames, dither)
    assert fb.fbank_kernel(opts.frame_opts) == "fft"
    before = (fb.fbank_frames.launches, fb.fbank_frames_table.launches)
    out, energy = fb.fbank_frames(x, opts)
    ref, ref_e = fb.fbank_reference_frames(x.double(), opts)
    torch.cuda.synchronize()
    assert (fb.fbank_frames.launches, fb.fbank_frames_table.launches) == (
        before[0] + 1, before[1])
    assert out.shape == (frames, opts.mel_opts.num_bins)
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=0,
                               atol=FBANK_ATOL)
    np.testing.assert_allclose(energy.cpu().numpy(), ref_e.cpu().numpy(),
                               rtol=0, atol=FBANK_ATOL)


@pytest.mark.parametrize("sr", [8000, 16000])
@pytest.mark.parametrize("dither", [0, 1])
def test_mfcc_on_card_matches_plain_on_cpu(cuda, sr, dither):
    """ops.fbank.mfcc launches the FFT kernel once and agrees with
    mfcc_reference on the CPU on the same noise: cepstrum c within 2e-3 x
    its lifter coefficient, the energy column within 1e-3."""
    opts = F.MfccOptions()
    opts.frame_opts.samp_freq = float(sr)
    opts.frame_opts.dither = float(dither)
    wave = (np_rng(9, "mfcc").normal(size=sr) * 1000).astype(np.float32)
    before = fb.fbank_frames.launches
    got = fb.mfcc(torch.as_tensor(wave, device=cuda), opts,
                  torch_generator(9, "mfcc_dither"))
    torch.cuda.synchronize()
    assert fb.fbank_frames.launches == before + 1
    want = fb.mfcc_reference(torch.as_tensor(wave), opts,
                             torch_generator(9, "mfcc_dither"))
    assert got.shape == want.shape == (F.num_frames(sr, opts.frame_opts), 13)
    limit = 2e-3 * F.lifter_coeffs(13, 22.0).astype(np.float64)
    limit[0] = 1e-3
    err = np.abs(got.cpu().double().numpy() - want.double().numpy())
    assert (err.max(axis=0) <= limit).all(), err.max(axis=0)


def _counts():
    return (fb.fbank_frames.launches, fb.fbank_frames_mixed.launches,
            fb.fbank_frames_table.launches)


@pytest.mark.parametrize("sr,bins", [(8000, 36), (16000, 23), (16000, 40)])
def test_fbank_table_kernel_runs_without_power_of_two(cuda, sr, bins):
    """round_to_power_of_two=False (N = ws = 200 or 400) takes the
    mixed-radix kernel now, not the table kernel; the table kernel still
    takes those sizes through fbank_frames_table, and the power-of-two
    ones, moves its own count and matches the plain version."""
    x, opts = _fbank_frames(cuda, sr, 301, 1, bins, pow2=False)
    assert fb.fbank_kernel(opts.frame_opts) == "mixed"
    before = _counts()
    out, energy = fb.fbank_frames_table(x, opts)
    ref, ref_e = fb.fbank_reference_frames(x, opts)
    x2, opts2 = _fbank_frames(cuda, sr, 301, 1, bins)
    out2, _ = fb.fbank_frames_table(x2, opts2)
    ref2, _ = fb.fbank_reference_frames(x2, opts2)
    torch.cuda.synchronize()
    assert _counts() == (before[0], before[1], before[2] + 2)
    for got, want in ((out, ref), (energy, ref_e), (out2, ref2)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=0, atol=FBANK_ATOL)


@pytest.mark.parametrize("sr", [8000, 16000])
@pytest.mark.parametrize("frames", [1, 7, 301])
@pytest.mark.parametrize("dither", [0, 1])
def test_fbank_mixed_kernel_matches_float64_and_f32_plain(cuda, sr, frames,
                                                          dither):
    """round_to_power_of_two=False (N = ws = 200, 400): fbank_frames takes
    the mixed-radix kernel, which moves its own count only and holds to
    the float64 plain version and to the float32 one."""
    x, opts = _fbank_frames(cuda, sr, frames, dither, pow2=False)
    assert fb.fbank_kernel(opts.frame_opts) == "mixed"
    before = _counts()
    out, energy = fb.fbank_frames(x, opts)
    ref64, ref64_e = fb.fbank_reference_frames(x.double(), opts)
    ref, ref_e = fb.fbank_reference_frames(x, opts)
    torch.cuda.synchronize()
    assert _counts() == (before[0], before[1] + 1, before[2])
    assert out.shape == (frames, opts.mel_opts.num_bins)
    assert bool(torch.isfinite(out).all())
    for got, want in ((out, ref64), (energy, ref64_e), (out, ref),
                      (energy, ref_e)):
        np.testing.assert_allclose(got.cpu().double().numpy(),
                                   want.cpu().double().numpy(), rtol=0,
                                   atol=FBANK_ATOL)


@pytest.mark.parametrize("sr", [4000, 32000, 64000])
def test_fbank_mixed_kernel_takes_every_size(cuda, sr):
    """N = 100, 800 and 1600 (2, 16 and 32 lanes a frame) against the
    float64 plain version."""
    x, opts = _fbank_frames(cuda, sr, 301, 1, 23, pow2=False)
    assert opts.frame_opts.padded_window_size == sr // 40
    before = _counts()
    out, energy = fb.fbank_frames(x, opts)
    ref, ref_e = fb.fbank_reference_frames(x.double(), opts)
    torch.cuda.synchronize()
    assert _counts() == (before[0], before[1] + 1, before[2])
    for got, want in ((out, ref), (energy, ref_e)):
        np.testing.assert_allclose(got.cpu().double().numpy(),
                                   want.cpu().numpy(), rtol=0,
                                   atol=FBANK_ATOL)


@pytest.mark.parametrize("sr", [8000, 16000])
@pytest.mark.parametrize("dither", [0, 1])
def test_mfcc_mixed_on_card_matches_plain_on_cpu(cuda, sr, dither):
    """MFCC with round_to_power_of_two=False (N = 200, 400) launches the
    mixed-radix kernel once and holds to mfcc_reference on the CPU by the
    limits of test_mfcc_on_card_matches_plain_on_cpu."""
    opts = F.MfccOptions()
    opts.frame_opts.samp_freq = float(sr)
    opts.frame_opts.dither = float(dither)
    opts.frame_opts.round_to_power_of_two = False
    wave = (np_rng(10, "mfcc").normal(size=sr) * 1000).astype(np.float32)
    before = _counts()
    got = fb.mfcc(torch.as_tensor(wave, device=cuda), opts,
                  torch_generator(10, "mfcc_dither"))
    torch.cuda.synchronize()
    assert _counts() == (before[0], before[1] + 1, before[2])
    want = fb.mfcc_reference(torch.as_tensor(wave), opts,
                             torch_generator(10, "mfcc_dither"))
    assert got.shape == want.shape == (F.num_frames(sr, opts.frame_opts), 13)
    limit = 2e-3 * F.lifter_coeffs(13, 22.0).astype(np.float64)
    limit[0] = 1e-3
    err = np.abs(got.cpu().double().numpy() - want.double().numpy())
    assert (err.max(axis=0) <= limit).all(), err.max(axis=0)


def test_fbank_mixed_kernel_takes_misaligned_frames(cuda):
    """Frames that start 4 bytes into an aligned buffer: the mixed-radix
    kernel reads them with scalar loads and still matches."""
    x, opts = _fbank_frames(cuda, 16000, 50, 1, pow2=False)
    buf = torch.empty(x.numel() + 1, device=cuda)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16 == 4
    before = _counts()
    out, energy = fb.fbank_frames(view, opts)
    ref, ref_e = fb.fbank_reference_frames(x.double(), opts)
    torch.cuda.synchronize()
    assert _counts() == (before[0], before[1] + 1, before[2])
    for got, want in ((out, ref), (energy, ref_e)):
        np.testing.assert_allclose(got.cpu().double().numpy(),
                                   want.cpu().numpy(), rtol=0,
                                   atol=FBANK_ATOL)


def test_fbank_mixed_kernel_refuses_other_sizes(cuda):
    """The C entry point checks N itself and raises through the wrapper's
    launch check; it never falls back."""
    x, opts = _fbank_frames(cuda, 8000, 5, 0)             # N 256
    with pytest.raises(RuntimeError, match="kcnn_fbank_fft_mixed"):
        fb.fbank_frames_mixed(x, opts)


def test_fbank_fft_kernel_takes_misaligned_frames(cuda):
    """Frames that start 4 bytes into an aligned buffer: the FFT kernel
    reads them with scalar loads and still matches."""
    x, opts = _fbank_frames(cuda, 8000, 50, 1)
    buf = torch.empty(x.numel() + 1, device=cuda)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16 == 4
    out, energy = fb.fbank_frames(view, opts)
    ref, ref_e = fb.fbank_reference_frames(x.double(), opts)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=0,
                               atol=FBANK_ATOL)
    np.testing.assert_allclose(energy.cpu().numpy(), ref_e.cpu().numpy(),
                               rtol=0, atol=FBANK_ATOL)


def _hard_rows(rows, pool, dtype, cuda, seed=11):
    """Rows rounded to few values (ties), with one window all -inf (row 0's
    first), then +-inf and NaN spread over all rows."""
    x = np.round(np_rng(seed, "hard").normal(
        size=(rows, pool.in_t, pool.in_f, pool.in_c)) * 2).astype(np.float32)
    x[0, :pool.pool_t, :pool.pool_f, :] = -np.inf
    x = x.reshape(rows, -1)
    r = np_rng(seed, "where")
    for val in (np.inf, -np.inf, np.nan):
        x.flat[r.integers(0, x.size, max(1, x.size // 500))] = val
    return torch.as_tensor(x, device=cuda).to(dtype)


@pytest.mark.parametrize("rows", [1, 67, 256, 4096])
@pytest.mark.parametrize("nf", [48, 64, 128])
@pytest.mark.parametrize("pool", [(2, 3), (1, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_maxpool_vector_forward_bit_equal(cuda, rows, nf, pool, dtype):
    """The vectorised forward on the recipe's 8x30xF conv output, with
    and without the argmax, bit-equal to the plain version and to the
    scalar kernel on rows holding ties, +-inf and NaN."""
    p = mp.Pool3D(8, 30, nf, *pool, 1)
    x = _hard_rows(rows, p, dtype, cuda)
    assert mp.forward_kernel(p, dtype, x.data_ptr()) == "vector"
    before = (mp.maxpool3d.launches, mp.maxpool3d_scalar.launches)
    y = mp.maxpool3d(x, p)
    y2, arg = mp.maxpool3d(x, p, with_argmax=True)
    assert (mp.maxpool3d.launches, mp.maxpool3d_scalar.launches) == (
        before[0] + 2, before[1])
    ys, args = mp.maxpool3d_scalar(x, p, with_argmax=True)
    want, want_arg = mp.maxpool3d_reference(x, p, with_argmax=True)
    torch.cuda.synchronize()
    assert want.isnan().any() and want.isinf().any()
    assert _equal(y, want) and _equal(y2, want) and _equal(ys, want)
    assert arg.dtype == torch.int8
    assert torch.equal(arg, want_arg) and torch.equal(args, want_arg)
    assert int(arg.max()) == mp.window(p)    # a NaN window


def test_maxpool_vector_forward_int32_argmax(cuda):
    """A 16x8 window (int32 argmax) on the vector path: the argmax leaves
    as 16-byte stores."""
    for dtype in (torch.float32, torch.bfloat16):
        p = mp.Pool3D(16, 8, 16, 16, 8, 1)
        x = _hard_rows(33, p, dtype, cuda, seed=12)
        assert mp.forward_kernel(p, dtype, x.data_ptr()) == "vector"
        y, arg = mp.maxpool3d(x, p, with_argmax=True)
        want, want_arg = mp.maxpool3d_reference(x, p, with_argmax=True)
        torch.cuda.synchronize()
        assert arg.dtype == torch.int32 and torch.equal(arg, want_arg)
        assert _equal(y, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_maxpool_misaligned_view_takes_the_scalar_kernel(cuda, dtype):
    p = mp.Pool3D(8, 30, 64, 2, 3, 1)
    x = _hard_rows(67, p, dtype, cuda)
    buf = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    assert mp.forward_kernel(p, dtype, view.data_ptr()) == "scalar"
    before = (mp.maxpool3d.launches, mp.maxpool3d_scalar.launches)
    y, arg = mp.maxpool3d(view, p, with_argmax=True)
    want, want_arg = mp.maxpool3d_reference(x, p, with_argmax=True)
    torch.cuda.synchronize()
    assert (mp.maxpool3d.launches, mp.maxpool3d_scalar.launches) == (
        before[0], before[1] + 1)
    assert _equal(y, want) and torch.equal(arg, want_arg)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _routed_derivative(shape, rows, dtype, cuda, seed=13):
    """The recipe-like case for the backward: rows with ties, +-inf and NaN
    windows (an argmax of no index), and a derivative holding -0.0 and
    NaNs with payloads."""
    p = mp.Pool3D(*shape)
    x = _hard_rows(rows, p, dtype, cuda, seed=seed)
    _, arg = mp.maxpool3d_reference(x, p, with_argmax=True)
    d = torch.as_tensor(np_rng(seed, "d").normal(size=tuple(arg.shape))
                        .astype(np.float32), device=cuda).to(dtype)
    bits = _bits(d).view(-1)
    r = np_rng(seed, "special")
    specials = ([-2**31, 0x7fc12345, -0x3ff544] if dtype == torch.float32
                else [-2**15, 0x7fc1, -0x3d])   # -0.0, NaN with payloads
    for val in specials:
        bits[torch.as_tensor(r.integers(0, bits.numel(),
                                        max(1, bits.numel() // 50)))] = val
    return p, x, arg, d


@pytest.mark.parametrize("shape", POOL_SHAPES + [(16, 8, 16, 16, 8, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 67])
def test_maxpool_vector_backward_bit_equal(cuda, shape, dtype, rows):
    """The backward the wrapper picks (vector on the recipe's shapes and on
    a 16x8 window's int32 argmax, scalar elsewhere) and the scalar one, bit
    for bit equal to the plain version: the derivative's own bits at the
    argmax, -0.0 and NaN payloads included, +0.0 elsewhere and all over a
    NaN window."""
    p, x, arg, d = _routed_derivative(shape, rows, dtype, cuda)
    kind = mp.backward_kernel(p, dtype, d.data_ptr(), arg.data_ptr())
    assert kind == ("vector" if shape[5] == 1 and shape[2] % (
        16 // dtype.itemsize) == 0 else "scalar")
    counter = (mp.maxpool3d_backward if kind == "vector"
               else mp.maxpool3d_backward_scalar)
    before = (counter.launches, mp.maxpool3d_backward_scalar.launches)
    dx = mp.maxpool3d_backward(d, arg, p)
    dxs = mp.maxpool3d_backward_scalar(d, arg, p)
    want = mp.maxpool3d_backward_reference(d, arg, p)
    torch.cuda.synchronize()
    if kind == "vector":
        assert (counter.launches, mp.maxpool3d_backward_scalar.launches) \
            == (before[0] + 1, before[1] + 1)
    else:
        assert counter.launches == before[0] + 2
    assert arg.dtype == mp.argmax_dtype(p)
    assert int(arg.max()) == mp.window(p)         # a NaN window
    assert _bits(d).eq(_bits(d.new_tensor(-0.0))).any()
    assert dx.dtype == dtype and dx.shape == want.shape
    assert torch.equal(_bits(dx), _bits(want))
    assert torch.equal(_bits(dxs), _bits(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["out_deriv", "argmax"])
def test_maxpool_misaligned_backward_takes_the_scalar_kernel(cuda, dtype,
                                                             which):
    """A derivative or an argmax that is not 16-byte aligned takes the
    scalar backward, which moves its own count and is bit-equal."""
    p, x, arg, d = _routed_derivative((8, 30, 64, 2, 3, 1), 67, dtype, cuda)
    t = d if which == "out_deriv" else arg
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    dd, aa = (view, arg) if which == "out_deriv" else (d, view)
    assert mp.backward_kernel(p, dtype, dd.data_ptr(),
                              aa.data_ptr()) == "scalar"
    before = (mp.maxpool3d_backward.launches,
              mp.maxpool3d_backward_scalar.launches)
    dx = mp.maxpool3d_backward(dd, aa, p)
    want = mp.maxpool3d_backward_reference(d, arg, p)
    torch.cuda.synchronize()
    assert (mp.maxpool3d_backward.launches,
            mp.maxpool3d_backward_scalar.launches) == (before[0],
                                                       before[1] + 1)
    assert torch.equal(_bits(dx), _bits(want))


def test_vector_backward_refuses_what_it_does_not_take(cuda):
    """The C entry point checks the vector conditions itself (pool_c = 2
    here) and raises through the wrapper's launch check."""
    p = mp.Pool3D(4, 6, 8, 2, 3, 2)            # out_dim 2 x 2 x 4
    d = torch.zeros(4, 16, device=cuda)
    arg = torch.zeros(4, 16, dtype=torch.int8, device=cuda)
    with pytest.raises(RuntimeError, match="kcnn_maxpool_bwd_vec"):
        mp._backward("kcnn_maxpool_bwd_vec", d, arg, p)


def test_vector_kernel_refuses_what_it_does_not_take(cuda):
    """The C entry point checks the vector conditions itself and raises
    through the wrapper's launch check; it never falls back."""
    p = mp.Pool3D(4, 6, 8, 2, 3, 2)
    x = torch.zeros(4, 192, device=cuda)
    with pytest.raises(RuntimeError, match="kcnn_maxpool_fwd_vec"):
        mp._forward("kcnn_maxpool_fwd_vec", x, p, False)


@pytest.mark.parametrize("n,out_len,density", [
    (300, 64, 0.5), (5000, 2048, 0.3), (40000, 2048, 0.01), (200, 256, 1.0)])
def test_compact_on_card_matches_cpu(cuda, n, out_len, density):
    """Lattice record compaction: the same records in the same order and
    the same true counts on the card as on the CPU."""
    rng = np_rng(n, "compact")
    mask = torch.as_tensor(rng.random((16, n)) < density)
    arrays = tuple(torch.as_tensor(rng.integers(-1, 1 << 20, (16, n)))
                   for _ in range(3))
    want = TK.TopKDecoder._compact(mask, arrays, out_len)
    got = TK.TopKDecoder._compact(mask.to(cuda),
                                  tuple(a.to(cuda) for a in arrays), out_len)
    assert got[0].device.type == "cuda"
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def _digits_lattice_case():
    lex = synthetic.digits_lexicon()
    wp = {w: 0.1 for w in lex.entries}
    lang = Lang.create(lex)
    g = CompiledGraph(make_hclg_from_arpa(lang, make_unigram_arpa(wp)),
                      lang.trans_model.trans_id_to_pdf_array())
    P = lang.trans_model.num_pdfs
    rng = np_rng(5, "lattice")
    lls = []
    for T_ in (40, 55, 31, 47):
        ll = rng.normal(size=(T_, P)).astype(np.float32)
        path = np.repeat(rng.integers(0, P, size=T_ // 4 + 1), 4)[:T_]
        ll[np.arange(T_), path] += 6.0
        lls.append(ll)
    return g, lls


@pytest.mark.parametrize("determinize", [False, True])
def test_decode_batch_lattice_on_card_matches_cpu(cuda, determinize):
    """K covers every state: the card's lattices equal the CPU's arc for
    arc (costs within 1e-5), and the search stays on the card."""
    g, lls = _digits_lattice_case()
    kw = dict(beam=14.0, max_active=g.num_states + 32, acoustic_scale=0.1,
              lattice_beam=7.0, lattice_arcs_per_frame=None)
    dec = TK.TopKDecoder(g, device=cuda, **kw)
    assert all(v.device.type == "cuda" for v in dec.d.values()
               if isinstance(v, torch.Tensor))
    got = dec.decode_batch_lattice(lls, determinize=determinize)
    want = TK.TopKDecoder(g, device="cpu", **kw).decode_batch_lattice(
        lls, determinize=determinize)
    assert dec.last_overflow == (0, 0)
    for a, b in zip(got, want):
        assert a.num_arcs > 0
        assert (a.num_states, a.start) == (b.num_states, b.start)
        for k in ("state_time", "arc_src", "arc_dst", "arc_ilabel",
                  "arc_olabel"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        for k in ("arc_graph", "arc_acoustic", "final_graph"):
            np.testing.assert_allclose(getattr(a, k), getattr(b, k),
                                       rtol=0, atol=1e-5)


def test_decode_utterances_on_card_matches_cpu(cuda):
    """Buckets, a padded last batch and overflow counts on the card."""
    g, lls = _digits_lattice_case()
    keyed = {f"u{i}": ll for i, ll in enumerate(lls)}
    kw = dict(beam=14.0, max_active=g.num_states + 32, lattice_beam=7.0,
              lattice_arcs_per_frame=256, batch_size=3, bucket_frames=32)
    got = TK.decode_utterances(g, keyed, device=cuda, **kw)
    want = TK.decode_utterances(g, keyed, device="cpu", **kw)
    assert sorted(got) == sorted(want) == sorted(keyed)
    for u in keyed:
        for k in ("arc_src", "arc_dst", "arc_olabel"):
            np.testing.assert_array_equal(getattr(got[u], k),
                                          getattr(want[u], k))


def _count_eager(monkeypatch):
    """Records each call of the batch search's eager frame loop and
    eager backtrace walk (the captured search must make none)."""
    calls = []
    for name in ("_run_frames_eager", "_bt_walk_eager"):
        fn = getattr(TK.TopKDecoder, name)

        def run(self, *a, fn=fn, name=name):
            calls.append(name)
            return fn(self, *a)
        monkeypatch.setattr(TK.TopKDecoder, name, run)
    return calls


def _eager_search(monkeypatch):
    """The batch search through its private eager methods on the card."""
    monkeypatch.setattr(TK.TopKDecoder, "_run_frames",
                        lambda self, *a: self._run_frames_eager(*a))
    monkeypatch.setattr(TK.TopKDecoder, "_bt_walk",
                        lambda self, *a: self._bt_walk_eager(*a))


def _host_best_paths(dec, lls, device):
    """The host ``_best_path`` on the fetched best-path histories."""
    am, lengths = dec._pad(lls)
    lv = dec._decode(torch.as_tensor(am, device=device))["lv"].cpu().numpy()
    r = {k: lv[:, i].transpose(1, 0, 2)
         for i, k in enumerate(("fs", "fc", "bp_arc", "bp_prev"))}
    r["fc"] = r["fc"].view(np.float32)
    return [dec._best_path(r, am, int(n), b) for b, n in enumerate(lengths)]


def _same_paths(a, b):
    return all(list(ta) == list(tb) and list(wa) == list(wb)
               and np.float32(ca).view(np.int32) == np.float32(cb).view(
                   np.int32) for (ta, wa, ca), (tb, wb, cb) in zip(a, b))


def _same_lattices(a, b):
    return all(
        (x.num_states, x.start) == (y.num_states, y.start)
        and all(np.array_equal(getattr(x, k), getattr(y, k))
                for k in ("state_time", "arc_src", "arc_dst", "arc_ilabel",
                          "arc_olabel", "arc_graph", "arc_acoustic",
                          "final_graph"))
        for x, y in zip(a, b, strict=True))


def test_search_graphs_match_the_eager_search_on_card(cuda, monkeypatch):
    """decode_batch and decode_batch_lattice on the card run their frame
    loops and the backtrace only as replays of captured graphs (no eager
    call), at K = 64 over four utterances of 31-55 frames: the same best
    paths (tids, words, cost bits) and lattices arc for arc as the same
    decoder's eager search on the card; the device backtrace equals the
    host ``_best_path`` on the fetched histories."""
    g, lls = _digits_lattice_case()
    dec = TK.TopKDecoder(g, beam=14.0, max_active=64, acoustic_scale=0.1,
                         lattice_beam=7.0, lattice_arcs_per_frame=None,
                         device=cuda)
    eager = _count_eager(monkeypatch)
    paths = dec.decode_batch(lls)
    lats = dec.decode_batch_lattice(lls, determinize=False)
    assert eager == [] and dec.last_overflow == (0, 0)
    kinds = {(k[0], k[1]) if k[0] == "frames" else k[0]
             for k in dec.capture_seconds}
    assert kinds == {("frames", False), ("frames", True), "backtrace"}
    assert _same_paths(paths, _host_best_paths(dec, lls, cuda))
    _eager_search(monkeypatch)
    assert _same_paths(paths, dec.decode_batch(lls))
    assert _same_lattices(lats, dec.decode_batch_lattice(
        lls, determinize=False))
    assert set(eager) == {"_run_frames_eager", "_bt_walk_eager"}


def test_lattice_graphs_recaptured_after_auto_grow(cuda):
    """A record capacity of 8 overflows: auto-grow doubles it and the
    lattice blocks are captured again at each new capacity (only the
    last one's graphs remain); the lattices equal the CPU's arc for arc
    (costs within 1e-5) with the same final capacity."""
    g, lls = _digits_lattice_case()
    kw = dict(beam=14.0, max_active=64, acoustic_scale=0.1,
              lattice_beam=7.0, lattice_arcs_per_frame=8)
    dec = TK.TopKDecoder(g, device=cuda, **kw)
    cpu = TK.TopKDecoder(g, device="cpu", **kw)
    got = dec.decode_batch_lattice(lls, determinize=False, max_grow=6)
    want = cpu.decode_batch_lattice(lls, determinize=False, max_grow=6)
    assert dec.A_lat == cpu.A_lat > 8
    assert dec.last_overflow == cpu.last_overflow == (0, 0)
    caps = {k[4] for k in dec.capture_seconds if k[0] == "frames"}
    assert caps == {dec.A_lat}
    for a, b in zip(got, want):
        for k in ("state_time", "arc_src", "arc_dst", "arc_olabel"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        np.testing.assert_allclose(a.arc_acoustic, b.arc_acoustic,
                                   rtol=0, atol=1e-5)


def test_a_failed_capture_raises_and_does_not_fall_back(cuda, tmp_path):
    """A host sync inside the frame (as ``.item()`` would be) breaks the
    capture: decode_batch raises and the eager loop never runs (in a
    process of its own, so that the broken capture cannot touch the
    other tests)."""
    import os
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    code = (
        "import test_torch_cuda as t\n"
        "from kaldi_cnn_tpu_torch.decode import topk_decoder as TK\n"
        "g, lls = t._digits_lattice_case()\n"
        "frame = TK.TopKDecoder._frame\n"
        "def synced(self, fs, fc, *a, **k):\n"
        "    float(fc.sum())\n"
        "    return frame(self, fs, fc, *a, **k)\n"
        "TK.TopKDecoder._frame = synced\n"
        "eager = []\n"
        "TK.TopKDecoder._run_frames_eager = lambda *a: eager.append(1)\n"
        "dec = TK.TopKDecoder(g, max_active=64, device='cuda')\n"
        "try:\n"
        "    dec.decode_batch(lls)\n"
        "except RuntimeError as e:\n"
        "    print('raised', not eager)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(here), here]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path, env=env)
    assert "raised True" in out.stdout, out.stdout + out.stderr


# ---------------------------------------------------------------- streaming

@pytest.mark.parametrize("kind,bins", [("fbank", 36), ("mfcc", 23)])
@pytest.mark.parametrize("frames", list(range(1, 21)))
def test_fbank_and_mfcc_at_streaming_piece_lengths(cuda, kind, bins, frames):
    """An online piece can be one frame long: the kernel at T = 1..20
    (8 kHz, N = 256) against the plain version on the CPU."""
    if kind == "mfcc":
        opts = F.MfccOptions()
    else:
        opts = F.FbankOptions()
    opts.frame_opts.samp_freq = 8000.0
    opts.mel_opts.num_bins = bins
    fo = opts.frame_opts
    n = (frames - 1) * fo.window_shift + fo.window_size
    wave = (np_rng(frames, "piece").normal(size=n) * 1000).astype(np.float32)
    run = fb.mfcc if kind == "mfcc" else fb.fbank
    ref = fb.mfcc_reference if kind == "mfcc" else fb.fbank_reference
    before = fb.fbank_frames.launches
    got = run(torch.as_tensor(wave, device=cuda), opts,
              torch_generator(1, "piece"))
    want = ref(torch.as_tensor(wave), opts, torch_generator(1, "piece"))
    assert fb.fbank_frames.launches == before + 1
    assert got.shape == want.shape and got.shape[0] == frames
    err = (got.cpu().double() - want.double()).abs().amax(dim=0).numpy()
    if kind == "mfcc":
        limit = 2e-3 * F.lifter_coeffs(13, 22.0).astype(float)
        limit[0] = 1e-3
    else:
        limit = np.full(bins, FBANK_ATOL)
    assert (err <= limit).all(), err


@pytest.mark.parametrize("kind,bins,chunk", [
    ("fbank", 36, 1600), ("fbank", 36, 160), ("mfcc", 23, 1600),
    ("mfcc", 23, 333)])
def test_online_base_feature_on_card_matches_plain(cuda, kind, bins, chunk):
    """OnlineBaseFeature on the card (each ready piece through the
    kernel) against the same stream on the CPU (the plain version)."""
    from kaldi_cnn_tpu_torch.online2 import OnlineBaseFeature
    wave = (np_rng(3, "online").normal(size=9000) * 800).astype(np.float32)

    def run(dev):
        opts = F.MfccOptions() if kind == "mfcc" else F.FbankOptions()
        opts.frame_opts.samp_freq = 8000.0
        opts.frame_opts.dither = 0.0
        opts.mel_opts.num_bins = bins
        ob = OnlineBaseFeature(kind, opts, device=dev)
        for i in range(0, len(wave), chunk):
            ob.accept_waveform(wave[i:i + chunk])
        ob.finish()
        return ob.get_frames(0, ob.num_frames_ready())
    before = fb.fbank_frames.launches
    got = run(cuda)
    assert fb.fbank_frames.launches > before
    want = run("cpu")
    assert got.shape == want.shape
    err = np.abs(got.astype(np.float64) - want).max(axis=0)
    if kind == "mfcc":
        limit = 2e-3 * F.lifter_coeffs(13, 22.0).astype(float)
        limit[0] = 1e-3
    else:
        limit = np.full(bins, FBANK_ATOL)
    assert (err <= limit).all(), err


def _stream(stream, ll, chunk):
    stream.reset()
    parts = []
    for i in range(0, ll.shape[0], chunk):
        stream.advance(ll[i:i + chunk])
        parts.append(stream.best_path(use_final=False))
    stream.finalize()
    return parts + [stream.best_path()]


def test_streaming_decoder_on_card_matches_cpu(cuda):
    """Blocks of 16, 4 and 1 frames as CUDA graph replays: the same
    partial and final best paths as the eager frames on the CPU and as
    the card's own decode_batch; each graph is captured once and kept
    across reset()."""
    g, lls = _digits_lattice_case()
    kw = dict(beam=14.0, max_active=g.num_states + 32, acoustic_scale=0.1)
    card = TK.StreamingDecoder(TK.TopKDecoder(g, device=cuda, **kw))
    cpu = TK.StreamingDecoder(TK.TopKDecoder(g, device="cpu", **kw))
    offline = card.dec.decode_batch(lls)
    for n, (ll, off) in enumerate(zip(lls, offline)):
        chunk = (9, 13, 41, 50)[n]
        got, want = _stream(card, ll, chunk), _stream(cpu, ll, chunk)
        for (t, w, c), (jt, jw, jc) in zip(got, want):
            assert list(t) == list(jt) and list(w) == list(jw)
            assert c == pytest.approx(jc, rel=1e-5, abs=1e-4)
        t, w, c = got[-1]
        assert list(t) == list(off[0]) and list(w) == list(off[1])
        assert c == pytest.approx(off[2], rel=1e-5, abs=1e-4)
        if n == 0:
            captured = dict(card.capture_seconds)
    assert set(card.capture_seconds) == {16, 4, 1}
    assert set(captured) == {4, 1}
    assert all(card.capture_seconds[k] == v for k, v in captured.items())


def _swbd_nets(cuda, num_filters=48, ivec=12, num_pdfs=200):
    """The Switchboard CNN + iVector net at the recipe's width on the card
    (seeded weights, the output affine redrawn) and its CPU copy."""
    import copy
    from kaldi_cnn_tpu_torch.models.factory import make_convnet_ivector
    from kaldi_cnn_tpu_torch.recipes import swbd
    net = make_convnet_ivector(swbd.model_config(num_pdfs, num_filters),
                               ivector_dim=ivec, device=cuda)
    gen = torch_generator(5, "swbd")
    net.init(gen)
    with torch.no_grad():
        out = net.components[-2]
        out.w.copy_(torch.randn(out.w.shape, generator=gen) / 160 ** 0.5)
    return net, copy.deepcopy(net).to("cpu")


@pytest.mark.parametrize("rows", [1, 300, 512])
def test_swbd_slice_pair_predict_on_card_matches_cpu(cuda, rows):
    """Nnet.predict fuses the pair of slices into one wgmma conv+maxpool
    launch on the card; the posteriors agree with the plain bf16 version
    of the same path on the CPU, and with the unfused f32 forward."""
    net, cpu = _swbd_nets(cuda)
    x = torch.as_tensor(np_rng(6, "swbd").normal(
        size=(rows, net.input_dim)).astype(np.float32))
    before = (tc.conv2d_maxpool.launches, mp.maxpool3d.launches)
    got = net.predict(x.to(cuda))
    torch.cuda.synchronize()
    assert (tc.conv2d_maxpool.launches, mp.maxpool3d.launches) == (
        before[0] + 1, before[1])
    want = cpu.predict(x)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got.cpu().numpy(), cpu(x).detach().numpy(),
                               rtol=2e-2, atol=2e-3)


def test_swbd_train_step_on_card_runs_the_maxpool_kernels(cuda):
    """A train step of the Switchboard net on the card launches the vector
    maxpool forward and the backward inside SliceParallel(pool, Identity),
    and agrees with the same step on the CPU."""
    net, cpu = _swbd_nets(cuda)
    r = np_rng(7, "swbd train")
    x = torch.as_tensor(r.normal(size=(256, net.input_dim)).astype(
        np.float32))
    y = torch.as_tensor(r.integers(0, 200, 256))
    before = (mp.maxpool3d.launches, mp.maxpool3d_backward.launches,
              mp.maxpool3d_scalar.launches)
    _, objf = net.train_step(net.init_opt(), x.to(cuda), y.to(cuda), 0.05)
    torch.cuda.synchronize()
    assert (mp.maxpool3d.launches, mp.maxpool3d_backward.launches,
            mp.maxpool3d_scalar.launches) == (before[0] + 1, before[1] + 1,
                                              before[2])
    _, objf_c = cpu.train_step(cpu.init_opt(), x, y, 0.05)
    assert float(objf) == pytest.approx(float(objf_c), abs=1e-4)
    for (k, a), (_, b) in zip(net.named_parameters(),
                              cpu.named_parameters()):
        assert float((a.cpu() - b).norm() / b.norm().clamp_min(1e-30)) \
            < 1e-3, k


def test_wsj_discriminative_step_on_card_matches_cpu(cuda):
    """One MMI step (``Nnet.discriminative_step``, a replay of its CUDA
    graph) of the WSJ recipe's CNN (F = 64) on 300 frames on the card:
    the maxpool forward with argmax and the backward launch once each
    beside the graph's warm-up, and objf and parameters agree with the
    same step on the CPU (1e-3, 1e-3 relative)."""
    import copy
    from kaldi_cnn_tpu_torch.models.factory import make_convnet
    from kaldi_cnn_tpu_torch.recipes import wsj
    num_pdfs = 200
    net = make_convnet(wsj.model_config(36, num_pdfs), device=cuda)
    gen = torch_generator(6, "wsj mmi")
    net.init(gen)
    with torch.no_grad():
        out = net.components[-2]
        out.w.copy_(torch.randn(out.w.shape, generator=gen) / 200 ** 0.5)
    cpu = copy.deepcopy(net).to("cpu")
    r = np_rng(7, "wsj mmi")
    n = 300
    x = torch.as_tensor(r.normal(size=(n, net.input_dim)).astype(
        np.float32))
    num = torch.zeros((n, num_pdfs))
    num[torch.arange(n), torch.as_tensor(r.integers(0, num_pdfs, n))] = 1.0
    den = torch.as_tensor(r.dirichlet(np.ones(num_pdfs) * 0.1, size=n)
                          .astype(np.float32))
    def launched():
        return tuple(fn.launches - fn.warmup_launches
                     for fn in (mp.maxpool3d, mp.maxpool3d_backward))

    before = launched()
    _, objf = net.discriminative_step(net.init_opt(), x.to(cuda),
                                      num.to(cuda), den.to(cuda), 0.002)
    torch.cuda.synchronize()
    assert launched() == (before[0] + 1, before[1] + 1)
    _, objf_c = cpu.discriminative_step(cpu.init_opt(), x, num, den, 0.002)
    assert float(objf) == pytest.approx(float(objf_c), abs=1e-3)
    for (k, a), (_, b) in zip(net.named_parameters(),
                              cpu.named_parameters()):
        assert float((a.cpu() - b).norm() / b.norm().clamp_min(1e-30)) \
            < 1e-3, k


# ------------------------------------------------ training as CUDA graphs

@pytest.fixture
def deterministic_cudnn(cuda):
    """cuDNN's deterministic algorithms (its default filter gradient is
    not deterministic), restored after the test."""
    torch.backends.cudnn.deterministic = True
    yield cuda
    torch.backends.cudnn.deterministic = False


def _wsj_net(cuda, num_pdfs=200):
    from kaldi_cnn_tpu_torch.models.factory import make_convnet
    from kaldi_cnn_tpu_torch.recipes import wsj
    net = make_convnet(wsj.model_config(36, num_pdfs), device=cuda)
    gen = torch_generator(6, "wsj train graphs")
    net.init(gen)
    with torch.no_grad():
        out = net.components[-2]
        out.w.copy_(torch.randn(out.w.shape, generator=gen)
                    / out.input_dim ** 0.5)
    return net


def _steps(net, groups, rows=256, seed=8, eager=False, generators=None):
    """Train ``net`` from its fresh NG states over groups of sizes
    ``groups`` on seeded rows (the last rows of each step at weight 0);
    (opt, objfs [sum(groups)], maxpool (fwd vec, bwd) launches of the
    steps, the same launched in graph warm-ups)."""
    r = np_rng(seed, "train graphs")
    n = sum(groups)
    xs = r.normal(size=(n, rows, net.input_dim)).astype(np.float32)
    ys = r.integers(0, net.output_dim, (n, rows)).astype(np.int32)
    ws = np.ones((n, rows), np.float32)
    ws[:, -9:] = 0.0
    fn = net._train_steps_eager if eager else net.train_steps
    def counts():
        return np.array([mp.maxpool3d.launches,
                         mp.maxpool3d_backward.launches,
                         mp.maxpool3d.warmup_launches,
                         mp.maxpool3d_backward.warmup_launches])

    before = counts()
    opt, objfs, i = net.init_opt(), [], 0
    for k in groups:
        gens = None if generators is None else generators[i:i + k]
        opt, o = fn(opt, xs[i:i + k], ys[i:i + k],
                    0.08 * 0.97 ** np.arange(i, i + k), weights=ws[i:i + k],
                    generators=gens)
        objfs.append(o)
        i += k
    torch.cuda.synchronize()
    n = counts() - before
    return (opt, torch.cat(objfs), tuple(int(v) for v in n[:2] - n[2:]),
            tuple(int(v) for v in n[2:]))


def _same_training(a, b, opt_a, opt_b, objf_a, objf_b):
    from kaldi_cnn_tpu_torch.models.step_graphs import ng_states
    assert torch.equal(objf_a, objf_b)
    for (k, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), k
    for (_, x), (_, y) in zip(ng_states(opt_a), ng_states(opt_b)):
        assert x.t == y.t
        assert (torch.equal(x.u, y.u) and torch.equal(x.d, y.d)
                and torch.equal(x.rho, y.rho))


def test_train_steps_graphs_match_eager_bit_for_bit(deterministic_cudnn):
    """The WSJ CNN (F = 64) at the recipe's 256 rows: 8 groups of 8 in the
    NG warm-up (every step cut around its 8 eighs), a group of 8 that
    refreshes at its first step only (t = 64), and two one-step groups
    without a refresh, through the graphs and through the eager loop
    under deterministic cuDNN: objfs, parameters and NG states equal bit
    for bit, the maxpool launches equal (one forward and one backward a
    step), and every graph captured once."""
    import copy
    net = _wsj_net(deterministic_cudnn)
    ref = copy.deepcopy(net)
    groups = [8] * 9 + [1, 1]
    opt_g, objf_g, n_g, w_g = _steps(net, groups)
    opt_e, objf_e, n_e, w_e = _steps(ref, groups, eager=True)
    _same_training(net, ref, opt_g, opt_e, objf_g, objf_e)
    assert n_g == n_e == (74, 74)
    assert w_e == (0, 0) and w_g[0] == w_g[1] > 0
    # a graph a (K, slot, refresh) and one tail: the warm-up groups
    # capture the 8 refreshing slots, the group at t = 64 reuses slot
    # 0's and captures 1-7 without a refresh, then one one-step graph
    assert set(net.capture_seconds) == (
        {("step", 8, 256, k, True) for k in range(8)}
        | {("step", 8, 256, k, False) for k in range(1, 8)}
        | {("step", 1, 256, 0, False), ("tail", 256)})


def test_discriminative_step_graphs_match_eager_bit_for_bit(
        deterministic_cudnn):
    """``Nnet.discriminative_step`` on the WSJ CNN through its graphs, and
    ``discriminative_step_eager`` on a copy, under deterministic cuDNN at
    MMI's update period 4 from t = 62 (gates open in the NG warm-up, at
    t = 64 and 68, closed between): 6 utterances of 120 and 88 frames in
    turn, then a 120-frame one on new inputs, which replays a graph
    captured before.  Objfs, parameters and NG states equal bit for bit,
    and the step graphs are one a distinct (length, gates) key."""
    import copy
    from kaldi_cnn_tpu_torch.models.step_graphs import ng_states, with_states
    net = _wsj_net(deterministic_cudnn)
    ref = copy.deepcopy(net)
    for ng in (net.ng_in, net.ng_out, ref.ng_in, ref.ng_out):
        ng.update_period = 4
    r = np_rng(9, "discriminative graphs")
    P = net.output_dim
    start = lambda n: with_states(n.init_opt(), [
        s._replace(t=62) for _, s in ng_states(n.init_opt())])
    opt, opt_e = start(net), start(ref)
    keys, captured = set(), 0
    for i, T in enumerate((120, 88, 120, 88, 120, 88, 120)):
        x = r.normal(size=(T, net.input_dim)).astype(np.float32)
        num = np.eye(P, dtype=np.float32)[r.integers(0, P, T)]
        den = r.random((T, P)).astype(np.float32)
        den /= den.sum(axis=1, keepdims=True)
        keys.add((T, net.ng_in._update_now(62 + i)))
        captured = len(net.capture_seconds)
        opt, objf = net.discriminative_step(opt, x, num, den, 0.002)
        opt_e, objf_e = ref.discriminative_step_eager(
            opt_e, torch.as_tensor(x, device=deterministic_cudnn),
            torch.as_tensor(num, device=deterministic_cudnn),
            torch.as_tensor(den, device=deterministic_cudnn), 0.002)
        assert torch.equal(objf, objf_e), i
    torch.cuda.synchronize()
    _same_training(net, ref, opt, opt_e, objf, objf_e)
    assert len(net.capture_seconds) == captured      # the last: a replay
    assert {k for k in net.capture_seconds if k[0] == "disc"} == {
        ("disc", T, g) for T, g in keys}
    assert {k for k in net.capture_seconds if k[0] == "tail"} == {
        ("tail", 120), ("tail", 88)}


def test_train_steps_on_card_launch_the_maxpool_kernels_as_eager(
        deterministic_cudnn):
    """The Switchboard net (the pool inside SliceParallel(pool, Identity))
    through the graphs: each replayed group adds one vector forward and
    one backward launch a step to the counts, as the eager loop launches,
    none of the scalar forward, and the training is the eager one bit for
    bit; a copy of the net leaves the graphs behind and captures its
    own."""
    import copy
    net, _ = _swbd_nets(deterministic_cudnn)
    ref = copy.deepcopy(net)
    scalar = mp.maxpool3d_scalar.launches
    opt_g, objf_g, n_g, w_g = _steps(net, [4, 4, 1], rows=128)
    opt_e, objf_e, n_e, w_e = _steps(ref, [4, 4, 1], rows=128, eager=True)
    assert n_g == n_e == (9, 9)
    assert w_e == (0, 0) and w_g[0] == w_g[1] > 0
    assert mp.maxpool3d_scalar.launches == scalar
    _same_training(net, ref, opt_g, opt_e, objf_g, objf_e)
    assert net._step_graphs is not None
    twin = copy.deepcopy(net)
    assert twin._step_graphs is None
    _, objf_t, _, _ = _steps(twin, [4], rows=128)
    _, objf_n, _, _ = _steps(net, [4], rows=128)
    assert torch.equal(objf_t, objf_n)


def test_train_steps_dropout_on_card_replays_the_eager_masks(cuda):
    """A net with Dropout: each step's generator state goes into the
    graphs' registered generators before a replay, so the graphed group
    draws the eager steps' masks: objfs and parameters equal bit for
    bit, and the callers' generators end where the eager steps leave
    theirs."""
    import copy
    from kaldi_cnn_tpu_torch.models import components as C
    from kaldi_cnn_tpu_torch.models.nnet import Nnet
    net = Nnet([C.AffineComponent(40, 256, device=cuda),
                C.RectifiedLinearComponent(256), C.DropoutComponent(256, 0.3),
                C.AffineComponent(256, 50, device=cuda),
                C.SoftmaxComponent(50)])
    net.init(torch_generator(2, "dropout graphs"))
    ref = copy.deepcopy(net)
    gens = [torch_generator(9, "train_step", i, cuda) for i in range(9)]
    gens_e = [torch_generator(9, "train_step", i, cuda) for i in range(9)]
    opt_g, objf_g, _, _ = _steps(net, [4, 4, 1], rows=128, generators=gens)
    opt_e, objf_e, _, _ = _steps(ref, [4, 4, 1], rows=128, eager=True,
                                 generators=gens_e)
    _same_training(net, ref, opt_g, opt_e, objf_g, objf_e)
    assert all(torch.equal(a.get_state(), b.get_state())
               for a, b in zip(gens, gens_e))


def test_train_steps_on_card_hands_back_states_a_later_group_leaves_alone(
        deterministic_cudnn):
    """The NG states that a graphed group returns are the caller's: a
    later group changes none of their tensors, and a group run again
    from an earlier ``opt`` (a retry) gives that group's first result
    bit for bit, as on the CPU."""
    from kaldi_cnn_tpu_torch.models.step_graphs import ng_states
    net = _wsj_net(deterministic_cudnn)
    r = np_rng(5, "train graphs again")
    xs = r.normal(size=(3, 4, 128, net.input_dim)).astype(np.float32)
    ys = r.integers(0, net.output_dim, (3, 4, 128)).astype(np.int32)
    lrs = np.full(4, 0.05, np.float32)
    opt1, _ = net.train_steps(net.init_opt(), xs[0], ys[0], lrs)
    kept = [x.clone() for _, s in ng_states(opt1) for x in s[:3]]
    params = [p.detach().clone() for p in net.parameters()]
    opt2, objf2 = net.train_steps(opt1, xs[1], ys[1], lrs)
    net.train_steps(opt2, xs[2], ys[2], lrs)
    assert all(torch.equal(a, b) for a, b in zip(
        kept, [x for _, s in ng_states(opt1) for x in s[:3]]))
    with torch.no_grad():
        for p, v in zip(net.parameters(), params):
            p.copy_(v)
    opt2b, objf2b = net.train_steps(opt1, xs[1], ys[1], lrs)
    assert torch.equal(objf2, objf2b)
    for (_, a), (_, b) in zip(ng_states(opt2), ng_states(opt2b)):
        assert a.t == b.t and torch.equal(a.u, b.u) and \
            torch.equal(a.d, b.d) and torch.equal(a.rho, b.rho)


def test_eigh_breaks_a_capture_so_refreshes_run_between_graphs(cuda,
                                                              tmp_path):
    """torch.linalg.eigh checks its result on the host, so a CUDA graph
    cannot hold it: its capture fails (in a process of its own).  This is
    why a refreshing train step is cut around its eighs; if a torch
    version captures eigh, the cut can go."""
    import subprocess
    import sys
    code = (
        "import torch\n"
        "a = torch.eye(40, dtype=torch.float64, device='cuda') * 2\n"
        "torch.linalg.eigh(a)\n"
        "g = torch.cuda.CUDAGraph()\n"
        "try:\n"
        "    with torch.cuda.graph(g):\n"
        "        torch.linalg.eigh(a)\n"
        "    print('captured')\n"
        "except RuntimeError as e:\n"
        "    print('raised', type(e).__name__)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert "raised" in out.stdout, out.stdout + out.stderr


def test_a_collection_during_a_capture_destroys_no_graph(cuda):
    """An old graph left in a reference cycle is not destroyed inside a
    later capture, however much the captured code allocates: the
    collector is held off during a capture (destroying a graph is a call
    that a capture forbids, and it broke a capture in the full card
    suite, where earlier tests' nets and their graphs are such cycles)."""
    import gc
    from kaldi_cnn_tpu_torch.core import graphs
    pool = torch.cuda.graph_pool_handle()
    x = torch.zeros(4, device=cuda)
    old = graphs.capture_only(lambda: x.add_(1), cuda, pool)
    old.replay()
    cycle = [old]
    cycle.append(cycle)
    del old, cycle                  # garbage only a collection frees
    kept = []

    def body():
        kept.extend([] for _ in range(50000))   # many collections' worth
        x.add_(1)

    graph = graphs.capture_only(body, cuda, pool)
    graph.replay()
    torch.cuda.synchronize()
    assert x.tolist() == [2.0] * 4
    assert gc.isenabled()
    gc.collect()


def test_a_failed_train_capture_raises_and_does_not_fall_back(cuda,
                                                             tmp_path):
    """A host sync inside the step (as ``.item()`` would be) breaks the
    capture: train_steps raises and the eager loop never runs (in a
    process of its own, so that the broken capture cannot touch the
    other tests)."""
    import os
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    code = (
        "import numpy as np\n"
        "from kaldi_cnn_tpu_torch.models import components as C\n"
        "from kaldi_cnn_tpu_torch.models.nnet import Nnet\n"
        "step = Nnet.train_step\n"
        "def synced(self, opt, x, *a, **k):\n"
        "    float(x.sum())\n"
        "    return step(self, opt, x, *a, **k)\n"
        "Nnet.train_step = synced\n"
        "eager = []\n"
        "Nnet._train_steps_eager = lambda *a, **k: eager.append(1)\n"
        "net = Nnet([C.AffineComponent(8, 16, device='cuda'),\n"
        "            C.SoftmaxComponent(16)])\n"
        "try:\n"
        "    net.train_steps(net.init_opt(), np.zeros((2, 4, 8), 'f4'),\n"
        "                    np.zeros((2, 4), 'i4'), 0.1)\n"
        "except RuntimeError as e:\n"
        "    print('raised', not eager, type(e).__name__)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(here), here]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path, env=env)
    assert "raised True" in out.stdout, out.stdout + out.stderr


@pytest.mark.parametrize("rows", [1, 300, 4097])
def test_rm_dnn_loglikes_on_card_match_cpu(cuda, rows):
    """The RM recipe's p-norm DNN (180-dim rows: 20-dim fMLLR features
    spliced +-4; 2 x (Affine -> Pnorm 800/160 -> Normalize) -> Affine ->
    Softmax; seeded weights, the output affine redrawn): its loglikes on
    the card against the CPU copy's within 5e-2, the smoke's limit for
    card against CPU replay."""
    import copy
    from kaldi_cnn_tpu_torch.models.factory import (PnormDnnConfig,
                                                    make_pnorm_dnn)
    from kaldi_cnn_tpu_torch.models.nnet import AmNnet
    from kaldi_cnn_tpu_torch.recipes import rm
    num_pdfs = 250
    net = make_pnorm_dnn(PnormDnnConfig(
        input_dim=180, num_hidden_layers=2, pnorm_input_dim=800,
        pnorm_output_dim=160, num_pdfs=num_pdfs), device=cuda)
    gen = torch_generator(8, "rm")
    net.init(gen)
    with torch.no_grad():
        out = net.components[-2]
        out.w.copy_(torch.randn(out.w.shape, generator=gen) / 160 ** 0.5)
    am, am_cpu = AmNnet(net, num_pdfs), AmNnet(
        copy.deepcopy(net).to("cpu"), num_pdfs)
    counts = np_rng(9, "rm priors").integers(1, 50, num_pdfs)
    am.set_priors_from_counts(counts)
    am_cpu.set_priors_from_counts(counts)
    g = np_rng(10, "rm fmllr").normal(size=(rows, 20)).astype(np.float32)
    x = F.splice_frames(g, rm.CONTEXT, rm.CONTEXT)
    assert x.shape == (rows, 180)
    got = am.loglikes_batch({"u": x})["u"]
    want = am_cpu.loglikes_batch({"u": x})["u"]
    assert got.shape == (rows, num_pdfs) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)


# ---- data parallelism on the card (two gloo ranks on the one card) -------

# the Librispeech recipe's net: 11x36x3 volumes, conv 4x7 with F = 48,
# pool 2x3, 2 x (Affine 800 -> Pnorm 160 -> Normalize), 300 pdfs
LIBRI_CFG = dict(in_t=11, in_f=36, in_c=3, filt_t=4, filt_f=7,
                 num_filters=48, pool_t=2, pool_f=3, pool_c=1,
                 num_hidden_layers=2, pnorm_input_dim=800,
                 pnorm_output_dim=160, num_pdfs=300)
LIBRI_LR = 0.08
DP_PARAM_REL = 1e-3   # the smoke's card-vs-replay training limits
DP_OBJF_ATOL = 1e-3


@pytest.mark.parametrize("replicas", [1, 2])
def test_two_ranks_on_the_card_match_world_size_one(cuda, replicas):
    """Two gloo ranks with CUDA tensors on the one card (NCCL refuses two
    ranks on one GPU), at the Librispeech recipe's net width, 3 steps: in
    mode A each holds half of a 256-row minibatch and they give the
    single-process steps on the whole of it; as two replicas each steps
    on its half and the average gives the mean of the two single-process
    streams.  Objf 1e-3, parameters 1e-3 relative; the ranks bit-equal;
    the maxpool kernels ran in both."""
    from kaldi_cnn_tpu_torch.models.factory import ConvnetConfig
    from kaldi_cnn_tpu_torch.parallel import rank_check
    cfg = ConvnetConfig(**LIBRI_CFG)
    res = rank_check.two_ranks_vs_one(
        cfg, rank_check.seeded_case(cfg, 5, 256), 3, LIBRI_LR, replicas,
        cuda)
    assert res["ranks_equal"]
    assert min(sum(res["launches"], ())) >= 3
    assert res["objf_err"] <= DP_OBJF_ATOL
    assert res["param_rel"] <= DP_PARAM_REL


def test_tensor_parallel_ranks_on_the_card_match_world_size_one(cuda):
    """make_dp_tp_step over two gloo ranks with CUDA tensors (data 1 x
    model 2: the three Affine layers of the Librispeech-width net split
    by rows), 3 steps on a 256-row minibatch, against the single-process
    steps: objf 1e-3, parameters 1e-3 relative (the two-rank bar above);
    the ranks bit-equal."""
    from kaldi_cnn_tpu_torch.models.factory import ConvnetConfig
    from kaldi_cnn_tpu_torch.parallel import rank_check
    cfg = ConvnetConfig(**LIBRI_CFG)
    res = rank_check.tp_two_ranks_vs_one(
        cfg, rank_check.seeded_case(cfg, 5, 256), 3, LIBRI_LR, cuda)
    assert res["ranks_equal"] and res["sharded"] == 3
    assert res["objf_err"] <= DP_OBJF_ATOL
    assert res["param_rel"] <= DP_PARAM_REL


# ---- train_multihost's dp step as CUDA graphs over NCCL -------------------

@contextlib.contextmanager
def _world_of_one(backend):
    """A process group of this process alone over ``backend``, its mesh
    on the card, ended afterwards."""
    import torch.distributed as dist
    from kaldi_cnn_tpu_torch.core.mesh import make_mesh
    dist.init_process_group(backend, store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        yield make_mesh(1, "cuda")
    finally:
        dist.destroy_process_group()


def _libri_case(cuda, rows=256, seed=5):
    from kaldi_cnn_tpu_torch.models.factory import (ConvnetConfig,
                                                    make_convnet)
    net = make_convnet(ConvnetConfig(**LIBRI_CFG), fused=True, device=cuda)
    net.init(torch_generator(seed, "dp graphs"))
    r = np_rng(seed, "dp graphs rows")
    x = r.normal(size=(rows, net.input_dim)).astype(np.float32)
    y = r.integers(0, net.output_dim, rows).astype(np.int32)
    return net, x, y, np.ones(rows, np.float32)


def test_train_multihost_graphs_over_nccl_match_eager_bit_for_bit(
        deterministic_cudnn):
    """train_multihost over an NCCL group of one at the Librispeech net's
    width, 112 steps of 256 rows (the NG warm-up's 64, then 3 refreshes
    in 48), through the dp step's graphs and eagerly: objfs, parameters
    and NG states bit for bit; the replays' all-reduces (5 a step) and
    maxpool launches equal the eager run's; no eager-loop call in the
    graphed run, every step in the eager one."""
    from kaldi_cnn_tpu_torch.models.factory import ConvnetConfig
    from kaldi_cnn_tpu_torch.parallel import rank_check
    r = rank_check.nccl_graphs_vs_eager(ConvnetConfig(**LIBRI_CFG), 112,
                                        256, LIBRI_LR, 5)
    g, e = r["graphed"], r["eager"]
    assert all(r["same"].values()), r["same"]
    assert r["refreshes"] == (67, 3)
    assert g["all_reduces"] == e["all_reduces"] == 5 * 112 + 2
    assert g["maxpool"] == e["maxpool"] == (112, 112)
    assert g["warmup"]["all_reduces"] > 0 and e["warmup"]["all_reduces"] == 0
    assert g["eager_calls"] == 0 and e["eager_calls"] == 112
    # a graph a gate vector at K = 1 (all states refresh together): the
    # refreshing step, the plain step, and one tail
    assert g["graphs"] == 3


def test_dp_step_over_gloo_on_the_card_captures_nothing(cuda):
    """A gloo group's collectives run on the host: the dp step of a CUDA
    net over one runs eagerly and captures no graph, and
    ``Nnet.train_steps`` given the group does the same."""
    from kaldi_cnn_tpu_torch.parallel.dp import make_dp_step
    net, x, y, w = _libri_case(cuda, rows=64)
    with _world_of_one("gloo") as mesh:
        step = make_dp_step(net, mesh)
        opt = net.init_opt()
        for _ in range(3):
            opt, objf = step(opt, x, y, LIBRI_LR, w)
        opt, _ = net.train_steps(opt, [x], [y], [LIBRI_LR], weights=[w],
                                 group=mesh.data_group)
        torch.cuda.synchronize()
    assert torch.isfinite(objf)
    assert net._step_graphs is None


def test_dp_step_replays_add_their_captured_all_reduces(cuda):
    """Under NCCL each replay of the dp step's graph adds the all-reduces
    its capture issued: N replays add N times the captured count (5 at
    the Librispeech net: the objective and 4 NG-SGD updates)."""
    from kaldi_cnn_tpu_torch.core import mesh as mesh_ops
    from kaldi_cnn_tpu_torch.models.step_graphs import ng_states, with_states
    from kaldi_cnn_tpu_torch.parallel.dp import make_dp_step
    net, x, y, w = _libri_case(cuda)
    with _world_of_one("nccl") as mesh:
        step = make_dp_step(net, mesh)
        # past the NG warm-up, between refreshes: the plain step's graph
        opt = with_states(net.init_opt(), [s._replace(t=65) for _, s in
                                           ng_states(net.init_opt())])
        opt, _ = step(opt, x, y, LIBRI_LR, w)         # warm-up + capture
        (graph,) = net._step_graphs.graphs.values()
        captured = dict((fn.__name__, n) for fn, n in graph.launches)
        before = mesh_ops.all_reduce.launches
        for _ in range(10):
            opt, objf = step(opt, x, y, LIBRI_LR, w)
        torch.cuda.synchronize()
        assert len(net._step_graphs.graphs) == 1
    assert captured["all_reduce"] == 5
    assert mesh_ops.all_reduce.launches - before == 10 * 5
    assert torch.isfinite(objf)


def test_step_graphs_are_not_replayed_under_another_precision(cuda):
    """train_nnet twice on one CUDA net, at matmul_precision "float32"
    and then "tensorfloat32": the second captures graphs of its own (the
    flags are in every graph's key), and every replay runs under the
    flags its graph was captured with; the flags are back afterwards."""
    from kaldi_cnn_tpu_torch.core import graphs
    from kaldi_cnn_tpu_torch.train.egs import Egs
    from kaldi_cnn_tpu_torch.train.trainer import TrainConfig, train_nnet
    net, _, _, _ = _libri_case(cuda)
    r = np_rng(7, "precision graphs")
    n = 8 * 128
    x = r.normal(size=(n, net.input_dim)).astype(np.float32)
    y = r.integers(0, net.output_dim, n).astype(np.int32)
    egs = Egs(x, y, np.ones(n, np.float32))
    flags = lambda: (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32,
                     torch.get_float32_matmul_precision())
    replayed = []
    replay = graphs.CountedGraph.replay

    def checking(self):
        key = next(k for k, g in net._step_graphs.graphs.items()
                   if g is self)
        replayed.append((key[-3:], flags()))
        replay(self)

    before = flags()
    counts = []
    try:
        graphs.CountedGraph.replay = checking
        for prec in ("float32", "tensorfloat32"):
            train_nnet(net, egs, Egs(x[:128], y[:128], egs.weights[:128]),
                       TrainConfig(num_epochs=1, minibatch_size=128,
                                   combine_num_models=1,
                                   matmul_precision=prec))
            counts.append(len(net._step_graphs.graphs))
    finally:
        graphs.CountedGraph.replay = replay
    assert flags() == before
    assert counts[1] == 2 * counts[0] > 0
    assert {f for f, _ in replayed} == {(False, False, "highest"),
                                         (True, True, "high")}
    assert all(f == now for f, now in replayed)


# ---- the command-line verbs -----------------------------------------------

def _wav_scp(d, n=3, seed=4):
    """``n`` synthetic digit utterances at 8 kHz as wav files and a
    ``wav.scp``; returns its path."""
    import os
    from kaldi_cnn_tpu_torch.io.wave import write_wave
    lex = synthetic.digits_lexicon()
    corpus = synthetic.make_corpus(
        lex, {w: 1.0 / len(lex.entries) for w in lex.entries}, n, 1, 3, seed)
    scp = os.path.join(d, "wav.scp")
    with open(scp, "w") as f:
        for utt in sorted(corpus.waves):
            path = os.path.join(d, f"{utt}.wav")
            write_wave(path, corpus.waves[utt], corpus.sample_rate)
            f.write(f"{utt} {path}\n")
    return scp, len(corpus.waves)


def _verb_on_both(verb, args, d, tag):
    """``verb`` on the card and with --device=cpu; the two output arks
    read back (utt -> matrix), and the fbank kernel's launches on the
    card."""
    import os
    from kaldi_cnn_tpu_torch import cli
    from kaldi_cnn_tpu_torch.io.kaldi_io import read_mat_ark
    out = {}
    for dev in ("cuda", "cpu"):
        path = os.path.join(d, f"{tag}_{dev}.ark")
        before = fb.fbank_frames.launches
        assert cli.main([verb, *args, f"--device={dev}", path]) == 0
        torch.cuda.synchronize()
        out[dev] = (dict(read_mat_ark(path)), fb.fbank_frames.launches
                    - before)
    return out


@pytest.mark.parametrize("kind,bins", [("fbank", 36), ("fbank", 23),
                                       ("mfcc", 23)])
def test_feature_verbs_on_card_match_cpu(cuda, tmp_path, kind, bins):
    """compute-{fbank,mfcc}-feats on the card (one fbank kernel launch an
    utterance) against --device=cpu (the plain version), at dither 0 and
    at dither 1 (the same generator stages on both): fbank 1e-3; MFCC
    cepstrum c within 2e-3 x lifter_coeffs[c], energy 1e-3."""
    scp, n = _wav_scp(str(tmp_path))
    if kind == "mfcc":
        lim = 2e-3 * F.lifter_coeffs(13, 22.0).astype(np.float64)
        lim[0] = 1e-3
    else:
        lim = FBANK_ATOL
    for dither in ("0", "1"):
        out = _verb_on_both(f"compute-{kind}-feats",
                            [f"--num-mel-bins={bins}", f"--dither={dither}",
                             scp], str(tmp_path), f"{kind}{dither}")
        (card, launched), (cpu, none) = out["cuda"], out["cpu"]
        assert (launched, none) == (n, 0)
        assert sorted(card) == sorted(cpu) and len(cpu) == n
        for u in cpu:
            assert card[u].shape == cpu[u].shape
            assert (np.abs(card[u] - cpu[u]) <= lim).all(), u


def test_latgen_faster_on_card_matches_cpu(cuda, tmp_path):
    """A WSJ-width CNN .mdl (F = 64, random weights, the digits monophone
    transition model) through compute-fbank-feats -> add-deltas ->
    splice-feats -> latgen-faster on the card and with --device=cpu: the
    conv+maxpool kernel launches on the card, and the two give the same
    hyps and lattice one-best costs (rel 1e-4 / abs 5e-2)."""
    import os
    from kaldi_cnn_tpu_torch import cli
    from kaldi_cnn_tpu_torch.decode.lattice import (load_lattices,
                                                    shortest_path)
    from kaldi_cnn_tpu_torch.io.kaldi_model import write_am_nnet
    from kaldi_cnn_tpu_torch.models.factory import make_convnet
    from kaldi_cnn_tpu_torch.recipes import wsj
    d = str(tmp_path)

    def p(name):
        return os.path.join(d, name)
    scp, n = _wav_scp(d, n=4, seed=9)
    lang = Lang.create(synthetic.digits_lexicon())
    tm = lang.trans_model
    net = make_convnet(wsj.model_config(36, tm.num_pdfs), fused=True,
                       device="cpu")
    gen = torch_generator(3, "latgen")
    net.init(gen)
    with torch.no_grad():
        out = net.components[-2]
        out.w.copy_(torch.randn(out.w.shape, generator=gen) / 20)
    priors = np_rng(3, "priors").dirichlet(np.ones(tm.num_pdfs))
    write_am_nnet(p("cnn.mdl"), tm, net, None, priors)
    os.makedirs(p("lang"))
    lang.word_table.write(p("lang/words.txt"))
    wp = {w: 1.0 / len(lang.lexicon.entries) for w in lang.lexicon.entries}
    with open(p("HCLG.txt"), "w") as f:
        make_hclg_from_arpa(lang, make_unigram_arpa(wp)).write_text(f)
    for argv in (["compute-fbank-feats", "--num-mel-bins=36", "--dither=0",
                  scp, p("fbank.ark")],
                 ["add-deltas", p("fbank.ark"), p("deltas.ark")],
                 ["splice-feats", "--left-context=5", "--right-context=5",
                  p("deltas.ark"), p("spliced.ark"),
                  f"--out-scp={p('spliced.scp')}"]):
        assert cli.main(argv) == 0
    lats, hyps = {}, {}
    for dev in ("cuda", "cpu"):
        before = tc.conv2d_maxpool.launches
        assert cli.main(["latgen-faster", "--beam=30", "--max-active=500",
                         f"--device={dev}", f"--lang-dir={p('lang')}",
                         p("cnn.mdl"), p("HCLG.txt"), p("spliced.scp"),
                         p(f"lats_{dev}.npz"), p(f"hyp_{dev}.txt")]) == 0
        torch.cuda.synchronize()
        launched = tc.conv2d_maxpool.launches - before
        assert launched == (n if dev == "cuda" else 0)
        lats[dev] = load_lattices(p(f"lats_{dev}.npz"))
        with open(p(f"hyp_{dev}.txt")) as f:
            hyps[dev] = f.read()
    assert hyps["cuda"] == hyps["cpu"] and len(lats["cpu"]) == n
    for u, lat in lats["cpu"].items():
        _, words, cost = shortest_path(lat, 1.0, 0.1)
        _, words_c, cost_c = shortest_path(lats["cuda"][u], 1.0, 0.1)
        assert list(words_c) == list(words)
        assert cost_c == pytest.approx(cost, rel=1e-4, abs=5e-2)


def test_chip_smoke_cli_phase(cuda, tmp_path):
    """chip_smoke.py's phase 14 on the artifacts of a small wsj.run on the
    card (12 utterances, 1 epoch; the phase's own checks: the verbs'
    pipeline, the CNN's words equal to wsj.nnet_decode's, the loglikes
    within 5e-2 of the CPU replay, kernels 2.1 and 2.2 launched), then
    phase 15 on its files (the lattice verbs' checks, the big graph)."""
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    corpus = smoke.wsj.make_corpus(12, smoke.SEED)
    exp = str(tmp_path / "wsj")
    smoke.wsj.run(corpus=corpus, nnet_epochs=1, seed=smoke.SEED,
                  device=cuda, exp_dir=exp)
    launches = smoke.cli_phase(cuda, exp, str(tmp_path),
                               smoke.wsj.split_corpus(corpus)[2])
    assert min(launches["fbank_fft"], launches["conv_maxpool"]) > 0
    # and phase 15 on its files (the lattice verbs, the big graph)
    launches, _ = smoke.lattice_phase(cuda, str(tmp_path),
                                      smoke.wsj.split_corpus(corpus)[2])
    assert min(launches["fbank_fft"], launches["conv_maxpool"]) > 0


def test_big_graph_topk_on_card_matches_host_viterbi(cuda):
    """``bench.py:194``'s graph (539,948 states, 1,169,894 arcs): 20 frames
    at beam 60, max_active 16384 on the card give the host exact
    Viterbi's words, and its cost within rel 1e-4 / abs 0.1."""
    from kaldi_cnn_tpu_torch.decode.biggraph import (make_big_graph,
                                                     sample_loglikes)
    from kaldi_cnn_tpu_torch.decode.decoder import viterbi_decode
    g = make_big_graph(num_words=90_000, num_pdfs=256, min_len=4,
                       max_len=8, seed=3)
    assert g.num_states >= 100_000
    assert len(g.e_src) + len(g.n_src) >= 1_000_000
    ll = sample_loglikes(g, 256, T=20, seed=5)
    dec = TK.TopKDecoder(g, beam=60.0, max_active=16384, acoustic_scale=1.0,
                         device=cuda)
    ((tids, words, cost),) = dec.decode_batch([ll])
    _, words_h, cost_h = viterbi_decode(g, ll, acoustic_scale=1.0,
                                        beam=np.inf, max_active=0)
    assert len(tids) == ll.shape[0]
    assert cost == pytest.approx(cost_h, rel=1e-4, abs=0.1)
    assert list(words) == list(words_h)


@pytest.mark.parametrize("beam,max_active", [(1e9, 0), (12.0, 40)])
def test_dense_search_graphs_match_eager_and_cpu(cuda, beam, max_active):
    """``DenseViterbiDecoder`` on the digits HCLG: the captured frame
    blocks against the eager frames on the card (tids, words, cost bits)
    and against the CPU (tids, words; cost rel 1e-5 / abs 1e-2); a second
    batch of the same shape replays the graphs without a capture, and a
    longer one captures its histories anew."""
    from kaldi_cnn_tpu_torch.decode.biggraph import sample_loglikes
    from kaldi_cnn_tpu_torch.decode.tpu_decoder import DenseViterbiDecoder
    lex = synthetic.digits_lexicon()
    wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
    lang = Lang.create(lex)
    g = CompiledGraph(make_hclg_from_arpa(lang, make_unigram_arpa(wp)),
                      lang.trans_model.trans_id_to_pdf_array())
    P = lang.trans_model.num_pdfs
    lls = [sample_loglikes(g, P, T=t, seed=s)
           for s, t in enumerate((70, 45, 90, 17))]
    kw = dict(beam=beam, max_active=max_active, acoustic_scale=0.5)
    dec = DenseViterbiDecoder(g, device=cuda, **kw)
    cap = dec.decode_batch(lls)
    caps = dict(dec.capture_seconds)
    again = dec.decode_batch(lls)
    assert dec.capture_seconds == caps and set(caps) == {64, 16, 4, 1}
    eager = dec.decode_batch(lls, eager=True)
    cpu = DenseViterbiDecoder(g, device="cpu", **kw).decode_batch(lls)
    bits = lambda c: np.float32(c).view(np.int32)
    for c, a, e, h in zip(cap, again, eager, cpu, strict=True):
        for o in (a, e):
            np.testing.assert_array_equal(c[0], o[0])
            assert list(c[1]) == list(o[1]) and bits(c[2]) == bits(o[2])
        np.testing.assert_array_equal(c[0], h[0])
        assert list(c[1]) == list(h[1])
        assert c[2] == pytest.approx(h[2], rel=1e-5, abs=1e-2)
    longer = dec.decode_batch(lls[:3] + [sample_loglikes(g, P, T=130)])
    assert len(longer[3][0]) == 130 and dec._runner.T == 130


def test_mode_b_graphs_match_eager_bit_for_bit(cuda):
    """``make_replica_step``: 4 replicas of the Librispeech net, 8 steps
    of 256 rows each in the NG warm-up, through the step graphs and
    eagerly under deterministic cuDNN: objfs, parameters and NG states
    bit for bit, the replicas diverged, one model after
    ``average_replicas``, maxpool launches equal (less the graphs'
    warm-ups) and one forward and one backward a replica step."""
    from kaldi_cnn_tpu_torch.models.factory import ConvnetConfig
    from kaldi_cnn_tpu_torch.parallel import rank_check
    r = rank_check.replicas_graphs_vs_eager(ConvnetConfig(**LIBRI_CFG), 4, 8,
                                            256, LIBRI_LR, 5)
    g, e = r["graphed"], r["eager"]
    assert all(r["same"].values()), r["same"]
    assert r["diverged"] and r["averaged_equal"]
    assert e["maxpool"] == (32, 32) and e["warmup"] == (0, 0)
    assert (g["maxpool"][0] - g["warmup"][0],
            g["maxpool"][1] - g["warmup"][1]) == (32, 32)
    assert g["captures"]


@pytest.mark.parametrize("dither", [0.0, 1.0])
def test_plp_on_card_matches_cpu(cuda, dither):
    """PLP's framing and power spectrum on the card against the CPU, the
    same dither noise from one CPU generator seed (cepstra 2e-3 x lifter,
    energy 1e-3: the rule of the port-vs-JAX test)."""
    from kaldi_cnn_tpu_torch.features.plp import PlpOptions, compute_plp
    wave = (np_rng(3, "plp").normal(size=8000) * 1000).astype(np.float32)
    opts = PlpOptions()
    opts.frame_opts.samp_freq = 8000.0
    opts.frame_opts.dither = dither
    got, want = (compute_plp(wave, opts, torch_generator(3, "plp_dither"),
                             device=d) for d in (cuda, "cpu"))
    lim = 2e-3 * F.lifter_coeffs(opts.num_ceps, opts.cepstral_lifter)
    lim[0] = 1e-3
    assert got.shape == want.shape == (F.num_frames(8000, opts.frame_opts),
                                       opts.num_ceps)
    assert (np.abs(got - want).max(axis=0) <= lim).all()
