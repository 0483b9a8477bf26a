// Fused log-mel filterbank over a batch of raw frames: three kernels, one
// function.
//
// Replaces the TPU kernel kaldi_cnn_tpu/ops/fbank_pallas.py::_fbank_kernel.
// Per frame: DC-offset removal over the window_size valid samples, raw log
// energy, pre-emphasis (sample 0 is its own predecessor), analysis window,
// zero padding to padded_window_size N, real DFT, power, mel sums, log
// floored at FLT_EPSILON.  Dither is added to the frames before the kernel;
// energy flooring and use_energy stay in the wrapper (ops/fbank.py), which
// picks one of the three kernels from N before the launch.
//
// fbank_fft_kernel (kcnn_fbank_fft), for N a power of two from 64 to 2048
// (Kaldi's round_to_power_of_two, the default: 256 at 8 kHz, 512 at
// 16 kHz), one instantiation for each R = N / 64 in 1..32.  The Pallas
// kernel takes the DFT as two dense products against cos/sin tables because
// the TPU's matrix unit makes them cheap; on the H100's CUDA cores that is
// 4 * ws * (N/2 + 1) flops a frame (411 kflop at 16 kHz) and streams an
// 822 KB table from L2 for every 8 frames, which bounds the table kernel
// below.  A real FFT is 2.5 N log2 N flops (11.5 kflop at 16 kHz), and what
// is left to bound it on this card is where its data moves between the
// steps.  A first version (one warp a frame, radix-4 Stockham passes between
// two shared-memory buffers) took 0.046 ms on an H100 80GB HBM3 (700 W) at
// 16 kHz x 12000 frames, 7x its bound: about 450 shared-memory wavefronts a
// frame (eight-way bank conflicts in the early passes' stores) saturated
// the SMs' shared-memory bandwidth.  So the FFT now lives in registers, one
// warp a frame, 8 frames a block:
//   * lane l holds the N/2 = 32 R complex points z[q] = x[2q] + i x[2q+1]
//     with q = l + 32 m in its registers m < R, loaded straight from the
//     frame (a warp request reads 256 contiguous bytes; 8-byte loads when
//     ws is even and the frames and window are 8-byte aligned, else scalar
//     ones);
//   * DC removal and the energy are warp sums; pre-emphasis takes each
//     sample's predecessor by a shuffle; the window multiplies in place;
//   * Z = FFT(z) with k = k1 + R k2 factors into an R-point DIF in each
//     lane's registers, a twiddle W_{N/2}^{l k1}, and a 32-point DIF across
//     the lanes by __shfl_xor_sync (5 steps);
//   * the real-FFT post-pass X[k] = E[k] + W_N^k O[k] (E, O from Z[k] and
//     conj Z[N/2 - k], fetched by one shuffle) gives the N/2 + 1 bins'
//     power, the only thing written to shared memory (stored at k + k/32,
//     so the scattered stores do not conflict);
//   * one lane per mel bin sums only its triangular filter's band (first
//     bin, length, and the weights laid out [band position][bin], all
//     precomputed on the host) and writes log(max(sum, FLT_EPSILON)); lane
//     0 writes the energy.
// The twiddles W_N^t = exp(-2 pi i t / N), t < N, and W_64^j, j < 64, are
// built on the host in float64 and stored as f32 (no __sinf/__cosf); they,
// the window and the mel bands are read through L1, which all the SM's
// warps share.  Each lane derives its W_{N/2}^{l k1} as powers of one load,
// and W_N^k as W_N^{k1} W_64^{k2}, so a warp's twiddle loads touch a few L1
// lines instead of one a lane.
//
// fbank_mixed_kernel (kcnn_fbank_fft_mixed), for N = 50 L with L a power of
// two from 2 to 32: the sizes Kaldi's 25 ms frames take with
// round_to_power_of_two off (N = ws = 200 at 8 kHz, 400 at 16 kHz), which
// went to the table kernel below at 2 % of its bound (0.3059 ms against
// 0.0061 at 16 kHz x 12000 frames on an H100 80GB HBM3, 700 W).  The same
// chain and the same register design as the power-of-two kernel, with the
// complex FFT of H = N / 2 = 25 L points split as 25 x L: L lanes a frame
// and F = 32 / L frames a warp (every lane busy), the 25 points of a lane
// in its registers as a 5 x 5 DFT of radix-5 butterflies on constants with
// the W_25 twiddles between, the twiddle W_H^{l k1}, then an L-point
// radix-2 DIF across the frame's lanes by shuffles (log2 L steps, 25
// registers a step), and the power-of-two kernel's real-FFT post-pass.  A
// warp's F frames keep their bins at a stride of L modulo 32 floats in
// shared memory, so the post-pass's stores do not conflict.  Every twiddle
// is a load of the host's float64-built W_N table, none a power.  As for
// the power-of-two kernel, the bound is the frames' bytes, and what is left
// to limit it is the data movement between the steps: 2 x 25 shuffles a
// cross-lane step, log2 L steps, none through shared memory.
//
// fbank_kernel (kcnn_fbank), any N, the one taken when N is neither a power
// of two from 64 to 2048 nor 50 L: the real DFT as two sums against the
// cos/sin tables of features.functional.dft_matrices and the mel sums
// against the dense mel_banks table.  Each table element a block fetches
// serves FPB frames held in shared memory, the frames are read four samples
// at a time (one float4 broadcast per frame for 8 FMAs), one thread per DFT
// bin keeps the table reads coalesced, and one warp per frame does the
// per-frame reductions.
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int FPB = 8;                       // frames per block
constexpr float kEpsilon = 1.1920928955078125e-07f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void fbank_kernel(const float* __restrict__ frames, int T, int ws,
                             const float* __restrict__ cos_t,
                             const float* __restrict__ sin_t, int nb,
                             const float* __restrict__ mel, int M,
                             const float* __restrict__ window, float preemph,
                             int remove_dc, float* __restrict__ out,
                             float* __restrict__ energy) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldx = (ws + 3) & ~3;  // frame row stride, 16B aligned
  float* xs = smem;               // [FPB][ldx] processed frames
  float* pw = smem + FPB * ldx;   // [FPB][nb] power spectrum
  const int t0 = blockIdx.x * FPB;
  const int nfr = min(FPB, T - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  for (int idx = threadIdx.x; idx < FPB * ldx; idx += blockDim.x) {
    const int f = idx / ldx, i = idx - f * ldx;
    xs[idx] = (f < nfr && i < ws) ? frames[(size_t)(t0 + f) * ws + i] : 0.f;
  }
  __syncthreads();

  // one warp per frame: DC removal, raw energy, pre-emphasis + window
  for (int f = warp; f < nfr; f += nwarps) {
    float* x = xs + f * ldx;
    if (remove_dc) {
      float s = 0.f;
      for (int i = lane; i < ws; i += 32) s += x[i];
      const float mean = warp_sum(s) / (float)ws;
      for (int i = lane; i < ws; i += 32) x[i] -= mean;
      __syncwarp();
    }
    float e = 0.f;
    for (int i = lane; i < ws; i += 32) e = fmaf(x[i], x[i], e);
    e = warp_sum(e);
    if (lane == 0) energy[t0 + f] = logf(fmaxf(e, kEpsilon));
    // x'[i] = (x[i] - preemph * x[i-1]) * window[i], in chunks of 32
    // samples; the predecessor of a chunk's first sample is carried from
    // the previous chunk's last lane before it is overwritten
    float carry = x[0];
    __syncwarp();
    for (int base = 0; base < ws; base += 32) {
      const int i = base + lane;
      const float cur = (i < ws) ? x[i] : 0.f;
      float prev = __shfl_up_sync(kFull, cur, 1);
      if (lane == 0) prev = carry;
      carry = __shfl_sync(kFull, cur, 31);
      if (i < ws) x[i] = (cur - preemph * prev) * window[i];
    }
  }
  __syncthreads();

  // real DFT: one thread per bin, FPB frames per table read, four
  // samples per shared-memory load (samples past ws are zero: ldx pads)
  for (int k = threadIdx.x; k < nb; k += blockDim.x) {
    float re[FPB], im[FPB];
#pragma unroll
    for (int f = 0; f < FPB; ++f) re[f] = im[f] = 0.f;
    for (int i = 0; i < ws; i += 4) {
      float c[4], s[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool in = i + u < ws;
        c[u] = in ? cos_t[(size_t)(i + u) * nb + k] : 0.f;
        s[u] = in ? sin_t[(size_t)(i + u) * nb + k] : 0.f;
      }
#pragma unroll
      for (int f = 0; f < FPB; ++f) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + f * ldx + i);
        re[f] = fmaf(xv.x, c[0], re[f]);
        im[f] = fmaf(xv.x, s[0], im[f]);
        re[f] = fmaf(xv.y, c[1], re[f]);
        im[f] = fmaf(xv.y, s[1], im[f]);
        re[f] = fmaf(xv.z, c[2], re[f]);
        im[f] = fmaf(xv.z, s[2], im[f]);
        re[f] = fmaf(xv.w, c[3], re[f]);
        im[f] = fmaf(xv.w, s[3], im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < FPB; ++f) pw[f * nb + k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  // mel filterbank + log
  for (int j = threadIdx.x; j < nfr * M; j += blockDim.x) {
    const int f = j / M, m = j - f * M;
    const float* p = pw + f * nb;
    const float* w = mel + (size_t)m * nb;
    float acc = 0.f;
    for (int k = 0; k < nb; ++k) acc = fmaf(p[k], w[k], acc);
    out[(size_t)(t0 + f) * M + m] = logf(fmaxf(acc, kEpsilon));
  }
}

// bits-bit reversal of r, at compile time where r is.
__host__ __device__ constexpr int bit_reverse(int r, int bits) {
  int o = 0;
  for (int b = 0; b < bits; ++b) o |= ((r >> b) & 1) << (bits - 1 - b);
  return o;
}

__host__ __device__ constexpr int log2_exact(int r) {
  return r <= 1 ? 0 : 1 + log2_exact(r >> 1);
}

// Floats of shared memory a warp: the power of bins 0..H, stored at
// k + k / 32 so that the scattered stores of the post-pass do not conflict.
__host__ __device__ constexpr int fft_pw_floats(int h) {
  return (h + 2 + h / 32 + 3) & ~3;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// One radix-2 DIF stage of half-size D over the R registers of a lane, then
// the next; every register index is a compile-time constant, so re and im
// stay in registers.  tw[t] = W_N^t, N = 64 R.
template <int R, int D>
__device__ __forceinline__ void dif_registers(float (&re)[R], float (&im)[R],
                                              const float2* __restrict__ tw) {
  constexpr int N = 64 * R;
#pragma unroll
  for (int b = 0; b < R; b += 2 * D) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float ar = re[b + i], ai = im[b + i];
      const float cr = re[b + i + D], ci = im[b + i + D];
      re[b + i] = ar + cr;
      im[b + i] = ai + ci;
      const float dr = ar - cr, di = ai - ci;
      if (i == 0) {
        re[b + i + D] = dr;
        im[b + i + D] = di;
      } else {                                    // W_{2D}^i, the same for
        const float2 w = __ldg(tw + i * (N / (2 * D)));   // every lane
        re[b + i + D] = dr * w.x - di * w.y;
        im[b + i + D] = dr * w.y + di * w.x;
      }
    }
  }
  if constexpr (D > 1) dif_registers<R, D / 2>(re, im, tw);
}

// Register r holds k1 = bitrev(r) after the DIF: multiply by W_H^{l k1},
// the k1-th power of the lane's W_H^l.
template <int R, int... rs>
__device__ __forceinline__ void twiddle_registers(
    float (&re)[R], float (&im)[R], const float2 (&pow)[R],
    std::integer_sequence<int, rs...>) {
  constexpr int LR = log2_exact(R);
  (
      [&] {
        constexpr int k1 = bit_reverse(rs, LR);
        const float xr = re[rs], xi = im[rs];
        re[rs] = xr * pow[k1].x - xi * pow[k1].y;
        im[rs] = xr * pow[k1].y + xi * pow[k1].x;
      }(),
      ...);
}

// The real-FFT post-pass for register r (k1 = bitrev(r)) of every lane
// (k2 = bitrev(l)): X[k] = E + W_N^k O with E = (Z[k] + conj Z[H-k]) / 2,
// O = -i (Z[k] - conj Z[H-k]) / 2, and Z[H-k] from register bitrev(R - k1)
// of lane l ^ 31 (k1 > 0) or register 0 of lane bitrev(32 - k2) (k1 = 0);
// W_N^k = W_N^{k1} W_64^{k2}.  The power of bin k goes to pw[k + k / 32].
template <int R, int... rs>
__device__ __forceinline__ void power_registers(
    const float (&re)[R], const float (&im)[R], int lane,
    const float2* __restrict__ tw, float* pw,
    std::integer_sequence<int, rs...>) {
  constexpr int LR = log2_exact(R), N = 64 * R;
  const int k2 = __brev(lane) >> 27;
  const int k2_mirror = __brev((32 - k2) & 31) >> 27;
  const float2 w64 = __ldg(tw + N + k2);
  (
      [&] {
        constexpr int k1 = bit_reverse(rs, LR);
        constexpr int rp = k1 ? bit_reverse(R - k1, LR) : 0;
        const int src = k1 ? lane ^ 31 : k2_mirror;
        const float br = __shfl_sync(kFull, re[rp], src);
        const float bi = __shfl_sync(kFull, im[rp], src);
        const float ex = 0.5f * (re[rs] + br), ey = 0.5f * (im[rs] - bi);
        const float ox = 0.5f * (im[rs] + bi), oy = -0.5f * (re[rs] - br);
        const float2 w = k1 ? cmul(__ldg(tw + k1), w64) : w64;
        const float xr = ex + w.x * ox - w.y * oy;
        const float xi = ey + w.x * oy + w.y * ox;
        const int k = k1 + R * k2;
        pw[k + (k >> 5)] = xr * xr + xi * xi;
      }(),
      ...);
}

// One warp a frame, the N/2 = H = 32 R complex points in registers: lane l
// holds z[q] = x[2q] + i x[2q+1] for q = l + 32 m in its registers m < R.
// With k = k1 + R k2, Z[k] = sum_l W_32^{l k2} W_H^{l k1} sum_m W_R^{m k1}
// z[l + 32 m]: an R-point DIF in each lane's registers (register r then
// holds k1 = bitrev(r)), the twiddle W_H^{l k1}, and a 32-point DIF across
// the lanes by shuffles (lane l then holds k2 = bitrev(l)).  tw holds W_N^t
// for t < N, then W_64^j for j < 64; the per-lane twiddles are derived from
// a few loads of it, so a warp's loads touch few L1 lines.  The window and
// the mel bands are read through L1 too.
template <int R>
__global__ void __launch_bounds__(256)
fbank_fft_kernel(const float* __restrict__ frames, int T, int ws,
                 const float2* __restrict__ tw,
                 const float* __restrict__ win,
                 const int* __restrict__ bd, const float* __restrict__ bw,
                 int M, float preemph, int remove_dc, int vec,
                 float* __restrict__ out, float* __restrict__ energy) {
  constexpr int N = 64 * R, H = 32 * R;
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * (blockDim.x >> 5) + warp;
  if (t >= T) return;
  float* pw = reinterpret_cast<float*>(smem4) + warp * fft_pw_floats(H);

  // the frame: lane l, register m holds samples 2q and 2q + 1, q = l + 32 m
  // (a warp request reads 256 contiguous bytes); past ws, zeros
  const float* fr = frames + (size_t)t * ws;
  float re[R], im[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int i = 2 * (lane + 32 * m);
    re[m] = im[m] = 0.f;
    if (vec && i < ws) {
      const float2 v = __ldcs(reinterpret_cast<const float2*>(fr + i));
      re[m] = v.x;
      im[m] = v.y;
    } else if (!vec) {
      if (i < ws) re[m] = __ldcs(fr + i);
      if (i + 1 < ws) im[m] = __ldcs(fr + i + 1);
    }
  }

  // DC removal and raw energy over the ws samples
  float s = 0.f;
#pragma unroll
  for (int m = 0; m < R; ++m) s += re[m] + im[m];
  const float mean = remove_dc ? warp_sum(s) / (float)ws : 0.f;
  float e = 0.f;
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int i = 2 * (lane + 32 * m);
    if (i < ws) re[m] -= mean;
    if (i + 1 < ws) im[m] -= mean;
    e = fmaf(re[m], re[m], fmaf(im[m], im[m], e));
  }
  e = warp_sum(e);
  if (lane == 0) energy[t] = logf(fmaxf(e, kEpsilon));

  // pre-emphasis (sample 0 is its own predecessor) and the window: the
  // predecessor of sample 2q is sample 2q - 1, lane l - 1's odd sample, or
  // for lane 0 lane 31's of register m - 1
  float prev[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const float up = __shfl_up_sync(kFull, im[m], 1);
    const float wrap = __shfl_sync(kFull, im[m > 0 ? m - 1 : 0], 31);
    prev[m] = lane > 0 ? up : (m > 0 ? wrap : re[0]);
  }
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int i = 2 * (lane + 32 * m);
    float2 w = make_float2(0.f, 0.f);
    if (vec && i < ws) {
      w = __ldg(reinterpret_cast<const float2*>(win + i));
    } else if (!vec) {
      if (i < ws) w.x = __ldg(win + i);
      if (i + 1 < ws) w.y = __ldg(win + i + 1);
    }
    const float a = (re[m] - preemph * prev[m]) * w.x;
    im[m] = (im[m] - preemph * re[m]) * w.y;
    re[m] = a;
  }

  // R-point DIF in the registers, then the twiddle W_H^{l k1}
  if constexpr (R > 1) {
    dif_registers<R, R / 2>(re, im, tw);
    float2 pow[R];
    pow[0] = make_float2(1.f, 0.f);
    pow[1] = __ldg(tw + 2 * lane);                // W_H^l = W_N^{2l}
#pragma unroll
    for (int j = 2; j < R; ++j) pow[j] = cmul(pow[j - 1], pow[1]);
    twiddle_registers(re, im, pow, std::make_integer_sequence<int, R>());
  }

  // 32-point DIF across the lanes: at distance d the lower lane keeps
  // a + b, the upper (a - b) W_{2d}^{l mod d} = W_64^{(l mod d) 32 / d}
#pragma unroll
  for (int step = 0; step < 5; ++step) {
    const int d = 16 >> step;
    const bool upper = lane & d;
    const float sign = upper ? -1.f : 1.f;        // b + a, or b - a
    const float2 w = upper ? __ldg(tw + N + (lane & (d - 1)) * (32 / d))
                           : make_float2(1.f, 0.f);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float sr = fmaf(sign, re[r], __shfl_xor_sync(kFull, re[r], d));
      const float si = fmaf(sign, im[r], __shfl_xor_sync(kFull, im[r], d));
      if (d == 1) {                               // W_2^0 = 1
        re[r] = sr;
        im[r] = si;
      } else {
        re[r] = sr * w.x - si * w.y;
        im[r] = sr * w.y + si * w.x;
      }
    }
  }

  // the power spectrum; bin H is (Re Z[0] - Im Z[0])^2
  power_registers(re, im, lane, tw, pw, std::make_integer_sequence<int, R>());
  if (lane == 0) {
    const float x = re[0] - im[0];
    pw[H + (H >> 5)] = x * x;
  }
  __syncwarp();

  // mel: one lane a bin, over its band only; the weights are [len][M], so
  // the lanes of a warp read one line a step
  for (int m = lane; m < M; m += 32) {
    const int first = __ldg(bd + m), len = __ldg(bd + M + m);
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < len; ++j) {
      const int k = first + j;
      acc = fmaf(pw[k + (k >> 5)], __ldg(bw + j * M + m), acc);
    }
    out[(size_t)t * M + m] = logf(fmaxf(acc, kEpsilon));
  }
}

// ---- the mixed-radix FFT for N = 50 L (L = 2 .. 32 lanes a frame) ----
//
// Z = FFT(z) over the H = N / 2 = 25 L packed points, q = l + L m held by
// lane l < L of the frame's group in register m < 25.  With k = k1 + 25 k2,
// Z[k] = sum_l W_L^{l k2} W_H^{l k1} sum_m W_25^{m k1} z[l + L m]: a
// 25-point DFT in each lane's registers (5 x 5, radix-5 butterflies on
// constants), the twiddle W_H^{l k1}, and an L-point radix-2 DIF across the
// group's lanes by __shfl_xor_sync (lane l then holds k2 = bitrev(l)).

constexpr int kP = 25;            // points of a lane's in-register DFT
// cos and sin of 2 pi / 5 and 4 pi / 5
constexpr float kC1 = 0.30901699437494742f;
constexpr float kC2 = -0.80901699437494742f;
constexpr float kS1 = 0.95105651629515357f;
constexpr float kS2 = 0.58778525229247313f;

// After the 25-point DFT register r = 5 c + d holds bin k1 = c + 5 d.
__host__ __device__ constexpr int mixed_bin(int r) { return r / 5 + 5 * (r % 5); }
__host__ __device__ constexpr int mixed_reg(int k1) {
  return 5 * (k1 % 5) + k1 / 5;
}

// Floats of shared memory a frame: bins 0..H, and a stride of L modulo 32,
// so that the F = 32 / L frames of a warp store bin k1 + 25 k2 of their
// lanes to 32 different banks (25 k2 modulo L is a permutation of k2).
__host__ __device__ constexpr int mixed_pw_stride(int L) {
  return 25 * L + 1 + (((L - 25 * L - 1) % 32) + 32) % 32;
}

// The 5-point DFT (W_5 = exp(-2 pi i / 5)) of z[I0 + S j], j < 5, in place.
template <int I0, int S>
__device__ __forceinline__ void dft5(float2 (&z)[kP]) {
  const float2 a0 = z[I0], a1 = z[I0 + S], a2 = z[I0 + 2 * S];
  const float2 a3 = z[I0 + 3 * S], a4 = z[I0 + 4 * S];
  const float t1x = a1.x + a4.x, t1y = a1.y + a4.y;
  const float t2x = a2.x + a3.x, t2y = a2.y + a3.y;
  const float t3x = a1.x - a4.x, t3y = a1.y - a4.y;
  const float t4x = a2.x - a3.x, t4y = a2.y - a3.y;
  z[I0] = make_float2(a0.x + t1x + t2x, a0.y + t1y + t2y);
  const float b1x = a0.x + kC1 * t1x + kC2 * t2x;
  const float b1y = a0.y + kC1 * t1y + kC2 * t2y;
  const float b2x = a0.x + kC2 * t1x + kC1 * t2x;
  const float b2y = a0.y + kC2 * t1y + kC1 * t2y;
  const float ux = kS1 * t3x + kS2 * t4x, uy = kS1 * t3y + kS2 * t4y;
  const float vx = kS2 * t3x - kS1 * t4x, vy = kS2 * t3y - kS1 * t4y;
  z[I0 + S] = make_float2(b1x + uy, b1y - ux);          // b1 - i u
  z[I0 + 4 * S] = make_float2(b1x - uy, b1y + ux);      // b1 + i u
  z[I0 + 2 * S] = make_float2(b2x + vy, b2y - vx);      // b2 - i v
  z[I0 + 3 * S] = make_float2(b2x - vy, b2y + vx);      // b2 + i v
}

// The 25-point DFT of a lane's registers, m = 5 a + b -> k1 = c + 5 d:
// 5-point DFTs over a (register 5 c + b then holds frequency c), the
// twiddle W_25^{b c} = W_N^{2 L b c}, 5-point DFTs over b (register 5 c + d
// then holds k1 = c + 5 d).
template <int L>
__device__ __forceinline__ void dft25(float2 (&z)[kP],
                                      const float2* __restrict__ tw) {
  dft5<0, 5>(z);
  dft5<1, 5>(z);
  dft5<2, 5>(z);
  dft5<3, 5>(z);
  dft5<4, 5>(z);
#pragma unroll
  for (int c = 1; c < 5; ++c) {
#pragma unroll
    for (int b = 1; b < 5; ++b)
      z[5 * c + b] = cmul(z[5 * c + b], __ldg(tw + 2 * L * b * c));
  }
  dft5<0, 1>(z);
  dft5<5, 1>(z);
  dft5<10, 1>(z);
  dft5<15, 1>(z);
  dft5<20, 1>(z);
}

// The real-FFT post-pass, as power_registers: bin k = k1 + 25 k2 of lane l
// (k2 = bitrev(l)) from Z[k] and conj Z[H - k], which register
// mixed_reg(25 - k1) of lane l ^ (L - 1) holds (k1 > 0), or register 0 of
// lane bitrev(L - k2) (k1 = 0); its power goes to pw[k].
template <int L, int... rs>
__device__ __forceinline__ void power_mixed(const float2 (&z)[kP], int l,
                                            const float2* __restrict__ tw,
                                            float* pw,
                                            std::integer_sequence<int, rs...>) {
  constexpr int LB = log2_exact(L);
  const int k2 = __brev(l) >> (32 - LB);
  const int k2_mirror = __brev((L - k2) & (L - 1)) >> (32 - LB);
  (
      [&] {
        constexpr int k1 = mixed_bin(rs);
        constexpr int rp = k1 ? mixed_reg(kP - k1) : 0;
        const int src = k1 ? l ^ (L - 1) : k2_mirror;
        const float br = __shfl_sync(kFull, z[rp].x, src, L);
        const float bi = __shfl_sync(kFull, z[rp].y, src, L);
        const float ex = 0.5f * (z[rs].x + br), ey = 0.5f * (z[rs].y - bi);
        const float ox = 0.5f * (z[rs].y + bi), oy = -0.5f * (z[rs].x - br);
        const int k = k1 + kP * k2;
        const float2 w = __ldg(tw + k);
        const float xr = ex + w.x * ox - w.y * oy;
        const float xi = ey + w.x * oy + w.y * ox;
        pw[k] = xr * xr + xi * xi;
      }(),
      ...);
}

// L lanes a frame, F = 32 / L frames a warp, the H = 25 L packed points of
// a frame in its lanes' registers: lane l holds z[q] = x[2q] + i x[2q+1]
// for q = l + L m in register m < 25.  The front end (DC removal, energy,
// pre-emphasis, window) is the power-of-two kernel's with sums and
// neighbours over the frame's group of lanes; the mel stage gives each
// lane one (frame, bin) of its warp at a time.  tw holds W_N^t, t < N.
template <int L>
__global__ void __launch_bounds__(256)
fbank_mixed_kernel(const float* __restrict__ frames, int T, int ws,
                   const float2* __restrict__ tw,
                   const float* __restrict__ win,
                   const int* __restrict__ bd, const float* __restrict__ bw,
                   int M, float preemph, int remove_dc, int vec,
                   float* __restrict__ out, float* __restrict__ energy) {
  constexpr int H = kP * L, F = 32 / L, LB = log2_exact(L);
  constexpr int S = mixed_pw_stride(L);
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int l = lane & (L - 1);
  const int t0 = (blockIdx.x * (blockDim.x >> 5) + warp) * F;
  if (t0 >= T) return;
  const int t = t0 + lane / L;
  const bool valid = t < T;
  float* pw = reinterpret_cast<float*>(smem4) + warp * F * S;

  // the frame; past ws (and for a frame past T) zeros
  const float* fr = frames + (size_t)t * ws;
  float2 z[kP];
#pragma unroll
  for (int m = 0; m < kP; ++m) {
    const int i = 2 * (l + L * m);
    z[m] = make_float2(0.f, 0.f);
    if (!valid) continue;
    if (vec && i < ws) {
      z[m] = __ldcs(reinterpret_cast<const float2*>(fr + i));
    } else if (!vec) {
      if (i < ws) z[m].x = __ldcs(fr + i);
      if (i + 1 < ws) z[m].y = __ldcs(fr + i + 1);
    }
  }

  // DC removal and raw energy over the ws samples (sums over the group)
  float s = 0.f;
#pragma unroll
  for (int m = 0; m < kP; ++m) s += z[m].x + z[m].y;
#pragma unroll
  for (int o = L / 2; o > 0; o /= 2) s += __shfl_xor_sync(kFull, s, o);
  const float mean = remove_dc ? s / (float)ws : 0.f;
  float e = 0.f;
#pragma unroll
  for (int m = 0; m < kP; ++m) {
    const int i = 2 * (l + L * m);
    if (i < ws) z[m].x -= mean;
    if (i + 1 < ws) z[m].y -= mean;
    e = fmaf(z[m].x, z[m].x, fmaf(z[m].y, z[m].y, e));
  }
#pragma unroll
  for (int o = L / 2; o > 0; o /= 2) e += __shfl_xor_sync(kFull, e, o);
  if (l == 0 && valid) energy[t] = logf(fmaxf(e, kEpsilon));

  // pre-emphasis and the window: the predecessor of sample 2q is lane
  // l - 1's odd sample, or for lane 0 lane L - 1's of register m - 1
  float prev[kP];
#pragma unroll
  for (int m = 0; m < kP; ++m) {
    const float up = __shfl_up_sync(kFull, z[m].y, 1, L);
    const float wrap = __shfl_sync(kFull, z[m > 0 ? m - 1 : 0].y, L - 1, L);
    prev[m] = l > 0 ? up : (m > 0 ? wrap : z[0].x);
  }
#pragma unroll
  for (int m = 0; m < kP; ++m) {
    const int i = 2 * (l + L * m);
    float2 w = make_float2(0.f, 0.f);
    if (vec && i < ws) {
      w = __ldg(reinterpret_cast<const float2*>(win + i));
    } else if (!vec) {
      if (i < ws) w.x = __ldg(win + i);
      if (i + 1 < ws) w.y = __ldg(win + i + 1);
    }
    const float a = (z[m].x - preemph * prev[m]) * w.x;
    z[m].y = (z[m].y - preemph * z[m].x) * w.y;
    z[m].x = a;
  }

  // the 25-point DFT in the registers, then the twiddle W_H^{l k1} =
  // W_N^{2 l k1} (2 l k1 <= 48 (L - 1) < N)
  dft25<L>(z, tw);
#pragma unroll
  for (int r = 0; r < kP; ++r)
    if (mixed_bin(r)) z[r] = cmul(z[r], __ldg(tw + 2 * l * mixed_bin(r)));

  // L-point DIF across the group's lanes: at distance d the lower lane
  // keeps a + b, the upper (a - b) W_{2d}^{l mod d} = W_N^{(l mod d) 25 L / d}
#pragma unroll
  for (int step = 0; step < LB; ++step) {
    const int d = (L / 2) >> step;
    const bool upper = l & d;
    const float sign = upper ? -1.f : 1.f;
    const float2 w = upper ? __ldg(tw + (l & (d - 1)) * (kP * L / d))
                           : make_float2(1.f, 0.f);
#pragma unroll
    for (int r = 0; r < kP; ++r) {
      const float sr = fmaf(sign, z[r].x, __shfl_xor_sync(kFull, z[r].x, d));
      const float si = fmaf(sign, z[r].y, __shfl_xor_sync(kFull, z[r].y, d));
      z[r] = d == 1 ? make_float2(sr, si) : cmul(make_float2(sr, si), w);
    }
  }

  // the power spectrum; bin H is (Re Z[0] - Im Z[0])^2
  float* pwf = pw + (lane / L) * S;
  power_mixed<L>(z, l, tw, pwf, std::make_integer_sequence<int, kP>());
  if (l == 0) {
    const float x = z[0].x - z[0].y;
    pwf[H] = x * x;
  }
  __syncwarp();

  // mel: one lane a (frame, bin) of the warp, over the bin's band only;
  // the warp's outputs are contiguous
  for (int j = lane; j < F * M; j += 32) {
    const int f = j / M, m = j - f * M;
    if (t0 + f >= T) break;
    const float* p = pw + f * S;
    const int first = __ldg(bd + m), len = __ldg(bd + M + m);
    float acc = 0.f;
#pragma unroll 4
    for (int jj = 0; jj < len; ++jj)
      acc = fmaf(p[first + jj], __ldg(bw + jj * M + m), acc);
    out[(size_t)t0 * M + j] = logf(fmaxf(acc, kEpsilon));
  }
}

template <int L>
int launch_mixed(const float* frames, int T, int ws, const float* twiddle,
                 const float* window, const int* bands, const float* band_w,
                 int M, float preemph, int remove_dc, float* out,
                 float* energy, cudaStream_t stream) {
  constexpr int kWarps = 8, F = 32 / L;
  const int vec =
      ws % 2 == 0 && ((uintptr_t)frames | (uintptr_t)window) % 8 == 0;
  const size_t smem = sizeof(float) * kWarps * F * mixed_pw_stride(L);
  const int blocks = (T + kWarps * F - 1) / (kWarps * F);
  fbank_mixed_kernel<L><<<blocks, 32 * kWarps, smem, stream>>>(
      frames, T, ws, reinterpret_cast<const float2*>(twiddle), window, bands,
      band_w, M, preemph, remove_dc, vec, out, energy);
  return (int)cudaGetLastError();
}

template <int R>
int launch_fft(const float* frames, int T, int ws, const float* twiddle,
               const float* window, const int* bands, const float* band_w,
               int M, float preemph, int remove_dc, float* out,
               float* energy, cudaStream_t stream) {
  constexpr int kWarps = 8;
  const int vec =
      ws % 2 == 0 && ((uintptr_t)frames | (uintptr_t)window) % 8 == 0;
  const size_t smem = sizeof(float) * kWarps * fft_pw_floats(32 * R);
  fbank_fft_kernel<R><<<(T + kWarps - 1) / kWarps, 32 * kWarps, smem,
                        stream>>>(
      frames, T, ws, reinterpret_cast<const float2*>(twiddle), window, bands,
      band_w, M, preemph, remove_dc, vec, out, energy);
  return (int)cudaGetLastError();
}

}  // namespace

// frames [T, ws]; cos_t, sin_t [n >= ws, nb]; mel [M, nb]; window [ws];
// out [T, M]; energy [T].  Returns the launch's cudaError_t.
extern "C" int kcnn_fbank(const float* frames, int T, int ws,
                          const float* cos_t, const float* sin_t, int nb,
                          const float* mel, int M, const float* window,
                          float preemph, int remove_dc, float* out,
                          float* energy, void* stream) {
  if (T <= 0) return (int)cudaSuccess;
  int threads = ((nb + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (threads < 64) threads = 64;
  const size_t smem = sizeof(float) * (size_t)FPB * (((ws + 3) & ~3) + nb);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fbank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (T + FPB - 1) / FPB;
  fbank_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      frames, T, ws, cos_t, sin_t, nb, mel, M, window, preemph, remove_dc,
      out, energy);
  return (int)cudaGetLastError();
}

// frames [T, ws]; n = padded_window_size, a power of two in [64, 2048] with
// ws <= n; twiddle [n + 64] complex (re, im): exp(-2 pi i t / n) for t < n,
// then exp(-2 pi i j / 64) for j < 64; window [ws];
// bands [2][M] (first bin, length); band_w [L][M], L the longest band, the
// weight of filter m at bin first + j in row j (zero past its length); out
// [T, M]; energy [T].  Returns the launch's cudaError_t
// (cudaErrorInvalidValue for sizes it does not take).
extern "C" int kcnn_fbank_fft(const float* frames, int T, int ws, int n,
                              const float* twiddle, const float* window,
                              const int* bands, const float* band_w, int M,
                              float preemph, int remove_dc,
                              float* out, float* energy, void* stream) {
  if (n < 64 || n > 2048 || (n & (n - 1)) || ws <= 0 || ws > n || M <= 0)
    return (int)cudaErrorInvalidValue;
  if (T <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
#define KCNN_FFT_CASE(R)                                                   \
  case 64 * R:                                                             \
    return launch_fft<R>(frames, T, ws, twiddle, window, bands, band_w, M, \
                         preemph, remove_dc, out, energy, st);
    KCNN_FFT_CASE(1)
    KCNN_FFT_CASE(2)
    KCNN_FFT_CASE(4)
    KCNN_FFT_CASE(8)
    KCNN_FFT_CASE(16)
    KCNN_FFT_CASE(32)
#undef KCNN_FFT_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// The mixed-radix FFT kernel, with kcnn_fbank_fft's arguments, for n = 50 L,
// L a power of two from 2 to 32 (100, 200, 400, 800, 1600: Kaldi's 25 ms
// frames at 8 and 16 kHz with round_to_power_of_two off are 200 and 400);
// twiddle [n] complex exp(-2 pi i t / n), t < n (the power-of-two kernel's
// table less its W_64 tail may be passed).  Returns the launch's cudaError_t
// (cudaErrorInvalidValue for sizes it does not take).
extern "C" int kcnn_fbank_fft_mixed(const float* frames, int T, int ws, int n,
                                    const float* twiddle, const float* window,
                                    const int* bands, const float* band_w,
                                    int M, float preemph, int remove_dc,
                                    float* out, float* energy, void* stream) {
  if (n % 50 || ws <= 0 || ws > n || M <= 0) return (int)cudaErrorInvalidValue;
  if (T <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n / 50) {
#define KCNN_MIXED_CASE(L)                                                    \
  case L:                                                                     \
    return launch_mixed<L>(frames, T, ws, twiddle, window, bands, band_w, M, \
                           preemph, remove_dc, out, energy, st);
    KCNN_MIXED_CASE(2)
    KCNN_MIXED_CASE(4)
    KCNN_MIXED_CASE(8)
    KCNN_MIXED_CASE(16)
    KCNN_MIXED_CASE(32)
#undef KCNN_MIXED_CASE
  }
  return (int)cudaErrorInvalidValue;
}
