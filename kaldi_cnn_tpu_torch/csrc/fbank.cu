// Fused log-mel filterbank over a batch of raw frames.
//
// Replaces the TPU kernel kaldi_cnn_tpu/ops/fbank_pallas.py::_fbank_kernel.
// Per frame: DC-offset removal over the window_size valid samples, raw log
// energy, pre-emphasis (sample 0 is its own predecessor), analysis window,
// real DFT as two sums against the cos/sin tables of
// features.functional.dft_matrices, power, mel sums against the
// mel_banks table, log floored at FLT_EPSILON.  Dither is added to the
// frames before the kernel; energy flooring and use_energy stay in the
// wrapper (ops/fbank.py).
//
// What bounds it on an H100: the DFT is 2 * window_size * num_fft_bins
// FMAs per frame on the CUDA cores (f32, no tensor cores) and reads the
// same cos/sin tables for every frame.  The tables (2 x 512 x 257 f32 =
// 1 MB at 16 kHz) stay in L2; the design makes each table element fetched
// by a block serve FPB frames held in shared memory, so table traffic is
// cut FPB-fold, and reads the frames four samples at a time (one float4
// broadcast per frame for 8 FMAs), so the loop is FMA-bound rather than
// bound by shared-memory loads.  One thread per DFT bin keeps the table
// reads coalesced (neighbouring bins are neighbouring columns).  The
// per-frame reductions use one warp per frame.
#include <cuda_runtime.h>

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
