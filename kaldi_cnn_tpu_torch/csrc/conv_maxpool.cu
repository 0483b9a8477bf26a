// Fused stride-1 VALID Conv2D + bias (+ ReLU) + max-pool over time x freq.
//
// Replaces the TPU kernel kaldi_cnn_tpu/ops/conv_pallas.py::_implicit_kernel
// (entry point conv2d_maxpool_implicit): Conv2DComponent followed by
// Maxpooling3DComponent with pool_c = 1, for inference.  Input rows are
// flattened (t, f, c) volumes, index (t * in_f + f) * in_c + c; the filter
// matrix is w [F, K] with K = filt_t * filt_f * in_c in (dt, df, c) order;
// output rows are [(out_t / pool_t) * (out_f / pool_f) * F] in
// (ot', of', filter) order.  With bf16 = 1 both operands are rounded to
// bfloat16 (round to nearest even) and the products are accumulated in
// f32, which is what the Pallas kernel computes by default; the bias is
// added in f32.
//
// What bounds it on an H100: 2 * out_t * out_f * K * F flops per row
// (21 GFLOP at mb 4096, F = 128) against 4 * (in_dim + pooled_dim) bytes
// per row of device memory, so it is compute-bound.  This version runs on
// the CUDA cores in f32 (no wgmma, no TMA).  Like the TPU kernel it never
// writes the conv output to device memory: the im2col patch of an output
// position is read straight out of the input row staged in shared memory
// (the (df, c) window of a filter tap dt is a contiguous run of
// filt_f * in_c values), and the max over the pool window is taken in
// registers.
//
// Layout: a block stages ROWS input rows and the transposed filter matrix
// wt [K][F] in shared memory.  A thread's work item is one pooled output
// position of one row for TN = 8 consecutive filters: a register tile of
// TM conv positions of the pool window x TN filters, so each k step loads
// TM inputs and two float4 weights from shared memory for TM * TN FMAs
// (the implicit-GEMM register blocking that keeps the loop on the FMA
// units instead of on shared-memory loads).  Neighbouring lanes take
// neighbouring filter groups of the same position: their weight loads are
// contiguous and their input loads are broadcasts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 8;                 // rows staged per block
constexpr int kThreads = 256;
constexpr int TN = 8;                   // filters per work item
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// TM divides pool_t * pool_f: the window's conv positions are computed
// TM at a time.
template <int TM>
__global__ void conv_maxpool_kernel(const float* __restrict__ x, int N,
                                    const float* __restrict__ w,
                                    const float* __restrict__ b, int in_t,
                                    int in_f, int in_c, int filt_t,
                                    int filt_f, int F, int pool_t, int pool_f,
                                    int relu, int bf16,
                                    float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = in_t * in_f * in_c;
  const int fc = filt_f * in_c;
  const int K = filt_t * fc;
  float* xs = smem;                                  // [ROWS][D]
  float* wt = smem + ((ROWS * D + 3) & ~3);          // [K][F], 16B aligned
  const int n0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, N - n0);

  for (int i = threadIdx.x; i < ROWS * D; i += blockDim.x) {
    const int r = i / D;
    float v = (r < nrows) ? x[(size_t)n0 * D + i] : 0.f;
    xs[i] = bf16 ? to_bf16(v) : v;
  }
  for (int i = threadIdx.x; i < K * F; i += blockDim.x) {
    const int k = i / F, f = i - k * F;
    const float v = w[(size_t)f * K + k];
    wt[i] = bf16 ? to_bf16(v) : v;
  }
  __syncthreads();

  const int out_t = in_t - filt_t + 1, out_f = in_f - filt_f + 1;
  const int opt = out_t / pool_t, opf = out_f / pool_f;
  const int npos = opt * opf, groups = F / TN, pw = pool_t * pool_f;
  const int row_stride = in_f * in_c;                // one time step
  const int items = nrows * npos * groups;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int g = item % groups;
    const int pp = (item / groups) % npos;
    const int r = item / (groups * npos);
    const int otp = pp / opf, ofp = pp - otp * opf;
    const float* xr = xs + r * D;
    const float* wg = wt + g * TN;
    float m[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) m[j] = -__int_as_float(0x7f800000);  // -inf
    for (int w0 = 0; w0 < pw; w0 += TM) {
      int xo[TM];                      // input offset of each conv position
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int pt = (w0 + i) / pool_f, pf = (w0 + i) - pt * pool_f;
        xo[i] = ((otp * pool_t + pt) * in_f + ofp * pool_f + pf) * in_c;
      }
      float acc[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
      for (int dt = 0; dt < filt_t; ++dt) {
        const float* xp = xr + dt * row_stride;
        const float* wp = wg + dt * fc * F;
        for (int q = 0; q < fc; ++q) {
          const float4 wa = *reinterpret_cast<const float4*>(wp + q * F);
          const float4 wb = *reinterpret_cast<const float4*>(wp + q * F + 4);
          const float wv[TN] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float xv = xp[xo[i] + q];
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) m[j] = fmaxf(m[j], acc[i][j]);
    }
    // bias is the same across the window and relu is monotone, so both
    // commute with the max
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      m[j] += b[g * TN + j];
      if (relu) m[j] = fmaxf(m[j], 0.f);
    }
    float* op = out + ((size_t)(n0 + r) * npos + pp) * F + g * TN;
    reinterpret_cast<float4*>(op)[0] = make_float4(m[0], m[1], m[2], m[3]);
    reinterpret_cast<float4*>(op)[1] = make_float4(m[4], m[5], m[6], m[7]);
  }
}

template <int TM>
int launch(const float* x, int N, const float* w, const float* b, int in_t,
           int in_f, int in_c, int filt_t, int filt_f, int F, int pool_t,
           int pool_f, int relu, int bf16, float* out, cudaStream_t stream) {
  const int D = in_t * in_f * in_c;
  const int K = filt_t * filt_f * in_c;
  const size_t smem =
      sizeof(float) * ((size_t)((ROWS * D + 3) & ~3) + (size_t)K * F);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_maxpool_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (N + ROWS - 1) / ROWS;
  conv_maxpool_kernel<TM><<<blocks, kThreads, smem, stream>>>(
      x, N, w, b, in_t, in_f, in_c, filt_t, filt_f, F, pool_t, pool_f, relu,
      bf16, out);
  return (int)cudaGetLastError();
}

}  // namespace

// x [N, in_t*in_f*in_c]; w [F, filt_t*filt_f*in_c]; b [F];
// out [N, (out_t/pool_t)*(out_f/pool_f)*F].  Returns the launch's
// cudaError_t (cudaErrorInvalidValue when the staged tile does not fit in
// shared memory, a pool size does not divide the conv output, or F is not
// a multiple of 8).
extern "C" int kcnn_conv_maxpool(const float* x, int N, const float* w,
                                 const float* b, int in_t, int in_f, int in_c,
                                 int filt_t, int filt_f, int F, int pool_t,
                                 int pool_f, int relu, int bf16, float* out,
                                 void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  const int out_t = in_t - filt_t + 1, out_f = in_f - filt_f + 1;
  if (out_t <= 0 || out_f <= 0 || pool_t <= 0 || pool_f <= 0 ||
      out_t % pool_t || out_f % pool_f || F <= 0)
    return (int)cudaErrorInvalidValue;
  if (F % TN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int pw = pool_t * pool_f;
#define KCNN_CONV(TM)                                                        \
  return launch<TM>(x, N, w, b, in_t, in_f, in_c, filt_t, filt_f, F, pool_t, \
                    pool_f, relu, bf16, out, s)
  if (pw % 8 == 0) KCNN_CONV(8);
  if (pw % 6 == 0) KCNN_CONV(6);
  if (pw % 4 == 0) KCNN_CONV(4);
  if (pw % 3 == 0) KCNN_CONV(3);
  if (pw % 2 == 0) KCNN_CONV(2);
  KCNN_CONV(1);
#undef KCNN_CONV
}
