// Fused stride-1 VALID Conv2D + bias (+ ReLU) + max-pool over time x freq,
// for inference.  Two kernels, one for each operand type.
//
// Replaces the TPU kernel kaldi_cnn_tpu/ops/conv_pallas.py::_implicit_kernel
// (entry point conv2d_maxpool_implicit): Conv2DComponent followed by
// Maxpooling3DComponent with pool_c = 1.  Input rows are flattened (t, f, c)
// volumes, index (t * in_f + f) * in_c + c; the filter matrix is w [F, K]
// with K = filt_t * filt_f * in_c in (dt, df, c) order; output rows are
// [(out_t / pool_t) * (out_f / pool_f) * F] in (ot', of', filter) order.
// Bias is the same across a pool window and ReLU is monotone, so both are
// applied after the max.  Like the TPU kernel, neither kernel writes the
// conv output to device memory.
//
// kcnn_conv_maxpool_wgmma: bf16 operands, f32 sums (the Pallas default and
// the serving path's mode), on the tensor cores with wgmma.
//
//   What bounds it on an H100: at the bench shape (ConvnetConfig(), F = 128,
//   4096 rows) 21.1 GFLOP, 0.021 ms at the 989 TFLOP/s bf16 peak, against
//   19.5 MB read and 84 MB of pooled f32 written, 0.031 ms at 3.35 TB/s:
//   device memory.  The CUDA-core kernel below did the same products as f32
//   FMAs in 0.67 ms.
//
//   Design.  The GEMM is the Pallas kernel's: M = 64 batch rows for one conv
//   position, N = the filters, K = the patch (84 at the recipe's shape),
//   zero-padded to a multiple of 16 (96: six k16 steps).  A block is one
//   warpgroup and persists over work items.  An item is (64-row tile, pooled
//   time row, part of the pooled freq positions): 4096 rows are only 64
//   tiles, fewer than the 132 SMs.
//   - B (w^T, rounded to bf16, zero-padded in K and N) stays in shared
//     memory for the block's life, in the no-swizzle K-major layout of 8 x 8
//     core matrices.
//   - A comes from registers.  A thread loads the values of its fragment
//     from the item's input window in shared memory through a table of
//     k -> dt * window_width + q offsets and rounds them to bf16 as it packs
//     them.  The padded k of A are zeros in A itself, not reads of
//     neighbouring inputs: an inf there would give inf * 0 = NaN.  The k16
//     steps go out in groups of G (6 covers the recipe's K = 84 in one
//     group), and two fragment buffers let a thread load the next group
//     while the tensor cores run the current one.  A wgmma reads its A
//     registers asynchronously, so a buffer is refilled only after the
//     wait that covers the products that read it.
//   - The input window is the f32 rows of the item's pool_t + filt_t - 1
//     time steps over the freq columns its part needs, copied with cp.async
//     (16 B a copy when rows are 16-byte aligned).  The whole freq range
//     (64 x 5 x 108 f32, 138 KB at the recipe's shape) would leave one block
//     an SM; two freq parts cut the window to 84 KB, so two blocks fit.
//     An item copies its whole window and waits for it: nothing overlaps
//     the copy but the other block's work, and neighbouring pooled time
//     rows re-read 3 of their 5 steps, mostly from L2.  A ring of
//     time-step slabs that loads steps 2 otp + 5 and + 6 while the
//     products of row otp run was not tried: at two freq parts its 7
//     slabs take 115 KB, one block an SM; at four parts two blocks fit,
//     but the busiest SM then does 144 of the conv positions' products
//     instead of 120, for a copy that is about 17 % of an item.
//   - Each of the pool window's pool_t * pool_f conv positions is one
//     product into the same accumulator fragment, and the max is a
//     NaN-propagating max in registers, as the plain version's max.
//   - N is one wgmma of 16, 32, 64 or 128 filters (accumulator plus running
//     max: 128 registers a thread at 128); more filters loop over chunks of
//     128 with the window reused.
//   - The pooled tile is stored 16 B a lane: lane pairs swap halves of two
//     accumulator column groups with one shuffle.
//   A shape whose staged tiles do not fit in 227 KB of shared memory is
//   refused (cudaErrorInvalidValue), never run another way.
//
//   What holds it back: 239 registers a thread at N = 128 (ptxas, see
//   scripts/conv_wgmma_profile.py) and 109 KB of shared memory a block
//   leave two warpgroups an SM, too few to hide the latency of the
//   fragment loads, the products and the max, which a warpgroup runs one
//   after another; and the blocks of a wave stage their windows at the
//   same time, so nothing overlaps the copy.
//
// kcnn_conv_maxpool: f32 operands on the CUDA cores (TF32 would break the
// f32 bound against the plain version).  A block stages ROWS input rows and
// the transposed filter matrix wt [K][F] in shared memory; the patch of an
// output position is a strided view of the staged row.  A thread's work
// item is one pooled output position of one row for TN = 8 consecutive
// filters: a register tile of TM conv positions of the pool window x TN
// filters, so each k step loads TM inputs and two float4 weights from shared
// memory for TM * TN FMAs.  Neighbouring lanes take neighbouring filter
// groups of the same position: their weight loads are contiguous and their
// input loads are broadcasts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

namespace {

constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float neg_inf() {
  return -__int_as_float(0x7f800000);
}

// ---- f32 operands, CUDA cores ---------------------------------------------

constexpr int ROWS = 8;                 // rows staged per block
constexpr int kThreads = 256;
constexpr int TN = 8;                   // filters per work item

// TM divides pool_t * pool_f: the window's conv positions are computed
// TM at a time.
template <int TM>
__global__ void conv_maxpool_kernel(const float* __restrict__ x, int N,
                                    const float* __restrict__ w,
                                    const float* __restrict__ b, int in_t,
                                    int in_f, int in_c, int filt_t,
                                    int filt_f, int F, int pool_t, int pool_f,
                                    int relu, float* __restrict__ out) {
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
    xs[i] = (r < nrows) ? x[(size_t)n0 * D + i] : 0.f;
  }
  for (int i = threadIdx.x; i < K * F; i += blockDim.x) {
    const int k = i / F, f = i - k * F;
    wt[i] = w[(size_t)f * K + k];
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
    for (int j = 0; j < TN; ++j) m[j] = neg_inf();
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
           int pool_f, int relu, float* out, cudaStream_t stream) {
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
      out);
  return (int)cudaGetLastError();
}

// ---- bf16 operands, tensor cores (wgmma) ----------------------------------

constexpr int kRows = 64;               // wgmma M: batch rows of a tile
constexpr int kWgThreads = 128;         // one warpgroup a block
constexpr int kTwoBlockSmem = 113 * 1024;   // two blocks fit an SM

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16, A from registers, B from
// shared memory (K-major), D = A * B when scale_d is 0.
__device__ __forceinline__ void wgmma_n16(float* d, const uint32_t* a,
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n32(float* d, const uint32_t* a,
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t* a,
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t* a,
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

template <int NT>
__device__ __forceinline__ void wgmma(float* d, const uint32_t* a,
                                      uint64_t desc_b, int scale_d) {
  if constexpr (NT == 16) wgmma_n16(d, a, desc_b, scale_d);
  if constexpr (NT == 32) wgmma_n32(d, a, desc_b, scale_d);
  if constexpr (NT == 64) wgmma_n64(d, a, desc_b, scale_d);
  if constexpr (NT == 128) wgmma_n128(d, a, desc_b, scale_d);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// An operand register of an in-flight wgmma must not be touched before
// the wait that covers it: these keep the compiler from moving an access
// across the wait or giving the register to another value before it.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_operand(uint32_t (&a)[4]) {
  asm volatile("" : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])::"memory");
}

// max that returns NaN when either input is NaN (as torch's amax)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory matrix descriptor, no swizzle: start address, LBO (K
// direction: between the two 8-value halves of a k16 step) and SBO (N
// direction: between 8-filter core matrices), all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

// cp.async of 16 or 4 bytes; with valid false it writes zeros
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int unit, bool valid) {
  if (unit == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// window value at offset o; a negative offset is a padded k: zero
__device__ __forceinline__ float window_at(const float* p, int o) {
  return o >= 0 ? p[o] : 0.f;
}

struct Geom {
  int N, D, in_c, row_stride;   // rows, row length, one time step
  int fc, K;                    // filt_f * in_c, patch length
  int KS;                       // k16 steps, K padded to whole groups
  int F, F_pad;                 // filters, padded to whole N chunks
  int pool_t, pool_f, opt, opf; // pool window, pooled positions
  int TW;                       // time steps in a window
  int parts, per_part;          // freq parts, pooled freq positions each
  int Wc, P;                    // window columns a step, floats a row
  int unit;                     // floats a cp.async: 4 or 1
  int items;
};

size_t wgmma_smem(const Geom& g) {
  return (size_t)g.KS * 16 * g.F_pad * 2 + (size_t)g.F_pad * 4 +
         (size_t)g.KS * 64 + (size_t)kRows * g.P * 4;
}

template <int NT, int G>
__global__ void __launch_bounds__(kWgThreads) conv_maxpool_wgmma_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ b, Geom g, int relu, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kpad = g.KS * 16, ng = g.F_pad / 8;
  // bs [kpad / 8][ng][8 filters][8 k] bf16 core matrices, then the bias,
  // the fragment offset table [KS][4 lanes], and the window [64][P]
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* bias = reinterpret_cast<float*>(smem + (size_t)kpad * g.F_pad * 2);
  int4* koff = reinterpret_cast<int4*>(bias + g.F_pad);
  float* win = reinterpret_cast<float*>(koff + g.KS * 4);

  for (int i = threadIdx.x; i < kpad * g.F_pad; i += blockDim.x) {
    const int kr = i & 7, nr = (i >> 3) & 7, blk = i >> 6;
    const int n = (blk % ng) * 8 + nr, k = (blk / ng) * 8 + kr;
    bs[i] = __float2bfloat16_rn(n < g.F && k < g.K ? w[(size_t)n * g.K + k]
                                                   : 0.f);
  }
  for (int i = threadIdx.x; i < g.F_pad; i += blockDim.x)
    bias[i] = i < g.F ? b[i] : 0.f;
  // lane t of a quad holds k = 16s + 2t, +1, +8, +9 of step s
  for (int i = threadIdx.x; i < g.KS * 4; i += blockDim.x) {
    const int k0 = 16 * (i >> 2) + 2 * (i & 3);
    int o[4];
    const int ks[4] = {k0, k0 + 1, k0 + 8, k0 + 9};
    for (int j = 0; j < 4; ++j)
      o[j] = ks[j] < g.K ? (ks[j] / g.fc) * g.Wc + ks[j] % g.fc : -1;
    koff[i] = make_int4(o[0], o[1], o[2], o[3]);
  }
  // make the generic-proxy stores of B visible to wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int row0 = warp * 16 + (lane >> 2);   // this thread's rows: +0, +8
  const uint32_t bs_addr = smem_u32(bs);
  const int npos = g.opt * g.opf, nchunks = g.F_pad / NT;
  const int ngroups = g.KS / G;
  const bool odd = tq & 1;
  float acc[NT / 2], m[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;

  for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
    const int part = item % g.parts;
    const int otp = (item / g.parts) % g.opt;
    const int n0 = item / (g.parts * g.opt) * kRows;
    const int ofp_lo = part * g.per_part;
    const int ofp_hi = min(g.opf, ofp_lo + g.per_part);
    const int c_lo = ofp_lo * g.pool_f * g.in_c / g.unit * g.unit;
    const int nu = min(g.Wc, g.row_stride - c_lo) / g.unit;
    const int per_row = g.TW * nu;
    const float* src0 = x + (size_t)otp * g.pool_t * g.row_stride + c_lo;
    __syncthreads();                // the last item's window reads are done
    for (int i = threadIdx.x; i < kRows * per_row; i += blockDim.x) {
      const int r = i / per_row, rem = i - r * per_row;
      const int tl = rem / nu, u = (rem - tl * nu) * g.unit;
      const bool valid = n0 + r < g.N;
      copy_async(win + r * g.P + tl * g.Wc + u,
                 valid ? src0 + (size_t)(n0 + r) * g.D + tl * g.row_stride + u
                       : x,
                 g.unit, valid);
    }
    copy_async_wait();
    __syncthreads();

    for (int c = 0; c < nchunks; ++c) {
      const uint32_t b_chunk = bs_addr + c * (NT / 8) * 128;
      for (int ofp = ofp_lo; ofp < ofp_hi; ++ofp) {
        const float* wbase =
            win + row0 * g.P + ofp * g.pool_f * g.in_c - c_lo;
        // Stage st = (conv position p of the pool window, group of G k16
        // steps).  Lane tq of a quad holds k = 16s + 2tq, +1 (a[0] row +0,
        // a[1] row +8) and k + 8, +9 (a[2], a[3]) of step s.
        auto release = [&](uint32_t (&a)[G][4]) {
#pragma unroll
          for (int j = 0; j < G; ++j) fence_operand(a[j]);
        };
        auto load = [&](uint32_t (&a)[G][4], int st) {
          const int p = st / ngroups, s0 = (st - p * ngroups) * G;
          const int pt = p / g.pool_f, pf = p - pt * g.pool_f;
          const float* w0 = wbase + pt * g.Wc + pf * g.in_c;
          const float* w1 = w0 + 8 * g.P;
#pragma unroll
          for (int j = 0; j < G; ++j) {
            const int4 o = koff[(s0 + j) * 4 + tq];
            a[j][0] = pack_bf16(window_at(w0, o.x), window_at(w0, o.y));
            a[j][1] = pack_bf16(window_at(w1, o.x), window_at(w1, o.y));
            a[j][2] = pack_bf16(window_at(w0, o.z), window_at(w0, o.w));
            a[j][3] = pack_bf16(window_at(w1, o.z), window_at(w1, o.w));
          }
          release(a);     // the packs stay before the wgmma.fence
        };
        auto mma = [&](uint32_t (&a)[G][4], int st) {
          const int s0 = st % ngroups * G;
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < G; ++j)
            wgmma<NT>(acc, a[j],
                      smem_desc(b_chunk + 2 * (s0 + j) * ng * 128, ng * 128,
                                128),
                      s0 + j);
          wgmma_commit();
        };
        // a stage that ends a conv position: wait for its products and
        // take the max into m
        auto finish = [&](int st) {
          if ((st + 1) % ngroups) return;
          wgmma_wait<0>();
#pragma unroll
          for (int i = 0; i < NT / 2; ++i) {
            fence_operand(acc[i]);
            m[i] = max_nan(m[i], acc[i]);
          }
        };
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) m[i] = neg_inf();
        // Two fragment buffers: stage st + 1 is loaded from the window
        // while stage st's products run, and a buffer is refilled only
        // after the wait that covers the products that read it.
        const int nst = g.pool_t * g.pool_f * ngroups;
        uint32_t fa[G][4] = {}, fb[G][4] = {};
        load(fa, 0);
        for (int st = 0; st < nst; st += 2) {
          mma(fa, st);
          if (st + 1 < nst) {
            wgmma_wait<1>();                 // stage st - 1 (fb) is done
            release(fb);
            load(fb, st + 1);
          }
          finish(st);
          if (st + 1 < nst) {
            mma(fb, st + 1);
            if (st + 2 < nst) {
              wgmma_wait<1>();               // stage st (fa) is done
              release(fa);
              load(fa, st + 2);
            }
            finish(st + 1);
          }
        }
        wgmma_wait<0>();
        release(fa);
        release(fb);
        // accumulator element 4j + 2h + e is row row0 + 8h, column
        // 8j + 2tq + e of the chunk
        const int col0 = c * NT;
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) {
          const float v = m[i] + bias[col0 + 8 * (i / 4) + 2 * tq + (i & 1)];
          m[i] = relu ? max_nan(v, 0.f) : v;
        }
        const int pp = otp * g.opf + ofp;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + row0 + 8 * h;
          float* orow = out + ((size_t)n * npos + pp) * g.F + col0;
#pragma unroll
          for (int j = 0; j < NT / 8; j += 2) {
            // even lanes store 4 columns of group j, odd lanes of j + 1
            const float p0 = m[4 * j + 2 * h], p1 = m[4 * j + 2 * h + 1];
            const float q0 = m[4 * j + 4 + 2 * h], q1 = m[4 * j + 5 + 2 * h];
            const float s0 = __shfl_xor_sync(0xffffffffu, odd ? p0 : q0, 1);
            const float s1 = __shfl_xor_sync(0xffffffffu, odd ? p1 : q1, 1);
            const int jj = odd ? j + 1 : j;
            if (n < g.N && col0 + 8 * jj < g.F)
              *reinterpret_cast<float4*>(orow + 8 * jj + 2 * (tq & ~1)) =
                  odd ? make_float4(s0, s1, q0, q1)
                      : make_float4(p0, p1, s0, s1);
          }
        }
      }
    }
  }
}

// Blocks of one kernel that fit on the device at once at this shared-
// memory size.
template <typename Kernel>
int resident_blocks(Kernel kernel, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kMaxSmem)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kWgThreads, smem)) != cudaSuccess)
    return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidValue;
  return sms * per_sm;
}

template <int NT, int G>
int launch_wgmma(const float* x, const float* w, const float* b,
                 const Geom& g, int relu, float* out, size_t smem,
                 cudaStream_t stream) {
  auto kernel = conv_maxpool_wgmma_kernel<NT, G>;
  const int resident = resident_blocks(kernel, smem);
  if (resident < 0) return -resident;
  kernel<<<std::min(g.items, resident), kWgThreads, smem, stream>>>(
      x, w, b, g, relu, out);
  return (int)cudaGetLastError();
}

bool valid_shape(int in_t, int in_f, int in_c, int filt_t, int filt_f, int F,
                 int pool_t, int pool_f) {
  const int out_t = in_t - filt_t + 1, out_f = in_f - filt_f + 1;
  return in_c > 0 && filt_t > 0 && filt_f > 0 && out_t > 0 && out_f > 0 &&
         pool_t > 0 && pool_f > 0 && out_t % pool_t == 0 &&
         out_f % pool_f == 0 && F > 0 && F % 8 == 0;
}

}  // namespace

// x [N, in_t*in_f*in_c]; w [F, filt_t*filt_f*in_c]; b [F];
// out [N, (out_t/pool_t)*(out_f/pool_f)*F].  Both entry points return the
// launch's cudaError_t: cudaErrorInvalidValue when the staged tiles do not
// fit in shared memory, a pool size does not divide the conv output, or F
// is not a multiple of 8.

// bf16 operands, f32 sums, on the tensor cores
extern "C" int kcnn_conv_maxpool_wgmma(const float* x, int N, const float* w,
                                       const float* b, int in_t, int in_f,
                                       int in_c, int filt_t, int filt_f,
                                       int F, int pool_t, int pool_f,
                                       int relu, float* out, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (!valid_shape(in_t, in_f, in_c, filt_t, filt_f, F, pool_t, pool_f))
    return (int)cudaErrorInvalidValue;
  Geom g;
  g.N = N;
  g.in_c = in_c;
  g.row_stride = in_f * in_c;
  g.D = in_t * g.row_stride;
  g.fc = filt_f * in_c;
  g.K = filt_t * g.fc;
  // k16 steps go to the tensor cores in groups of G = 2 or 6
  const int steps = (g.K + 15) / 16, group = steps <= 2 ? 2 : 6;
  g.KS = (steps + group - 1) / group * group;
  int nt = 16;
  while (nt < F && nt < 128) nt *= 2;
  g.F = F;
  g.F_pad = (F + nt - 1) / nt * nt;
  g.pool_t = pool_t;
  g.pool_f = pool_f;
  g.opt = (in_t - filt_t + 1) / pool_t;
  g.opf = (in_f - filt_f + 1) / pool_f;
  g.TW = pool_t + filt_t - 1;
  g.unit = (g.D % 4 == 0 && g.row_stride % 4 == 0 &&
            reinterpret_cast<uintptr_t>(x) % 16 == 0) ? 4 : 1;
  // the fewest freq parts whose block fits two to an SM, else one
  size_t smem = 0;
  bool fits = false;
  for (int limit : {kTwoBlockSmem, kMaxSmem}) {
    for (int parts = 1; parts <= g.opf && !fits; ++parts) {
      g.per_part = (g.opf + parts - 1) / parts;
      g.parts = (g.opf + g.per_part - 1) / g.per_part;
      g.Wc = 0;
      for (int p = 0; p < g.parts; ++p) {
        const int lo = p * g.per_part, hi = std::min(g.opf, lo + g.per_part);
        const int c_lo = lo * pool_f * in_c / g.unit * g.unit;
        const int c_hi = (hi * pool_f + filt_f - 1) * in_c;
        g.Wc = std::max(g.Wc, (c_hi - c_lo + g.unit - 1) / g.unit * g.unit);
      }
      // a row pitch of 8 mod 32 floats spreads a quad's 8 rows over banks
      g.P = (g.TW * g.Wc + 3) / 4 * 4;
      while (g.P % 32 != 8) g.P += 4;
      smem = wgmma_smem(g);
      fits = smem <= (size_t)limit;
    }
    if (fits) break;
  }
  if (!fits) return (int)cudaErrorInvalidValue;
  g.items = (N + kRows - 1) / kRows * g.opt * g.parts;
  cudaStream_t s = (cudaStream_t)stream;
#define KCNN_WGMMA(NT)                                                   \
  return group == 2 ? launch_wgmma<NT, 2>(x, w, b, g, relu, out, smem, s) \
                    : launch_wgmma<NT, 6>(x, w, b, g, relu, out, smem, s)
  switch (nt) {
    case 16: KCNN_WGMMA(16);
    case 32: KCNN_WGMMA(32);
    case 64: KCNN_WGMMA(64);
    default: KCNN_WGMMA(128);
  }
#undef KCNN_WGMMA
}

// f32 operands, on the CUDA cores
extern "C" int kcnn_conv_maxpool(const float* x, int N, const float* w,
                                 const float* b, int in_t, int in_f, int in_c,
                                 int filt_t, int filt_f, int F, int pool_t,
                                 int pool_f, int relu, float* out,
                                 void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (!valid_shape(in_t, in_f, in_c, filt_t, filt_f, F, pool_t, pool_f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int pw = pool_t * pool_f;
#define KCNN_CONV(TM)                                                        \
  return launch<TM>(x, N, w, b, in_t, in_f, in_c, filt_t, filt_f, F, pool_t, \
                    pool_f, relu, out, s)
  if (pw % 8 == 0) KCNN_CONV(8);
  if (pw % 6 == 0) KCNN_CONV(6);
  if (pw % 4 == 0) KCNN_CONV(4);
  if (pw % 3 == 0) KCNN_CONV(3);
  if (pw % 2 == 0) KCNN_CONV(2);
  KCNN_CONV(1);
#undef KCNN_CONV
}
