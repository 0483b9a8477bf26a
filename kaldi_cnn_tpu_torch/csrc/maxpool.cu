// 3-D max pooling over (time, freq, channel) windows of flat (t, f, c) rows:
// the forward pass, optionally with the window argmax, and the backward pass
// that routes the derivative along that argmax.
//
// Replaces the TPU kernel kaldi_cnn_tpu/ops/maxpool_pallas.py::_maxpool_kernel
// (entry point maxpool3d_pallas), and with it the training path of
// Maxpooling3DComponent (components.py forward(train=True) and backprop with
// the argmax aux).  Input rows are flattened [in_t, in_f, in_c] volumes, index
// (t * in_f + f) * in_c + c; output rows are [out_t, out_f, out_c] in
// (ot, of, oc) order with out_x = in_x / pool_x.  The window argmax is
// (pt * pool_f + pf) * pool_c + pc, the first index wins ties, and a window
// holding a NaN gives NaN and the argmax pool_t * pool_f * pool_c (no index),
// as jnp.max and the JAX where/min argmax do.  Values are f32 or bf16 and keep
// their type; the argmax is int8 (windows under 128 elements) or int32.
//
// What bounds it on an H100: nothing but device memory.  At the bench shape
// (ConvnetConfig(), F = 128, 4096 rows, pool 2x3x1) the forward reads the
// 503 MB conv activation once and writes 84 MB of maxima plus 21 MB of int8
// argmax; the backward reads those 105 MB and writes the 503 MB input
// derivative.  About 608 MB each way, 0.18 ms at 3.35 TB/s.  The Pallas
// kernel needed XLA to gather the windows into G pool-offset slabs first (a
// Mosaic restriction), a second full copy of the input; here a thread reads
// its window straight from the input row.
//
// Two forward kernels; ops/maxpool.py picks one from the shape and the
// pointers before the launch:
//
// * maxpool_fwd_vec_kernel (kcnn_maxpool_fwd_vec), the training path's, when
//   pool_c = 1, in_c is a multiple of V = 16 B / element (4 f32, 8 bf16) and
//   the input, output and argmax pointers are 16-byte aligned.  The recipe's
//   8x30x64 and 8x30x128 conv outputs with pool 2x3x1 are.  A thread owns V
//   consecutive channels of one output position of one row: it issues every
//   16-byte load of its window (ld.global.nc) before the first compare,
//   compares lane by lane (f32), or two bf16 lanes at once with bf16x2
//   compare masks, and writes V maxima as one 16-byte streaming store
//   (__stcs), the int8 argmax as one 4- or 8-byte store and an int32 argmax
//   as 16-byte stores.  A warp request moves 512 B instead of the scalar
//   kernel's 128 B (f32) or 64 B (bf16), and there is no offset table in
//   shared memory and no __syncthreads.  The window offsets are compile-time
//   for the recipe's pool 2x3; other pools walk (pt, pf) with two counters,
//   eight loads in flight.  Grid: x over a row's vectors in blocks of 64
//   threads, y over rows, so a thread splits its index into (position,
//   vector) once.  Measured on an H100 80GB HBM3 (700 W) at the bench shape
//   (scripts/kernel_variants.py): the L1::no_allocate and evict-first (.cs)
//   load hints cost 1-3 % against plain ld.global.nc; in bf16 a first
//   version's per-lane compares (unpack, two compares, three selects a
//   lane) held the kernel to 71 % of its bound, the bf16x2 masks to 90 %.
// * maxpool_fwd_kernel (kcnn_maxpool_fwd), any pool_c, in_c and alignment:
//   one output element a thread, a window's offsets tabulated in shared
//   memory, kChunk scalar loads in flight.
//
// And two backward kernels, picked the same way:
//
// * maxpool_bwd_vec_kernel (kcnn_maxpool_bwd_vec), the training path's,
//   under the forward's vector conditions (the derivative, argmax and input
//   derivative pointers 16-byte aligned): the forward's twin.  A thread owns
//   V consecutive channels of one output position of one row: one 16-byte
//   ld.global.nc of the derivative, one 4- or 8-byte load of the int8
//   argmax (16-byte loads of an int32 one), then for each of the window's
//   pool_t * pool_f offsets one 16-byte streaming store (__stcs) of the
//   derivative's bits masked to the lanes whose argmax is that offset (0
//   elsewhere; a NaN window's argmax is no offset, so it gets zeros).  The
//   scalar backward stores 4 or 2 bytes a thread for each offset, so a
//   warp request moves 128 B (f32) or 64 B (bf16): in bf16 it took 36 % of
//   its bound at the Switchboard shape (8x30x48, 256 rows) and in f32 77 %
//   at the bench shape, in CUDA graphs on an H100 80GB HBM3 (700 W).  Here
//   a request moves 512 B.  The pool 2x3 is compile-time, others run-time;
//   no offset table, no __syncthreads.
// * maxpool_bwd_kernel (kcnn_maxpool_bwd), any pool_c, in_c and alignment:
//   one output element a thread, its window's offsets tabulated.
//
// Layout of the scalar kernels: both give a thread one output element of a
// row and walk rows along the grid's y dimension, so the element's (ot, of,
// oc) and its window's offset are computed once (integer division, not
// memory, bounded a first version that split a flat index per element), and
// the forward issues a window's loads together (one load in flight a thread,
// compared before the next was issued, held a second version to 1.4 TB/s).
// Neighbouring threads take neighbouring output channels, so for each window
// offset a warp reads (forward) or writes (backward) one contiguous run of
// the row (coalesced when pool_c = 1, the CNN recipe's case) and the maxima
// and argmax are contiguous.  Both backward kernels write the thread's whole
// window, the derivative at the argmax and 0 elsewhere; the windows tile
// the input, so every input element is written exactly once, with no
// atomics and no memset pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kTargetBlocks = 132 * 16;
constexpr int kChunk = 8;                   // window loads in flight
// Threads a block of the vectorised forward: 64 divides the row's vectors
// at every recipe shape (320, 640, 1280); 128 and 256 measured the same.
constexpr int kVecThreads = 64;
constexpr int kMaxWindow = 12288;           // offset table <= 48 KB

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

template <typename T>
__device__ __forceinline__ T neg_inf();
template <>
__device__ __forceinline__ float neg_inf<float>() { return -INFINITY; }
template <>
__device__ __forceinline__ __nv_bfloat16 neg_inf<__nv_bfloat16>() {
  return __float2bfloat16_rn(-INFINITY);
}

struct Shape {
  int in_f, in_c, pool_t, pool_f, pool_c, out_f, out_c, in_dim, out_dim;
};

// offs[w] = offset of window element w = (pt * pool_f + pf) * pool_c + pc
// from the window's first element; every thread of the block waits for it.
__device__ __forceinline__ int tabulate_window(const Shape& s, int* offs) {
  const int window = s.pool_t * s.pool_f * s.pool_c;
  for (int w = threadIdx.x; w < window; w += blockDim.x) {
    const int pc = w % s.pool_c, pf = (w / s.pool_c) % s.pool_f;
    const int pt = w / (s.pool_c * s.pool_f);
    offs[w] = (pt * s.in_f + pf) * s.in_c + pc;
  }
  __syncthreads();
  return window;
}

// Row offset of the first window element of output element r.
__device__ __forceinline__ int window_base(const Shape& s, int r) {
  const int oc = r % s.out_c;
  const int of = (r / s.out_c) % s.out_f;
  const int ot = r / (s.out_c * s.out_f);
  return (ot * s.pool_t * s.in_f + of * s.pool_f) * s.in_c + oc * s.pool_c;
}

// The grid is 2-D: x walks the output elements of a row, y walks rows
// (grid-stride), so a thread splits its element index into (ot, of, oc)
// once and reuses it for every row it visits.  The block first tabulates
// each window offset's distance from the window's first element in shared
// memory; the forward then loads the window kChunk values at a time,
// independent loads in flight together, before it compares them.
// A: int8_t or int32_t argmax, or void (no argmax output).
template <typename T, typename A>
__global__ void maxpool_fwd_kernel(const T* __restrict__ x, int N, Shape s,
                                   T* __restrict__ out,
                                   A* __restrict__ arg) {
  extern __shared__ int offs[];              // [window]
  const int window = tabulate_window(s, offs);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= s.out_dim) return;
  const int base = window_base(s, r);
  for (int n = blockIdx.y; n < N; n += gridDim.y) {
    const T* xr = x + (int64_t)n * s.in_dim + base;
    T best = neg_inf<T>();
    float m = -INFINITY;
    bool nan = false;
    int idx = 0;
    for (int w0 = 0; w0 < window; w0 += kChunk) {
      T v[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (w0 + j < window) v[j] = xr[offs[w0 + j]];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (w0 + j >= window || nan) continue;
        const float fv = to_float(v[j]);
        if (fv != fv) {
          nan = true;
          best = v[j];
        } else if (fv > m) {         // strict: the first maximum wins ties
          m = fv;
          best = v[j];
          idx = w0 + j;
        }
      }
    }
    const int64_t o = (int64_t)n * s.out_dim + r;
    out[o] = best;
    if constexpr (!std::is_void<A>::value) arg[o] = (A)(nan ? window : idx);
  }
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}

// The running window maximum of one 32-bit word of a 16-byte vector: one
// f32 lane, or two bf16 lanes compared at once through bf16x2 masks (one
// set.gt.bf16x2 for both).  A value greater than the maximum (strictly: the
// first maximum wins ties) takes its place and its window index; a NaN
// compares false, and the first NaN seen is kept aside: it is the result,
// with the argmax `window`, as in the scalar kernel.
template <typename T>
struct WordMax;

template <>
struct WordMax<float> {
  float m = -INFINITY;
  int idx = 0;
  bool nan = false;
  uint32_t nan_bits = 0;
  __device__ __forceinline__ void add(uint32_t v, int w) {
    const float f = __uint_as_float(v);
    if (f > m) {
      m = f;
      idx = w;
    }
    if (f != f && !nan) {
      nan = true;
      nan_bits = v;
    }
  }
  __device__ __forceinline__ uint32_t value() const {
    return nan ? nan_bits : __float_as_uint(m);
  }
  __device__ __forceinline__ int arg(int, int window) const {
    return nan ? window : idx;
  }
};

template <>
struct WordMax<__nv_bfloat16> {
  uint32_t best = 0xff80ff80u;           // -inf, -inf
  uint32_t idx = 0, nan = 0, nan_bits = 0;   // 16 bits a lane
  __device__ __forceinline__ void add(uint32_t v, int w) {
    const uint32_t gt = __hgt2_mask(as_bf162(v), as_bf162(best));
    best = (v & gt) | (best & ~gt);
    idx = ((uint32_t)w * 0x10001u & gt) | (idx & ~gt);
    const uint32_t is_nan = __hneu2_mask(as_bf162(v), as_bf162(v));
    const uint32_t first = is_nan & ~nan;
    nan_bits = (v & first) | (nan_bits & ~first);
    nan |= is_nan;
  }
  __device__ __forceinline__ uint32_t value() const {
    return (nan_bits & nan) | (best & ~nan);
  }
  __device__ __forceinline__ int arg(int half, int window) const {
    return (nan >> (16 * half)) & 1 ? window
                                    : (int)((idx >> (16 * half)) & 0xffffu);
  }
};

// V = 16 / sizeof(T) consecutive output channels of one output position a
// thread; the grid's x walks a row's vectors, y walks rows.  PT, PF > 0 fix
// the pool at compile time (every load of the window in flight at once);
// PT = PF = 0 read it from s and keep kChunk loads in flight.  Requires
// pool_c = 1, in_c % V = 0 and 16-byte aligned x, out and arg.
template <typename T, typename A, int PT, int PF>
__global__ void maxpool_fwd_vec_kernel(const T* __restrict__ x, int N, Shape s,
                                       T* __restrict__ out,
                                       A* __restrict__ arg) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kW = PT * PF;                  // 0: the pool is runtime
  constexpr int kLoads = kW ? kW : kChunk;     // loads in flight
  const int pool_f = PF ? PF : s.pool_f;
  const int window = kW ? kW : s.pool_t * s.pool_f;
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (e >= s.out_dim) return;
  const int base = window_base(s, e);
  for (int n = blockIdx.y; n < N; n += gridDim.y) {
    const T* xr = x + (int64_t)n * s.in_dim + base;
    WordMax<T> acc[4];
    int pt = 0, pf = 0;                        // window element w0's (pt, pf)
    for (int w0 = 0; w0 < window; w0 += kLoads) {
      uint4 v[kLoads];
#pragma unroll
      for (int c = 0; c < kLoads; ++c) {
        if (kW || w0 + c < window) {
          // ld.global.nc; the L1::no_allocate and .cs (evict-first)
          // variants measured 2 % slower on an H100 at the bench shape
          v[c] = __ldg(reinterpret_cast<const uint4*>(
              xr + (pt * s.in_f + pf) * s.in_c));
          if (++pf == pool_f) {
            pf = 0;
            ++pt;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kLoads; ++c) {
        if (!kW && w0 + c >= window) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q].add(word(v[c], q), w0 + c);
      }
    }
    const int64_t o = (int64_t)n * s.out_dim + e;
    __stcs(reinterpret_cast<uint4*>(out + o),
           make_uint4(acc[0].value(), acc[1].value(), acc[2].value(),
                      acc[3].value()));
    if constexpr (!std::is_void<A>::value) {
      int a[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if constexpr (V == 4)
          a[j] = acc[j].arg(0, window);
        else
          a[j] = acc[j >> 1].arg(j & 1, window);
      }
      if constexpr (sizeof(A) == 1) {
        uint32_t lo = 0, hi = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) lo |= (uint32_t)(a[j] & 0xff) << (8 * j);
        if constexpr (V == 4) {
          __stcs(reinterpret_cast<unsigned int*>(arg + o), lo);
        } else {
#pragma unroll
          for (int j = 4; j < 8; ++j)
            hi |= (uint32_t)(a[j] & 0xff) << (8 * (j - 4));
          __stcs(reinterpret_cast<int2*>(arg + o),
                 make_int2((int)lo, (int)hi));
        }
      } else {
#pragma unroll
        for (int q = 0; q < V / 4; ++q)
          __stcs(reinterpret_cast<int4*>(arg + o) + q,
                 make_int4(a[4 * q], a[4 * q + 1], a[4 * q + 2],
                           a[4 * q + 3]));
      }
    }
  }
}

// One thread an output element, as in the forward: it writes its whole
// window of the input derivative, the derivative at the argmax and 0
// elsewhere.  The windows tile the input, so every element is written
// once; for each window offset a warp writes one contiguous run.
template <typename T, typename A>
__global__ void maxpool_bwd_kernel(const T* __restrict__ d,
                                   const A* __restrict__ arg, int N, Shape s,
                                   T* __restrict__ dx) {
  extern __shared__ int offs[];              // [window]
  const int window = tabulate_window(s, offs);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= s.out_dim) return;
  const int base = window_base(s, r);
  for (int n = blockIdx.y; n < N; n += gridDim.y) {
    const int64_t o = (int64_t)n * s.out_dim + r;
    const int idx = (int)arg[o];
    const T v = d[o];
    T* dr = dx + (int64_t)n * s.in_dim + base;
    for (int w = 0; w < window; ++w) dr[offs[w]] = (w == idx) ? v : zero<T>();
  }
}

// The argmax of V consecutive output elements: one 4- or 8-byte load of
// int8, or V / 4 16-byte loads of int32.
template <typename A, int V>
__device__ __forceinline__ void load_argmax(const A* p, int (&a)[V]) {
  if constexpr (sizeof(A) == 1) {
    uint32_t u[V / 4];
    if constexpr (V == 4) {
      u[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      u[0] = v.x;
      u[1] = v.y;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) a[j] = (int)(int8_t)(u[j >> 2] >> (8 * (j & 3)));
  } else {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(p) + q);
      a[4 * q] = v.x;
      a[4 * q + 1] = v.y;
      a[4 * q + 2] = v.z;
      a[4 * q + 3] = v.w;
    }
  }
}

// The 16-byte vector d with every lane whose argmax is not w cleared: the
// derivative's own bits (-0.0 and NaN payloads included) or +0.0.  A word
// holds one f32 lane, or bf16 lanes 2q (low half) and 2q + 1.
template <int V>
__device__ __forceinline__ uint4 routed(const uint4& d, const int (&a)[V],
                                        int w) {
  uint32_t m[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (V == 4)
      m[q] = a[q] == w ? 0xffffffffu : 0u;
    else
      m[q] = (a[2 * q] == w ? 0x0000ffffu : 0u) |
             (a[2 * q + 1] == w ? 0xffff0000u : 0u);
  }
  return make_uint4(d.x & m[0], d.y & m[1], d.z & m[2], d.w & m[3]);
}

// The forward's twin: V = 16 / sizeof(T) consecutive output channels of one
// output position a thread, x over a row's vectors, y over rows.  PT, PF > 0
// fix the pool at compile time; PT = PF = 0 read it from s.  Requires
// pool_c = 1, in_c % V = 0 and 16-byte aligned d, arg and dx.
template <typename T, typename A, int PT, int PF>
__global__ void maxpool_bwd_vec_kernel(const T* __restrict__ d,
                                       const A* __restrict__ arg, int N,
                                       Shape s, T* __restrict__ dx) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kW = PT * PF;                  // 0: the pool is runtime
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (e >= s.out_dim) return;
  const int base = window_base(s, e);
  for (int n = blockIdx.y; n < N; n += gridDim.y) {
    const int64_t o = (int64_t)n * s.out_dim + e;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(d + o));
    int a[V];
    load_argmax<A, V>(arg + o, a);
    T* dr = dx + (int64_t)n * s.in_dim + base;
    if constexpr (kW > 0) {
#pragma unroll
      for (int w = 0; w < kW; ++w)
        __stcs(reinterpret_cast<uint4*>(
                   dr + ((w / PF) * s.in_f + w % PF) * s.in_c),
               routed<V>(v, a, w));
    } else {
      const int window = s.pool_t * s.pool_f;
      int pt = 0, pf = 0;
      for (int w = 0; w < window; ++w) {
        __stcs(reinterpret_cast<uint4*>(dr + (pt * s.in_f + pf) * s.in_c),
               routed<V>(v, a, w));
        if (++pf == s.pool_f) {
          pf = 0;
          ++pt;
        }
      }
    }
  }
}

// x over a row's output elements, y over rows: enough blocks to fill
// the card, each walking several rows.
dim3 grid_for(int N, const Shape& s) {
  const int gx = (s.out_dim + kThreads - 1) / kThreads;
  int64_t gy = (kTargetBlocks + gx - 1) / gx;
  if (gy > N) gy = N;
  if (gy > 65535) gy = 65535;
  return dim3(gx, (unsigned)gy);
}

// Fills s; false when a pool size does not divide its dimension or the
// window has more than kMaxWindow elements.
bool make_shape(int in_t, int in_f, int in_c, int pool_t, int pool_f,
                int pool_c, Shape* s) {
  if (in_t <= 0 || in_f <= 0 || in_c <= 0 || pool_t <= 0 || pool_f <= 0 ||
      pool_c <= 0 || in_t % pool_t || in_f % pool_f || in_c % pool_c ||
      (int64_t)pool_t * pool_f * pool_c > kMaxWindow)
    return false;
  s->in_f = in_f;
  s->in_c = in_c;
  s->pool_t = pool_t;
  s->pool_f = pool_f;
  s->pool_c = pool_c;
  s->out_f = in_f / pool_f;
  s->out_c = in_c / pool_c;
  s->in_dim = in_t * in_f * in_c;
  s->out_dim = (in_t / pool_t) * s->out_f * s->out_c;
  return true;
}

template <typename T>
int launch_fwd(const void* x, int N, const Shape& s, void* out, void* arg,
               int arg_bytes, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const dim3 grid = grid_for(N, s);
  const size_t smem = sizeof(int) * s.pool_t * s.pool_f * s.pool_c;
  if (arg_bytes == 0)
    maxpool_fwd_kernel<T, void><<<grid, kThreads, smem, stream>>>(
        xt, N, s, ot, nullptr);
  else if (arg_bytes == 1)
    maxpool_fwd_kernel<T, int8_t><<<grid, kThreads, smem, stream>>>(
        xt, N, s, ot, static_cast<int8_t*>(arg));
  else
    maxpool_fwd_kernel<T, int32_t><<<grid, kThreads, smem, stream>>>(
        xt, N, s, ot, static_cast<int32_t*>(arg));
  return (int)cudaGetLastError();
}

// The vector kernels' grid: x over a row's vectors in blocks of
// kVecThreads, y over rows.
template <typename T>
dim3 vec_grid(int N, const Shape& s) {
  const int vecs = s.out_dim / (16 / (int)sizeof(T));
  return dim3((vecs + kVecThreads - 1) / kVecThreads, N < 65535 ? N : 65535);
}

template <typename T, typename A>
void launch_fwd_vec_pool(const T* x, int N, const Shape& s, T* out, A* arg,
                         cudaStream_t stream) {
  const dim3 grid = vec_grid<T>(N, s);
  if (s.pool_t == 2 && s.pool_f == 3)
    maxpool_fwd_vec_kernel<T, A, 2, 3><<<grid, kVecThreads, 0, stream>>>(
        x, N, s, out, arg);
  else
    maxpool_fwd_vec_kernel<T, A, 0, 0><<<grid, kVecThreads, 0, stream>>>(
        x, N, s, out, arg);
}

template <typename T>
int launch_fwd_vec(const void* x, int N, const Shape& s, void* out,
                   void* arg, int arg_bytes, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (arg_bytes == 0)
    launch_fwd_vec_pool<T, void>(xt, N, s, ot, nullptr, stream);
  else if (arg_bytes == 1)
    launch_fwd_vec_pool<T, int8_t>(xt, N, s, ot, static_cast<int8_t*>(arg),
                                   stream);
  else
    launch_fwd_vec_pool<T, int32_t>(xt, N, s, ot, static_cast<int32_t*>(arg),
                                    stream);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* d, const void* arg, int arg_bytes, int N,
               const Shape& s, void* dx, cudaStream_t stream) {
  const T* dt = static_cast<const T*>(d);
  T* dxt = static_cast<T*>(dx);
  const dim3 grid = grid_for(N, s);
  const size_t smem = sizeof(int) * s.pool_t * s.pool_f * s.pool_c;
  if (arg_bytes == 1)
    maxpool_bwd_kernel<T, int8_t><<<grid, kThreads, smem, stream>>>(
        dt, static_cast<const int8_t*>(arg), N, s, dxt);
  else
    maxpool_bwd_kernel<T, int32_t><<<grid, kThreads, smem, stream>>>(
        dt, static_cast<const int32_t*>(arg), N, s, dxt);
  return (int)cudaGetLastError();
}

template <typename T, typename A>
void launch_bwd_vec_pool(const T* d, const A* arg, int N, const Shape& s,
                         T* dx, cudaStream_t stream) {
  const dim3 grid = vec_grid<T>(N, s);
  if (s.pool_t == 2 && s.pool_f == 3)
    maxpool_bwd_vec_kernel<T, A, 2, 3><<<grid, kVecThreads, 0, stream>>>(
        d, arg, N, s, dx);
  else
    maxpool_bwd_vec_kernel<T, A, 0, 0><<<grid, kVecThreads, 0, stream>>>(
        d, arg, N, s, dx);
}

template <typename T>
int launch_bwd_vec(const void* d, const void* arg, int arg_bytes, int N,
                   const Shape& s, void* dx, cudaStream_t stream) {
  const T* dt = static_cast<const T*>(d);
  T* dxt = static_cast<T*>(dx);
  if (arg_bytes == 1)
    launch_bwd_vec_pool<T, int8_t>(dt, static_cast<const int8_t*>(arg), N, s,
                                   dxt, stream);
  else
    launch_bwd_vec_pool<T, int32_t>(dt, static_cast<const int32_t*>(arg), N,
                                    s, dxt, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// x [N, in_t*in_f*in_c] (f32, or bf16 when bf16 = 1); out [N, out_dim] of the
// same type; argmax [N, out_dim] of arg_bytes bytes an element (1: int8,
// 4: int32) or null with arg_bytes = 0.  Returns the launch's cudaError_t
// (cudaErrorInvalidValue when a pool size does not divide its dimension, the
// window exceeds kMaxWindow elements, the argmax width is not 0, 1 or 4, or
// an int8 argmax cannot hold the window).
extern "C" int kcnn_maxpool_fwd(const void* x, int N, int in_t, int in_f,
                                int in_c, int pool_t, int pool_f, int pool_c,
                                int bf16, void* out, void* argmax,
                                int arg_bytes, void* stream) {
  Shape s;
  if (!make_shape(in_t, in_f, in_c, pool_t, pool_f, pool_c, &s))
    return (int)cudaErrorInvalidValue;
  if (arg_bytes != 0 && arg_bytes != 1 && arg_bytes != 4)
    return (int)cudaErrorInvalidValue;
  if (arg_bytes == 1 && pool_t * pool_f * pool_c >= 128)
    return (int)cudaErrorInvalidValue;
  if ((arg_bytes == 0) != (argmax == nullptr))
    return (int)cudaErrorInvalidValue;
  if (N <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch_fwd<__nv_bfloat16>(x, N, s, out, argmax, arg_bytes, st)
              : launch_fwd<float>(x, N, s, out, argmax, arg_bytes, st);
}

// The vectorised forward, with kcnn_maxpool_fwd's arguments.  Returns
// cudaErrorInvalidValue, besides kcnn_maxpool_fwd's cases, when pool_c is
// not 1, in_c is not a multiple of 16 B / element, or x, out or argmax is
// not 16-byte aligned.
extern "C" int kcnn_maxpool_fwd_vec(const void* x, int N, int in_t, int in_f,
                                    int in_c, int pool_t, int pool_f,
                                    int pool_c, int bf16, void* out,
                                    void* argmax, int arg_bytes,
                                    void* stream) {
  Shape s;
  if (!make_shape(in_t, in_f, in_c, pool_t, pool_f, pool_c, &s))
    return (int)cudaErrorInvalidValue;
  if (arg_bytes != 0 && arg_bytes != 1 && arg_bytes != 4)
    return (int)cudaErrorInvalidValue;
  if (arg_bytes == 1 && pool_t * pool_f >= 128)
    return (int)cudaErrorInvalidValue;
  if ((arg_bytes == 0) != (argmax == nullptr))
    return (int)cudaErrorInvalidValue;
  const int v = bf16 ? 8 : 4;
  if (pool_c != 1 || in_c % v || ((uintptr_t)x | (uintptr_t)out |
                                  (uintptr_t)argmax) % 16)
    return (int)cudaErrorInvalidValue;
  if (N <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch_fwd_vec<__nv_bfloat16>(x, N, s, out, argmax, arg_bytes,
                                              st)
              : launch_fwd_vec<float>(x, N, s, out, argmax, arg_bytes, st);
}

// out_deriv [N, out_dim] (f32, or bf16 when bf16 = 1); argmax [N, out_dim] as
// the forward wrote it (arg_bytes 1 or 4); in_deriv [N, in_dim] of the
// derivative's type.
extern "C" int kcnn_maxpool_bwd(const void* out_deriv, const void* argmax,
                                int arg_bytes, int N, int in_t, int in_f,
                                int in_c, int pool_t, int pool_f, int pool_c,
                                int bf16, void* in_deriv, void* stream) {
  Shape s;
  if (!make_shape(in_t, in_f, in_c, pool_t, pool_f, pool_c, &s))
    return (int)cudaErrorInvalidValue;
  if (arg_bytes != 1 && arg_bytes != 4) return (int)cudaErrorInvalidValue;
  if (N <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch_bwd<__nv_bfloat16>(out_deriv, argmax, arg_bytes, N, s,
                                          in_deriv, st)
              : launch_bwd<float>(out_deriv, argmax, arg_bytes, N, s,
                                  in_deriv, st);
}

// The vectorised backward, with kcnn_maxpool_bwd's arguments.  Returns
// cudaErrorInvalidValue, besides kcnn_maxpool_bwd's cases, when pool_c is
// not 1, in_c is not a multiple of 16 B / element, an int8 argmax cannot
// hold the window, or out_deriv, argmax or in_deriv is not 16-byte aligned.
extern "C" int kcnn_maxpool_bwd_vec(const void* out_deriv, const void* argmax,
                                    int arg_bytes, int N, int in_t, int in_f,
                                    int in_c, int pool_t, int pool_f,
                                    int pool_c, int bf16, void* in_deriv,
                                    void* stream) {
  Shape s;
  if (!make_shape(in_t, in_f, in_c, pool_t, pool_f, pool_c, &s))
    return (int)cudaErrorInvalidValue;
  if (arg_bytes != 1 && arg_bytes != 4) return (int)cudaErrorInvalidValue;
  if (arg_bytes == 1 && pool_t * pool_f >= 128)
    return (int)cudaErrorInvalidValue;
  const int v = bf16 ? 8 : 4;
  if (pool_c != 1 || in_c % v || ((uintptr_t)out_deriv | (uintptr_t)argmax |
                                  (uintptr_t)in_deriv) % 16)
    return (int)cudaErrorInvalidValue;
  if (N <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch_bwd_vec<__nv_bfloat16>(out_deriv, argmax, arg_bytes, N,
                                              s, in_deriv, st)
              : launch_bwd_vec<float>(out_deriv, argmax, arg_bytes, N, s,
                                      in_deriv, st);
}
