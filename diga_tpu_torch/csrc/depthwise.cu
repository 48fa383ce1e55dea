// Depthwise 3x3 convolution on channels_last maps, and its weight gradient,
// hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: diga_tpu leaves every convolution to XLA.  It
// serves the three dilated depthwise convs of DAFormer's sep-ASPP head
// (models/mit_daformer.py::DepthwiseSeparableConvModule: 1024 channels at
// 128x224 in training, dilations 6, 12, 18), which cuDNN ran in its grouped
// direct kernel at ~35x their byte bound.
//
//   y[b,h,w,c]  = Σ_{i,j ∈ {-1,0,1}} wt[c,i,j] · x[b, h+i·d, w+j·d, c]   (zero padding d)
//   dx          = the same sum over dy with the weights turned by 180°
//                 (exact for stride 1 and symmetric padding): the same
//                 kernel, reading tap 8 - t for tap t (rotate = 1)
//   dw[c,i,j]   = Σ_{b,h,w} dy[b,h,w,c] · x[b, h+i·d, w+j·d, c]
// x, y, dy: NHWC (channels_last), f32 or bf16; wt and dw: (C, 1, 3, 3) in
// the same dtype.  Every sum is taken in f32 and rounded once at the store.
//
// Budget.  At the training path's (6, 128, 224, 1024) in bf16 a map is
// 352.3 MB: the forward reads x and writes y once, 704.6 MB, 210.3 us at
// 3.35 TB/s; the weight gradient reads x and dy, 704.6 MB and 210.3 us.
// 9 multiply-adds per element are about 2 operations per byte, far below
// the card's ratio: the bytes bound every call.
//
// Design.  A thread owns one 16-byte vector of channels (8 in bf16, 4 in
// f32); a block's threads take consecutive vectors of one pixel, so a warp
// reads 512 contiguous bytes per load.  The thread walks a run of output
// pixels along a row with stride d (columns r, r+d, r+2d, ...: one residue
// r of the column mod d), so the 3x3 taps of consecutive outputs overlap in
// two of their three columns: it keeps a window of three input columns (x3
// rows) in registers, and each output loads one new column, three 16-byte
// loads, and the column after it is already in flight.  A tap's other
// re-reads, by the outputs of the rows h ± d, come from the 50 MB L2: the
// units of work are ordered (image, row, residue, run), and the grid is
// persistent (kBlocksPerSm blocks a multiprocessor, all resident), block b
// taking units b, b + grid, b + 2·grid, ...: at any time the blocks work
// on consecutive units, a band of rows of one image, and device memory
// sees each input byte about once.  (Blocks that each took a contiguous
// share of the units read from the whole map at once, and every row three
// times from device memory: the weight gradient ran at 39 % of its bound
// that way.)  The forward keeps its 9 taps' weights in f32 registers for
// the whole walk; the weight gradient keeps 9 f32 sums per channel instead,
// over the units of its block, and writes them as per-block partials
// (part[block][tap][c]) that depthwise_wgrad_fold_kernel sums in block
// order: no float atomics, every call bitwise repeatable.
//
// The walk (units, residues, runs, grid) is chosen by the wrapper
// (diga_tpu_torch/ops/depthwise.py::launch_plan, which repeats kThreads,
// kBlocksPerSm, kRun and kFoldThreads) and decoded here.  Plain C interface,
// loaded with ctypes.  Each entry launches on the caller's stream, allocates
// nothing and returns the first CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // channel vectors of a block, one a thread
constexpr int kBlocksPerSm = 3;  // resident blocks a multiprocessor (158 registers a thread)
constexpr int kRun = 32;       // the most outputs of one run
constexpr int kFoldThreads = 256;
constexpr int kTaps = 9;

template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Element e of a 16-byte vector of T, as f32 (e a compile-time constant
// once the loops are unrolled).
template <typename T>
__device__ __forceinline__ float elem(const uint4& v, int e);
template <>
__device__ __forceinline__ float elem<float>(const uint4& v, int e) {
  return __uint_as_float(word(v, e));
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& v, int e) {
  const uint32_t u = word(v, e >> 1);
  return __uint_as_float((e & 1) ? (u & 0xffff0000u) : (u << 16));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// f32 sums rounded once into a 16-byte vector of T.
__device__ __forceinline__ uint4 pack(const float (&a)[4]) {
  return make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]), __float_as_uint(a[2]),
                    __float_as_uint(a[3]));
}
__device__ __forceinline__ uint4 pack(const float (&a)[8]) {
  return make_uint4(bf16x2(a[0], a[1]), bf16x2(a[2], a[3]), bf16x2(a[4], a[5]),
                    bf16x2(a[6], a[7]));
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// The walk over the output map, as the wrapper plans it: unit u is
// (image b, row h, residue r < classes, run s < segs), s fastest; run s of
// residue r covers the outputs at columns r + k·d, k in [s·run, (s+1)·run)
// and below the residue's count of columns.  Block blockIdx.x takes units
// blockIdx.x, blockIdx.x + gridDim.x, ... of one slice of kThreads channel
// vectors (blockIdx.y).
struct Walk {
  long long units;
  int h, w, c, d;
  int classes, segs, run;
};

struct Unit {
  long long b;
  int h, r, k0, k1;
};

__device__ __forceinline__ Unit decode(const Walk& wk, long long u) {
  Unit q;
  const int s = (int)(u % wk.segs);
  long long t = u / wk.segs;
  q.r = (int)(t % wk.classes);
  t /= wk.classes;
  q.h = (int)(t % wk.h);
  q.b = t / wk.h;
  const int n = (wk.w - q.r + wk.d - 1) / wk.d;  // columns r, r + d, ... below w
  q.k0 = s * wk.run;
  q.k1 = min(q.k0 + wk.run, n);
  return q;
}

// One unit's walk: for each output k of the run, `body(k, win)` with win
// the 3x3 taps' input vectors (rows h - d, h, h + d; columns of outputs
// k - 1, k, k + 1), zeros outside the map.  `src` is the map at this
// thread's channel vector.
template <typename T, typename Body>
__device__ __forceinline__ void walk_unit(const T* __restrict__ src, const Walk& wk,
                                          const Unit& q, Body body) {
  const T* rows[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int hh = q.h + (i - 1) * wk.d;
    rows[i] = (hh >= 0 && hh < wk.h) ? src + ((q.b * wk.h + hh) * wk.w) * (long long)wk.c
                                     : nullptr;
  }
  auto column = [&](int k, uint4 (&dst)[3]) {
    const int col = q.r + k * wk.d;
    const bool in = col >= 0 && col < wk.w;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      dst[i] = (in && rows[i] != nullptr) ? load16(rows[i] + (long long)col * wk.c)
                                          : make_uint4(0u, 0u, 0u, 0u);
  };
  uint4 win[3][3], next[3];
  uint4 c0[3], c1[3], c2[3];
  column(q.k0 - 1, c0);
  column(q.k0, c1);
  column(q.k0 + 1, c2);
  for (int k = q.k0; k < q.k1; ++k) {
    if (k + 1 < q.k1) column(k + 2, next);  // in flight during this output
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      win[i][0] = c0[i];
      win[i][1] = c1[i];
      win[i][2] = c2[i];
    }
    body(k, win);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      c0[i] = c1[i];
      c1[i] = c2[i];
      c2[i] = next[i];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
depthwise_conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ wt, Walk wk,
                         int rotate, T* __restrict__ y) {
  constexpr int V = kVec<T>;
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
  if (cv * V >= wk.c) return;
  float wr[kTaps][V];  // this thread's channels' 9 taps, f32
#pragma unroll
  for (int t = 0; t < kTaps; ++t)
#pragma unroll
    for (int e = 0; e < V; ++e)
      wr[t][e] = f32(wt[(cv * V + e) * kTaps + (rotate ? kTaps - 1 - t : t)]);
  const T* src = x + cv * V;
  T* dst = y + cv * V;
  for (long long u = blockIdx.x; u < wk.units; u += gridDim.x) {
    const Unit q = decode(wk, u);
    T* out = dst + ((q.b * wk.h + q.h) * wk.w) * (long long)wk.c;
    walk_unit(src, wk, q, [&](int k, const uint4 (&win)[3][3]) {
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[e] = fmaf(wr[3 * i + j][e], elem<T>(win[i][j], e), acc[e]);
      *reinterpret_cast<uint4*>(out + (long long)(q.r + k * wk.d) * wk.c) = pack(acc);
    });
  }
}

// part: [gridDim.x][kTaps][c] f32, this block's sums over its units.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
depthwise_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy, Walk wk,
                       float* __restrict__ part) {
  constexpr int V = kVec<T>;
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
  if (cv * V >= wk.c) return;
  float acc[kTaps][V];
#pragma unroll
  for (int t = 0; t < kTaps; ++t)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[t][e] = 0.f;
  const T* src = x + cv * V;
  for (long long u = blockIdx.x; u < wk.units; u += gridDim.x) {
    const Unit q = decode(wk, u);
    const T* g_row = dy + ((q.b * wk.h + q.h) * wk.w) * (long long)wk.c + cv * V;
    walk_unit(src, wk, q, [&](int k, const uint4 (&win)[3][3]) {
      const uint4 g = load16(g_row + (long long)(q.r + k * wk.d) * wk.c);
      float gf[V];
#pragma unroll
      for (int e = 0; e < V; ++e) gf[e] = elem<T>(g, e);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[3 * i + j][e] = fmaf(gf[e], elem<T>(win[i][j], e), acc[3 * i + j][e]);
    });
  }
  float* p = part + (long long)blockIdx.x * kTaps * wk.c + cv * V;
#pragma unroll
  for (int t = 0; t < kTaps; ++t)
#pragma unroll
    for (int e = 0; e < V; e += 4)
      *reinterpret_cast<float4*>(p + t * wk.c + e) =
          make_float4(acc[t][e], acc[t][e + 1], acc[t][e + 2], acc[t][e + 3]);
}

// dw[c][t] = Σ_blocks part[block][t][c], in block order; one thread per (t, c).
template <typename T>
__global__ void __launch_bounds__(kFoldThreads)
depthwise_wgrad_fold_kernel(const float* __restrict__ part, int blocks, int c,
                            T* __restrict__ dw) {
  const int i = blockIdx.x * kFoldThreads + threadIdx.x;
  if (i >= kTaps * c) return;
  const int t = i / c, ch = i - t * c;
  float s = 0.f;
#pragma unroll 8
  for (int b = 0; b < blocks; ++b) s += part[((long long)b * kTaps + t) * c + ch];
  put(dw + ch * kTaps + t, s);
}

template <typename T>
bool plan_ok(const Walk& wk, int blocks, int slices, int threads) {
  constexpr int V = kVec<T>;
  return wk.units >= 1 && wk.h >= 1 && wk.w >= 1 && wk.d >= 1 && wk.c >= V && wk.c % V == 0 &&
         wk.classes >= 1 && wk.classes <= wk.d && wk.segs >= 1 && wk.run >= 1 &&
         wk.run <= kRun && blocks >= 1 && blocks <= wk.units && threads >= 1 &&
         threads <= kThreads && slices >= 1 && (long long)slices * threads * V >= wk.c &&
         slices <= 65535;
}

template <typename T>
int launch_conv(const void* x, const void* wt, const Walk& wk, int rotate, int blocks,
                int slices, int threads, void* y, cudaStream_t stream) {
  if (!plan_ok<T>(wk, blocks, slices, threads)) return (int)cudaErrorInvalidValue;
  depthwise_conv3x3_kernel<T><<<dim3(blocks, slices), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt), wk, rotate, static_cast<T*>(y));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wgrad(const void* x, const void* dy, const Walk& wk, int blocks, int slices,
                 int threads, float* part, void* dw, cudaStream_t stream) {
  if (!plan_ok<T>(wk, blocks, slices, threads)) return (int)cudaErrorInvalidValue;
  depthwise_wgrad_kernel<T><<<dim3(blocks, slices), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), wk, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int fold_blocks = (kTaps * wk.c + kFoldThreads - 1) / kFoldThreads;
  depthwise_wgrad_fold_kernel<T><<<fold_blocks, kFoldThreads, 0, stream>>>(
      part, blocks, wk.c, static_cast<T*>(dw));
  return (int)cudaGetLastError();
}

Walk make_walk(long long units, int h, int w, int c, int d, int classes, int segs, int run) {
  Walk wk;
  wk.units = units;
  wk.h = h;
  wk.w = w;
  wk.c = c;
  wk.d = d;
  wk.classes = classes;
  wk.segs = segs;
  wk.run = run;
  return wk;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, wt and y share it).  The walk
// (units, classes, segs, run) and the grid (blocks x slices of
// `threads` threads) come from the wrapper's launch plan; x and y are
// 16-byte aligned and c is a multiple of the 16-byte vector.  rotate = 1
// reads the weights turned by 180° (the input gradient, x = dy).
int depthwise_conv3x3(int dtype, const void* x, const void* wt, long long units, int h, int w,
                      int c, int d, int classes, int segs, int run, int blocks, int slices,
                      int threads, int rotate, void* y, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Walk wk = make_walk(units, h, w, c, d, classes, segs, run);
  if (dtype == 0) return launch_conv<float>(x, wt, wk, rotate, blocks, slices, threads, y, st);
  if (dtype == 1)
    return launch_conv<__nv_bfloat16>(x, wt, wk, rotate, blocks, slices, threads, y, st);
  return (int)cudaErrorInvalidValue;
}

// part holds blocks · 9 · c f32; dw is (c, 1, 3, 3) in the dtype of x and dy.
int depthwise_wgrad(int dtype, const void* x, const void* dy, long long units, int h, int w,
                    int c, int d, int classes, int segs, int run, int blocks, int slices,
                    int threads, void* part, void* dw, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Walk wk = make_walk(units, h, w, c, d, classes, segs, run);
  float* pa = static_cast<float*>(part);
  if (dtype == 0) return launch_wgrad<float>(x, dy, wk, blocks, slices, threads, pa, dw, st);
  if (dtype == 1)
    return launch_wgrad<__nv_bfloat16>(x, dy, wk, blocks, slices, threads, pa, dw, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
