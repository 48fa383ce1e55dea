// GroupNorm forward over NHWC activations, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas pair of diga_tpu/ops/pallas_gn.py:
//   B2a  _stats_kernel (:53, driven by _channel_stats :78-102)
//        -> gn_partial_kernel + gn_fold_kernel  (C entry gn_stats)
//   B2b  _norm_kernel  (:74, driven by _apply_affine :105-126)
//        -> gn_apply_kernel                     (C entry gn_apply)
// with the arithmetic of group_norm_pallas (:129-153) and the FusedGroupNorm
// formula (diga_tpu/models/resnet_deeplab.py:225-234):
//   per-channel Σx, Σx² in f32 over H·W; fold into G groups, n = H·W·(C/G);
//   mean = Σx/n; var = max(Σx²/n − mean², 0); inv = 1/sqrt(var + eps);
//   mul = (inv·scale) cast to x's type; add = (bias − mean·inv·scale) cast;
//   y = x·mul + add in x's type (the product rounded before the add).
//
// What bounds it: bytes.  The work is a few flops per element on the FP32
// lanes, far below the ~20 f32 operations per byte they allow (67 TFLOP/s
// over 3.35 TB/s; the tensor cores do no part of it), so the floor is
// moving the activation through HBM.  At the eval path's full-scale site (1, 129, 257, 256) in
// bf16, reading x once and writing y once is 2 x 16.97 MB, about 10.1 us
// at 3.35 TB/s; the half-scale site (1, 65, 129, 256) is 2 x 4.29 MB,
// about 2.6 us.
//
// What the design does about it.  The TPU kernel carried one running sum
// across a sequential grid; on Hopper the blocks run in parallel and at
// batch 1 there are only 32 (image, group) pairs, too few for 132 SMs.  So:
//   1. gn_partial_kernel tiles each image into row chunks (about two blocks
//      per SM over the whole batch).  Threads read 16 bytes each along the
//      contiguous C axis (neighbouring threads on neighbouring addresses),
//      keep four row loads in flight, accumulate in f32 registers, reduce
//      the block's rows through shared memory in a fixed order and write
//      one partial (Σx, Σx²) row per chunk.
//   2. gn_fold_kernel, one block per (group, image), sums the partials in
//      a fixed order, writes the per-channel sums, folds the group and
//      writes mul/add per (image, channel).
//   3. gn_apply_kernel streams x once more with 16-byte loads and stores.
// No float atomics: every sum has a fixed order, so repeated runs match
// bit for bit.  The two-pass form reads x twice (the apply pass often
// finds it in the 50 MB L2); a one-pass or fused form is later work.
//
// Plain C interface, loaded with ctypes (diga_tpu_torch/ops/group_norm.py).
// Each entry launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsInFlight = 4;

// 16 bytes of T as floats: 4 f32 or 8 bf16 values.
template <typename T> struct Pack;

template <> struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&v)[N]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  __device__ static void store(float* p, const float (&v)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static float round(float v) { return v; }
  __device__ static float cast(float v) { return v; }
};

template <> struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&v)[N]) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[N]) {
    uint4 a;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = a;
  }
  __device__ static float round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
  __device__ static __nv_bfloat16 cast(float v) { return __float2bfloat16_rn(v); }
};

// Block (bx, by): bx = C / N threads across the channel vectors of a row,
// by rows at a time.  Grid (n_chunks, batch).  part holds two planes of
// [batch, n_chunks, C] f32: Σx, then Σx² (part_plane floats apart).
template <typename T>
__global__ void gn_partial_kernel(const T* __restrict__ x, float* __restrict__ part,
                                  int hw, int c, int rows_per_chunk, int n_chunks,
                                  long long part_plane) {
  constexpr int N = Pack<T>::N;
  extern __shared__ float sh[];  // [2][by][N][bx]
  const int v = threadIdx.x, ty = threadIdx.y;
  const int bx = blockDim.x, by = blockDim.y;
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(r0 + rows_per_chunk, hw);
  const T* base = x + (long long)b * hw * c + (long long)v * N;

  float s[N], s2[N];
#pragma unroll
  for (int k = 0; k < N; ++k) s[k] = s2[k] = 0.f;

  int r = r0 + ty;
  for (; r + (kRowsInFlight - 1) * by < r1; r += kRowsInFlight * by) {
    float a[kRowsInFlight][N];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) Pack<T>::load(base + (long long)(r + u * by) * c, a[u]);
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        s[k] += a[u][k];
        s2[k] += a[u][k] * a[u][k];
      }
    }
  }
  for (; r < r1; r += by) {
    float a[N];
    Pack<T>::load(base + (long long)r * c, a);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      s[k] += a[k];
      s2[k] += a[k] * a[k];
    }
  }

  float* out_s = part + ((long long)b * n_chunks + chunk) * c;
  float* out_s2 = out_s + part_plane;
  if (by == 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      out_s[v * N + k] = s[k];
      out_s2[v * N + k] = s2[k];
    }
    return;
  }
  // [t][k][v] layout: consecutive threads touch consecutive banks
  float* sh_s = sh;
  float* sh_s2 = sh + by * N * bx;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    sh_s[(ty * N + k) * bx + v] = s[k];
    sh_s2[(ty * N + k) * bx + v] = s2[k];
  }
  __syncthreads();
  const int tid = ty * bx + v, nt = bx * by;
  for (int j = tid; j < N * bx; j += nt) {
    const int k = j / bx, vv = j % bx;
    float a = 0.f, a2 = 0.f;
    for (int t = 0; t < by; ++t) {  // fixed order
      a += sh_s[(t * N + k) * bx + vv];
      a2 += sh_s2[(t * N + k) * bx + vv];
    }
    out_s[vv * N + k] = a;
    out_s2[vv * N + k] = a2;
  }
}

// Grid (groups, batch), kThreads threads.  cg = C / groups channels per
// block; the threads split into `lanes` strided walks over the chunks.
template <typename T>
__global__ void gn_fold_kernel(const float* __restrict__ part, int n_chunks, int c, int groups,
                               long long part_plane, const float* __restrict__ scale,
                               const float* __restrict__ bias, float n, float eps,
                               float* __restrict__ sums, float* __restrict__ sumsq,
                               T* __restrict__ mul, T* __restrict__ add) {
  __shared__ float red_s[kThreads], red_s2[kThreads];
  __shared__ float ch_s[kThreads], ch_s2[kThreads];
  const int g = blockIdx.x, b = blockIdx.y;
  const int cg = c / groups;
  const int lanes = kThreads / cg;
  const int j = threadIdx.x % cg, lane = threadIdx.x / cg;
  const int ch = g * cg + j;

  float a = 0.f, a2 = 0.f;
  if (lane < lanes) {
    const float* ps = part + (long long)b * n_chunks * c + ch;
    for (int k = lane; k < n_chunks; k += lanes) {  // fixed order per lane
      a += ps[(long long)k * c];
      a2 += ps[part_plane + (long long)k * c];
    }
  }
  red_s[threadIdx.x] = a;
  red_s2[threadIdx.x] = a2;
  __syncthreads();

  const long long o = (long long)b * c + g * cg + threadIdx.x;
  if (threadIdx.x < cg) {
    float t = 0.f, t2 = 0.f;
    for (int l = 0; l < lanes; ++l) {
      t += red_s[l * cg + threadIdx.x];
      t2 += red_s2[l * cg + threadIdx.x];
    }
    ch_s[threadIdx.x] = t;
    ch_s2[threadIdx.x] = t2;
    sums[o] = t;
    sumsq[o] = t2;
  }
  __syncthreads();

  if (threadIdx.x < cg) {
    float gs = 0.f, gs2 = 0.f;
    for (int i = 0; i < cg; ++i) {
      gs += ch_s[i];
      gs2 += ch_s2[i];
    }
    const int cc = g * cg + threadIdx.x;
    const float mu = __fdiv_rn(gs, n);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(gs2, n), __fmul_rn(mu, mu)), 0.f);
    const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    const float inv_s = __fmul_rn(inv, scale[cc]);
    mul[o] = Pack<T>::cast(inv_s);
    add[o] = Pack<T>::cast(__fsub_rn(bias[cc], __fmul_rn(mu, inv_s)));
  }
}

// Grid-stride over 16-byte vectors of x; mul/add are [batch, C] in T.
template <typename T>
__global__ void gn_apply_kernel(const T* __restrict__ x, const T* __restrict__ mul,
                                const T* __restrict__ add, T* __restrict__ y,
                                long long n_vec, int c, long long hwc) {
  constexpr int N = Pack<T>::N;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec; i += stride) {
    const long long e = i * N;
    const long long p = (e / hwc) * c + e % c;
    float xv[N], m[N], a[N], out[N];
    Pack<T>::load(x + e, xv);
    Pack<T>::load(mul + p, m);
    Pack<T>::load(add + p, a);
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = __fadd_rn(Pack<T>::round(__fmul_rn(xv[k], m[k])), a[k]);
    Pack<T>::store(y + e, out);
  }
}

template <typename T>
int launch_stats(const void* x, int batch, int hw, int c, int groups, int rows_per_chunk,
                 int n_chunks, float n, float eps, const float* scale, const float* bias,
                 float* part, float* sums, float* sumsq, void* mul, void* add,
                 cudaStream_t stream) {
  constexpr int N = Pack<T>::N;
  const int bx = c / N;
  if (c % N != 0 || bx > 1024 || c % groups != 0 || c / groups > kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const int by = bx >= kThreads ? 1 : kThreads / bx;
  const size_t smem = by > 1 ? 2 * sizeof(float) * by * N * bx : 0;
  const long long part_plane = (long long)batch * n_chunks * c;
  gn_partial_kernel<T><<<dim3(n_chunks, batch), dim3(bx, by), smem, stream>>>(
      static_cast<const T*>(x), part, hw, c, rows_per_chunk, n_chunks, part_plane);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_fold_kernel<T><<<dim3(groups, batch), kThreads, 0, stream>>>(
      part, n_chunks, c, groups, part_plane, scale, bias, n, eps, sums, sumsq,
      static_cast<T*>(mul), static_cast<T*>(add));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_apply(const void* x, const void* mul, const void* add, void* y, long long n_elems,
                 int c, long long hwc, int n_blocks, cudaStream_t stream) {
  constexpr int N = Pack<T>::N;
  if (c % N != 0 || n_elems % N != 0 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  gn_apply_kernel<T><<<n_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(mul), static_cast<const T*>(add),
      static_cast<T*>(y), n_elems / N, c, hwc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.
int gn_stats(int dtype, const void* x, int batch, int hw, int c, int groups, int rows_per_chunk,
             int n_chunks, float n, float eps, const void* scale, const void* bias, void* part,
             void* sums, void* sumsq, void* mul, void* add, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* pa = static_cast<float*>(part);
  float* su = static_cast<float*>(sums);
  float* sq = static_cast<float*>(sumsq);
  if (dtype == 0)
    return launch_stats<float>(x, batch, hw, c, groups, rows_per_chunk, n_chunks, n, eps, sc, bi,
                               pa, su, sq, mul, add, s);
  if (dtype == 1)
    return launch_stats<__nv_bfloat16>(x, batch, hw, c, groups, rows_per_chunk, n_chunks, n, eps,
                                       sc, bi, pa, su, sq, mul, add, s);
  return (int)cudaErrorInvalidValue;
}

int gn_apply(int dtype, const void* x, const void* mul, const void* add, void* y,
             long long n_elems, int c, long long hwc, int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_apply<float>(x, mul, add, y, n_elems, c, hwc, n_blocks, s);
  if (dtype == 1) return launch_apply<__nv_bfloat16>(x, mul, add, y, n_elems, c, hwc, n_blocks, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
