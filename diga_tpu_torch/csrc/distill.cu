// Symmetric cross-view distillation loss and its gradient, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas pair of diga_tpu/ops/pallas_kernels.py:
//   B1a  _fwd_kernel (:35, driven by _ce_sum :58-82, used twice by
//        distillation_loss_pallas :122-135)
//        -> distill_partial_kernel + distill_fold_kernel  (C entry distill_loss)
//   B1b  _bwd_kernel (:85, driven by _ce_sum_grad :94-119, used twice by
//        _bwd :143-150)
//        -> distill_grad_kernel                           (C entry distill_grad)
// Both read the [clean; aug] logit stacks t (teacher) and s (student) as
// 2·npix contiguous rows of K values (NHWC, K = classes); row r < npix is
// the clean view, row npix + r the augmented view of the same pixel.
//
//   loss = Σ_r CE(t[r], s[npix+r]) / npix  +  Σ_r CE(t[npix+r], s[r]) / npix · scale
//   CE(a, b) = Σ_k −softmax(a)_k · log_softmax(b)_k, all in f32
//   ds[npix+r] = (softmax(s[npix+r]) − softmax(t[r]))     · (g · 1/npix)
//   ds[r]      = (softmax(s[r])      − softmax(t[npix+r])) · (g · scale/npix)
// The teacher gets no gradient.  The softmaxes are recomputed from the
// logits in the backward (no residuals), as the JAX VJP does.
//
// What bounds it: bytes.  A row costs a few exps and logs per class, about
// 25 operations per byte read, far below the H100's ~295 flops per byte.
// At the warm-up path's shape (6, 512, 896, 19) in bf16 the forward reads
// t and s once, 2 x 52.3 MB, about 31 us at 3.35 TB/s; the backward reads
// both and writes ds, 3 x 52.3 MB, about 47 us.
//
// What the design does about it.  The TPU kernel walked pixel tiles in a
// sequential grid and carried one scalar across it; on Hopper the blocks
// run in parallel.  So:
//   1. distill_partial_kernel: one thread per pixel (a grid-stride walk),
//      which covers both directions at once: it reads the clean and the
//      augmented row of t and of s, so each byte is read once for the two
//      CE terms.  Rows are read as they lie (K = 19 bf16 values are 38
//      bytes, not 16-byte aligned), into registers, unrolled to K <= 32.
//      Each block reduces its threads' two sums in a fixed order (warp
//      shuffles, then the warps in order) and writes two partials.
//   2. distill_fold_kernel, one block, sums the partials in a fixed order
//      and applies 1/npix and scale on the device: no float atomics, so
//      two runs are equal bit for bit, and the loss never visits the host.
//   3. distill_grad_kernel: one thread per pixel again, g read from device
//      memory, both halves of ds written into one [2·npix, K] buffer in the
//      student's type (JAX concatenates two halves; nothing to concatenate
//      here).
// A shared-memory tile with 16-byte loads is later work.
//
// Plain C interface, loaded with ctypes (diga_tpu_torch/ops/distill.py).
// Each entry launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFoldThreads = 1024;
constexpr int kMaxK = 32;

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// One row of K logits into registers (slots >= K unused).
template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int k, float (&v)[kMaxK]) {
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) v[j] = j < k ? ld(p + j) : 0.f;
}

// In place: v <- exp(v - max(v)); returns the sum of the exps.
__device__ __forceinline__ float exp_shifted(float (&v)[kMaxK], int k, float& vmax) {
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j)
    if (j < k) m = fmaxf(m, v[j]);
  float z = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < k) {
      v[j] = expf(__fsub_rn(v[j], m));
      z = __fadd_rn(z, v[j]);
    }
  }
  vmax = m;
  return z;
}

// Σ_k −softmax(t)_k · log_softmax(s)_k for one pixel.
__device__ __forceinline__ float row_ce(float (&tv)[kMaxK], const float (&sv)[kMaxK], int k) {
  float tmax;
  const float zt = exp_shifted(tv, k, tmax);
  float ms = -INFINITY;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j)
    if (j < k) ms = fmaxf(ms, sv[j]);
  float zs = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j)
    if (j < k) zs = __fadd_rn(zs, expf(__fsub_rn(sv[j], ms)));
  const float lzs = logf(zs);
  float ce = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < k) {
      const float q = __fdiv_rn(tv[j], zt);
      const float ls = __fsub_rn(__fsub_rn(sv[j], ms), lzs);
      ce = __fadd_rn(ce, -__fmul_rn(q, ls));
    }
  }
  return ce;
}

// Fixed-order block sum of one value per thread (kThreads threads);
// the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) t = __fadd_rn(t, sh[w]);
  __syncthreads();
  return t;
}

// part: [2][gridDim.x] f32 — Σ CE(t_clean, s_aug), then Σ CE(t_aug, s_clean).
template <typename T>
__global__ void __launch_bounds__(kThreads)
distill_partial_kernel(const T* __restrict__ t, const T* __restrict__ s, long long npix, int k,
                       float* __restrict__ part) {
  __shared__ float sh[kThreads / 32];
  float a0 = 0.f, a1 = 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long half = npix * k;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < npix; r += stride) {
    float tv[kMaxK], sv[kMaxK];
    load_row(t + r * k, k, tv);          // teacher, clean view
    load_row(s + half + r * k, k, sv);   // student, augmented view
    a0 = __fadd_rn(a0, row_ce(tv, sv, k));
    load_row(t + half + r * k, k, tv);   // teacher, augmented view
    load_row(s + r * k, k, sv);          // student, clean view
    a1 = __fadd_rn(a1, row_ce(tv, sv, k));
  }
  const float s0 = block_sum(a0, sh);
  const float s1 = block_sum(a1, sh);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = s0;
    part[gridDim.x + blockIdx.x] = s1;
  }
}

// One block: out = Σ part[0] / npix + Σ part[1] / npix · scale.
__global__ void __launch_bounds__(kFoldThreads)
distill_fold_kernel(const float* __restrict__ part, int n_part, float npix, float scale,
                    float* __restrict__ out) {
  __shared__ float sh0[kFoldThreads], sh1[kFoldThreads];
  float a0 = 0.f, a1 = 0.f;
  for (int i = threadIdx.x; i < n_part; i += kFoldThreads) {  // fixed order per thread
    a0 = __fadd_rn(a0, part[i]);
    a1 = __fadd_rn(a1, part[n_part + i]);
  }
  sh0[threadIdx.x] = a0;
  sh1[threadIdx.x] = a1;
  __syncthreads();
  for (int w = kFoldThreads / 2; w > 0; w >>= 1) {  // fixed tree
    if (threadIdx.x < w) {
      sh0[threadIdx.x] = __fadd_rn(sh0[threadIdx.x], sh0[threadIdx.x + w]);
      sh1[threadIdx.x] = __fadd_rn(sh1[threadIdx.x], sh1[threadIdx.x + w]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float t0 = __fdiv_rn(sh0[0], npix);
    const float t1 = __fmul_rn(__fdiv_rn(sh1[0], npix), scale);
    *out = __fadd_rn(t0, t1);
  }
}

// ds[dst row] = (softmax(s row) − softmax(t row)) · gc, in T.
template <typename T>
__device__ __forceinline__ void row_grad(const T* __restrict__ trow, const T* __restrict__ srow,
                                         T* __restrict__ drow, int k, float gc) {
  float tv[kMaxK], sv[kMaxK];
  load_row(trow, k, tv);
  load_row(srow, k, sv);
  float tmax, smax;
  const float zt = exp_shifted(tv, k, tmax);
  const float zs = exp_shifted(sv, k, smax);
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < k) {
      const float d = __fsub_rn(__fdiv_rn(sv[j], zs), __fdiv_rn(tv[j], zt));
      st(drow + j, __fmul_rn(d, gc));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
distill_grad_kernel(const T* __restrict__ t, const T* __restrict__ s,
                    const float* __restrict__ g, long long npix, int k, float coeff_clean,
                    float coeff_aug, T* __restrict__ ds) {
  const float gv = __ldg(g);
  const float gc_clean = __fmul_rn(gv, coeff_clean);
  const float gc_aug = __fmul_rn(gv, coeff_aug);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long half = npix * k;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < npix; r += stride) {
    // student aug row learns from the teacher's clean row (weight 1)
    row_grad(t + r * k, s + half + r * k, ds + half + r * k, k, gc_aug);
    // student clean row learns from the teacher's aug row (weight scale)
    row_grad(t + half + r * k, s + r * k, ds + r * k, k, gc_clean);
  }
}

template <typename T>
int launch_loss(const void* t, const void* s, long long npix, int k, float scale, int n_blocks,
                float* part, float* out, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || npix < 1 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  distill_partial_kernel<T><<<n_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(t), static_cast<const T*>(s), npix, k, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  distill_fold_kernel<<<1, kFoldThreads, 0, stream>>>(part, n_blocks, (float)npix, scale, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_grad(const void* t, const void* s, const float* g, long long npix, int k,
                float coeff_clean, float coeff_aug, int n_blocks, void* ds, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || npix < 1 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  distill_grad_kernel<T><<<n_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(t), static_cast<const T*>(s), g, npix, k, coeff_clean, coeff_aug,
      static_cast<T*>(ds));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (t and s share it).  part holds
// 2·n_blocks f32; out is one f32.
int distill_loss(int dtype, const void* t, const void* s, long long npix, int k, float scale,
                 int n_blocks, void* part, void* out, void* stream) {
  const cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return launch_loss<float>(t, s, npix, k, scale, n_blocks, pa, o, st_);
  if (dtype == 1) return launch_loss<__nv_bfloat16>(t, s, npix, k, scale, n_blocks, pa, o, st_);
  return (int)cudaErrorInvalidValue;
}

// g: one f32 on the device (the loss's incoming gradient); ds: [2·npix, k] in
// the dtype of s.
int distill_grad(int dtype, const void* t, const void* s, const void* g, long long npix, int k,
                 float coeff_clean, float coeff_aug, int n_blocks, void* ds, void* stream) {
  const cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  if (dtype == 0)
    return launch_grad<float>(t, s, gp, npix, k, coeff_clean, coeff_aug, n_blocks, ds, st_);
  if (dtype == 1)
    return launch_grad<__nv_bfloat16>(t, s, gp, npix, k, coeff_clean, coeff_aug, n_blocks, ds,
                                      st_);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
