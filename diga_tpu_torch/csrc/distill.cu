// Symmetric cross-view distillation loss and its gradient, hand-written for
// Hopper (sm_90a) as a tiled, persistent design.
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
// Budget.  At the warm-up path's shape (6, 512, 896, 19) in bf16, t and s
// are 104.6 MB each.  The forward reads both once: 209.2 MB, 62.45 us at
// 3.35 TB/s.  The backward reads both and writes ds: 313.8 MB, 93.67 us.
// None of this runs on the tensor cores (so the ~295 operations per byte of
// the bf16 tensor-core rate do not apply): it runs on the FP32 lanes and the
// special-function unit (SFU).  In 62.45 us, 132 SMs x 128 lanes at about
// 1.75 GHz issue about 18 lane-instructions per element read, and the SFU
// (16 per SM per clock) about 2.2 ops; the backward, which also writes, has
// about 26 and 3.3.  So the budget is about 10 lane-instructions and at most
// 2 SFU ops per element read.  Counted in the built code (cuobjdump -sass),
// steady state, bf16: forward about 10.5 (max pass 3.5: shared load,
// convert, max; exp pass 7: shared load, convert, FFMA, ex2, add into z,
// and for the student row the cross term's FADD + FFMA) and 1 SFU op;
// backward about 17
// (max 3.5, z 6, ds 7.6) and 2 SFU ops; per row one reciprocal (two in the
// backward) and, in the forward, one log.
//
// What the design does about the four limits of the first port (one thread
// per pixel reading rows straight from device memory):
//   1. Scalar loads of unaligned 38-byte rows.  A block takes a tile of R
//      pixels (R a multiple of 32, so R·K·elem is a multiple of 16 for any
//      K) and copies its four contiguous spans of R·K values (t clean, t aug,
//      s clean, s aug) into shared memory with the TMA's 1-D bulk copy
//      (cp.async.bulk, issued by one thread, completing on the stage's
//      mbarrier), through a ring of two tiles, so the next tile's copy
//      overlaps this tile's arithmetic.  R = 256 bytes / elem: 128 pixels
//      in bf16, 64 in f32.  The grid is persistent (as many
//      blocks as fit on the SMs at once), each block walking tiles b,
//      b + grid, ...  The ragged last tile copies its 16-byte chunks the
//      same way and the rest one value per thread; where a span's start is
//      not 16-byte aligned (npix·K·elem not a multiple of 16, or an offset
//      base pointer: flag `vec` = 0) the block copies every value itself,
//      neighbouring threads on neighbouring addresses.
//   2. A quarter of the SM's threads resident.  No row is held in
//      registers: thread d·R + p streams pixel p's teacher and student rows
//      of direction d from shared memory with a handful of scalars live (a
//      max, a sum and a cross term per row); about 30 registers, no spills,
//      under __launch_bounds__(256, 4) (at most 64).  Small tiles put
//      several blocks on an SM, so one block's per-tile barrier is hidden by
//      the others.
//   3. Too much arithmetic per byte.  Max first, then each exp as ex2.approx
//      of x·log2e − max·log2e (one FFMA, one SFU op); one reciprocal per row
//      in place of a division per class; no per-class log-softmax: per
//      pixel CE = ln z_s − (Σ_k e_t,k · (s_k − m_s)) / z_t, the same shifted
//      terms as before.
//   4. B1b's 2-byte scattered stores.  ds_k = e_s,k · (gc / z_s) −
//      e_t,k · (gc / z_t) (one FMUL and one FFMA per class, the exps
//      recomputed from the tile) goes into a shared-memory output tile,
//      which one thread then stores with bulk copies (shared -> global) of
//      the two contiguous ds spans, whole 16-byte chunks.
// Determinism: each thread sums its pixels in walk order, each block its
// threads in a fixed order, and distill_fold_kernel (one block, a second
// launch) sums the per-block partials in index order and applies 1/npix and
// scale on the device: no float atomics, two runs equal bit for bit.
//
// The tile and the ring depth are the constants below; the wrapper
// (diga_tpu_torch/ops/distill.py::launch_plan, which repeats them and
// smem_bytes) chooses the persistent grid and the 16-byte path.  Plain C
// interface, loaded with ctypes.
// Each entry launches on the caller's stream, allocates nothing and returns
// the first CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileBytes = 256;  // one class over a tile's pixels: R = kTileBytes / elem
constexpr int kStages = 2;       // input tiles in the shared-memory ring
constexpr int kMaxThreads = kTileBytes;  // two threads per pixel, R <= 128
constexpr int kFoldThreads = 256;
constexpr int kMaxK = 32;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// 2^x on the SFU (relative error about 2^-22).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarrier and 1-D bulk copies (the TMA without a tensor map).
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival of a phase, which also expects `bytes` of bulk copies.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until the bulk stores of this thread have read their shared-memory source.
__device__ __forceinline__ void bulk_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's shared-memory writes before later bulk copies read them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The persistent walk: block b takes tiles b, b + grid, b + 2·grid, ...
// A tile is R = kTile<T> pixels (2R threads a block); its stage holds
// four spans of R·K values: t clean, t aug, s clean, s aug.  Thread
// d·R + p takes pixel p of the tile in direction d (0: t clean with s aug,
// 1: t aug with s clean); R is a multiple of 32, so d is uniform per warp.
template <typename T>
constexpr int kTile = kTileBytes / (int)sizeof(T);

template <typename T>
struct Walk {
  static constexpr int r = kTile<T>;
  long long npix;
  int k, rk;  // rk = R·K (the length of one span)
  long long n_tiles;

  __device__ Walk(long long npix_, int k_) : npix(npix_), k(k_), rk(r * k_) {
    n_tiles = (npix + r - 1) / r;
  }
  __device__ long long tile(int i) const { return blockIdx.x + (long long)i * gridDim.x; }
  __device__ int values(long long tile) const {  // valid values in each span of a tile
    return (int)min((long long)r, npix - tile * r) * k;
  }
};

// How many of a span's n values go through bulk copies: the 16-byte chunks
// where vec (every span starts 16-byte aligned), else none.
template <typename T>
__device__ __forceinline__ int bulk_values(int n, bool vec) {
  constexpr int per = 16 / sizeof(T);
  return vec ? n / per * per : 0;
}

// Starts the copy of a tile's four spans into a stage: thread 0 issues the
// bulk copies (completing on the stage's mbarrier) and the block copies the
// rest one value per thread, neighbouring threads on neighbouring addresses.
template <typename T>
__device__ __forceinline__ void load_tile(T* stage, uint64_t* bar, const T* __restrict__ t,
                                          const T* __restrict__ s, const Walk<T>& w, long long tile,
                                          bool vec) {
  if (tile >= w.n_tiles) return;
  const long long off = tile * w.r * w.k, half = w.npix * w.k;
  const int n = w.values(tile), nb = bulk_values<T>(n, vec);
  const T* src[4] = {t + off, t + half + off, s + off, s + half + off};
  if (threadIdx.x == 0) {
    mbar_arrive_expect(bar, 4 * nb * sizeof(T));
    for (int j = 0; j < 4 && nb > 0; ++j)
      bulk_load(stage + j * w.rk, src[j], nb * sizeof(T), bar);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    for (int e = nb + threadIdx.x; e < n; e += blockDim.x) stage[j * w.rk + e] = src[j][e];
}

// The ring: kStages stages of four spans each, one mbarrier per stage.
// Initialises the barriers and starts the copies of the first kStages - 1 tiles.
template <typename T>
__device__ __forceinline__ void prologue(T* ring, uint64_t* bars, const T* t, const T* s,
                                         const Walk<T>& w, bool vec) {
  if (threadIdx.x == 0) {
    for (int j = 0; j < kStages; ++j) mbar_init(bars + j);
    mbar_init_fence();
  }
  __syncthreads();
  for (int j = 0; j < kStages - 1; ++j)
    load_tile(ring + j * 4 * w.rk, bars + j, t, s, w, w.tile(j), vec);
}

// Before tile i: start the copy of tile i + kStages - 1 into the stage that
// tile i - 1 used, wait for tile i's copy, and return tile i's stage.
template <typename T>
__device__ __forceinline__ const T* advance(T* ring, uint64_t* bars, const T* t, const T* s,
                                            const Walk<T>& w, int i, bool vec) {
  const int next = (i + kStages - 1) % kStages, cur = i % kStages;
  load_tile(ring + next * 4 * w.rk, bars + next, t, s, w, w.tile(i + kStages - 1), vec);
  mbar_wait(bars + cur, (i / kStages) & 1);  // the stage's (i / kStages)-th phase
  __syncthreads();  // and the values the block copied itself
  return ring + cur * 4 * w.rk;
}

// The max of one row.
template <typename T>
__device__ __forceinline__ float row_max(const T* x, int k) {
  float m = -INFINITY;
#pragma unroll 4
  for (int j = 0; j < k; ++j) m = fmaxf(m, f32(x[j]));
  return m;
}

// CE(t row, s row) = ln z_s − (Σ_k e_t,k · (s_k − m_s)) / z_t.
template <typename T>
__device__ __forceinline__ float pair_ce(const T* tr, const T* sr, int k) {
  const float ms = row_max(sr, k);
  const float bt = row_max(tr, k) * kLog2e, bs = ms * kLog2e;
  float zt = 0.f, zs = 0.f, d = 0.f;
#pragma unroll 4
  for (int j = 0; j < k; ++j) {
    const float xs = f32(sr[j]);
    const float et = ex2(fmaf(f32(tr[j]), kLog2e, -bt));
    zt += et;
    zs += ex2(fmaf(xs, kLog2e, -bs));
    d = fmaf(et, xs - ms, d);
  }
  return logf(zs) - d * __frcp_rn(zt);
}

// Fixed-order block sum of one value per thread; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < (int)blockDim.x / 32; ++i) t += red[i];
  __syncthreads();
  return t;
}

// part: [2][gridDim.x] f32 — Σ CE(t_clean, s_aug), then Σ CE(t_aug, s_clean).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 4)
distill_partial_kernel(const T* __restrict__ t, const T* __restrict__ s, long long npix, int k,
                       int vec, float* __restrict__ part) {
  // the ring starts 128-byte aligned: the TMA writes into it, and a start
  // only 16-byte aligned (behind 48 bytes of static shared memory) made
  // both kernels slower on the H100 (PERF.md)
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[kMaxThreads / 32];
  __shared__ uint64_t bars[kStages];
  T* ring = reinterpret_cast<T*>(smem);
  const Walk<T> w(npix, k);
  const int d = threadIdx.x / w.r, p = threadIdx.x - d * w.r;
  prologue(ring, bars, t, s, w, vec);
  float a = 0.f;
  for (int i = 0; w.tile(i) < w.n_tiles; ++i) {
    const T* stage = advance(ring, bars, t, s, w, i, vec);
    if (w.tile(i) * w.r + p < npix)
      a += pair_ce(stage + d * w.rk + p * k, stage + (3 - d) * w.rk + p * k, k);
    __syncthreads();  // the stage is refilled next
  }
  const float s0 = block_sum(d == 0 ? a : 0.f, red);
  const float s1 = block_sum(d == 1 ? a : 0.f, red);
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

// One ds row: ds_k = e_s,k · (gc / z_s) − e_t,k · (gc / z_t), into o.
template <typename T>
__device__ __forceinline__ void pair_grad(const T* tr, const T* sr, int k, float gc, T* o) {
  const float bt = row_max(tr, k) * kLog2e, bs = row_max(sr, k) * kLog2e;
  float zt = 0.f, zs = 0.f;
#pragma unroll 4
  for (int j = 0; j < k; ++j) {
    zt += ex2(fmaf(f32(tr[j]), kLog2e, -bt));
    zs += ex2(fmaf(f32(sr[j]), kLog2e, -bs));
  }
  const float ct = gc * __frcp_rn(zt), cs = gc * __frcp_rn(zs);
#pragma unroll 4
  for (int j = 0; j < k; ++j) {
    const float et = ex2(fmaf(f32(tr[j]), kLog2e, -bt));
    const float es = ex2(fmaf(f32(sr[j]), kLog2e, -bs));
    put(o + j, fmaf(es, cs, -(et * ct)));
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 4)
distill_grad_kernel(const T* __restrict__ t, const T* __restrict__ s,
                    const float* __restrict__ g, long long npix, int k, float coeff_clean,
                    float coeff_aug, int vec, T* __restrict__ ds) {
  extern __shared__ __align__(128) unsigned char smem[];  // as above
  __shared__ uint64_t bars[kStages];
  T* ring = reinterpret_cast<T*>(smem);
  const Walk<T> w(npix, k);
  T* out = ring + kStages * 4 * w.rk;  // ds clean, then ds aug, R·K values each
  const float gv = __ldg(g);
  const float gc_clean = __fmul_rn(gv, coeff_clean);
  const float gc_aug = __fmul_rn(gv, coeff_aug);
  const long long half = npix * k;
  // direction 0: the student's aug row learns from the teacher's clean row
  // (weight 1) into ds aug; direction 1: clean from aug (weight scale)
  const int d = threadIdx.x / w.r, p = threadIdx.x - d * w.r;
  const float gc = d == 0 ? gc_aug : gc_clean;
  prologue(ring, bars, t, s, w, vec);
  for (int i = 0; w.tile(i) < w.n_tiles; ++i) {
    // the output tile is rewritten below: thread 0's bulk stores of the last
    // tile must have read it (the barrier in advance orders the rest)
    if (threadIdx.x == 0) bulk_store_wait_read();
    const T* stage = advance(ring, bars, t, s, w, i, vec);
    const long long tile = w.tile(i);
    if (tile * w.r + p < npix)
      pair_grad(stage + d * w.rk + p * k, stage + (3 - d) * w.rk + p * k, k, gc,
                out + (1 - d) * w.rk + p * k);
    fence_proxy_async();
    __syncthreads();
    // the output tile to ds: 16-byte chunks as bulk stores, the rest per thread
    const long long off = tile * w.r * k;
    const int n = w.values(tile), nb = bulk_values<T>(n, vec);
    if (threadIdx.x == 0 && nb > 0) {
      bulk_store(ds + off, out, nb * sizeof(T));
      bulk_store(ds + half + off, out + w.rk, nb * sizeof(T));
      bulk_store_commit();
    }
    for (int e = nb + threadIdx.x; e < n; e += blockDim.x) {
      ds[off + e] = out[e];
      ds[half + off + e] = out[w.rk + e];
    }
    __syncthreads();  // the stage is refilled next
  }
  if (threadIdx.x == 0) bulk_store_wait_read();  // before the shared memory is released
}

bool plan_ok(long long npix, int k, int grid) {
  return k >= 1 && k <= kMaxK && npix >= 1 && grid >= 1;
}

// Dynamic shared memory of one block: the ring of input tiles, and for the
// backward the two-span output tile (the same formula as ops/distill.py).
int smem_bytes(bool backward, int k) {
  return (4 * kStages + (backward ? 2 : 0)) * kTileBytes * k;
}

template <typename T>
int launch_loss(const void* t, const void* s, long long npix, int k, float scale, int grid,
                int vec, float* part, float* out, cudaStream_t stream) {
  if (!plan_ok(npix, k, grid)) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(false, k);
  cudaError_t err = cudaFuncSetAttribute(distill_partial_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  distill_partial_kernel<T><<<grid, 2 * kTile<T>, smem, stream>>>(
      static_cast<const T*>(t), static_cast<const T*>(s), npix, k, vec, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  distill_fold_kernel<<<1, kFoldThreads, 0, stream>>>(part, grid, (float)npix, scale, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_grad(const void* t, const void* s, const float* g, long long npix, int k,
                float coeff_clean, float coeff_aug, int grid, int vec, void* ds,
                cudaStream_t stream) {
  if (!plan_ok(npix, k, grid)) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(true, k);
  cudaError_t err = cudaFuncSetAttribute(distill_grad_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  distill_grad_kernel<T><<<grid, 2 * kTile<T>, smem, stream>>>(
      static_cast<const T*>(t), static_cast<const T*>(s), g, npix, k, coeff_clean, coeff_aug,
      vec, static_cast<T*>(ds));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (t and s share it).  grid and vec
// (16-byte copies) come from the wrapper's launch plan.  part holds 2·grid
// f32; out is one f32.
int distill_loss(int dtype, const void* t, const void* s, long long npix, int k, float scale,
                 int grid, int vec, void* part, void* out, void* stream) {
  const cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return launch_loss<float>(t, s, npix, k, scale, grid, vec, pa, o, st_);
  if (dtype == 1) return launch_loss<__nv_bfloat16>(t, s, npix, k, scale, grid, vec, pa, o, st_);
  return (int)cudaErrorInvalidValue;
}

// g: one f32 on the device (the loss's incoming gradient); ds: [2·npix, k] in
// the dtype of s.
int distill_grad(int dtype, const void* t, const void* s, const void* g, long long npix, int k,
                 float coeff_clean, float coeff_aug, int grid, int vec, void* ds, void* stream) {
  const cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  if (dtype == 0)
    return launch_grad<float>(t, s, gp, npix, k, coeff_clean, coeff_aug, grid, vec, ds, st_);
  if (dtype == 1)
    return launch_grad<__nv_bfloat16>(t, s, gp, npix, k, coeff_clean, coeff_aug, grid, vec, ds,
                                      st_);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
