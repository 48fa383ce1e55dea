// GroupNorm forward over NHWC activations, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas pair of diga_tpu/ops/pallas_gn.py:
//   B2a  _stats_kernel (:53, driven by _channel_stats :78-102) and the group
//        fold of group_norm_pallas (:145-151)
//        -> gn_stats_kernel, one launch      (C entry gn_stats)
//   B2b  _norm_kernel  (:74, driven by _apply_affine :105-126)
//        -> gn_apply_kernel                  (C entry gn_apply; gn_forward
//                                             launches the pair)
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
// moving the activation through HBM.  At the eval path's full-scale site
// (1, 129, 257, 256) in bf16, B2a reads x once, 16.97 MB, about 5.1 us at
// 3.35 TB/s, and B2b reads and writes it, about 10.1 us; the half-scale
// site (1, 65, 129, 256) is a quarter of that.  At 5 us, a second launch,
// a fold that walks hundreds of partial rows, or a thread that waits on
// four 16-byte loads at a time is a large share.
//
// B2a's design, one launch per call:
//   1. Rows.  In NHWC the rows of an image are one contiguous span.  Each
//      image's H·W rows are split evenly (to a row) into n_chunks runs, one
//      per block; a block's run is cut into tiles of kTileBytes / (C·elem)
//      rows (at least one), every tile a contiguous span of a whole number
//      of rows: C % 32 == 0 and x 16-byte aligned, so each span is a
//      16-byte multiple at a 16-byte aligned address.
//   2. Bytes in flight.  One thread copies the block's tiles into a ring of
//      kStages shared-memory stages with the TMA's 1-D bulk copy
//      (cp.async.bulk completing on the stage's mbarrier), kStages tiles in
//      flight from the start and no register spent on a copy.  The threads
//      sum columns out of shared memory: thread (lane, v) takes 16-byte
//      channel vector v of rows lane, lane + lanes, ... of each tile
//      (neighbouring threads on neighbouring banks), in f32 registers.
//   3. Few partial rows.  The blocks of an image form thread-block clusters
//      of kCluster along the chunk axis (grid (n_chunks, batch); the wrapper
//      sizes n_chunks from cudaOccupancyMaxActiveClusters through
//      gn_stats_max_clusters).  Rank r of a cluster owns slice r of the
//      channels (C / kCluster channels, whole groups).  A block folds its
//      lanes in order through shared memory and sends each float4 of its
//      (Σx, Σx²) row to the slice's owner with st.async, which completes on
//      the owner's mbarrier; the owner sums the ranks' rows in rank order
//      and writes the cluster's row of its slice.  The cluster barrier is
//      split: a block arrives when its ring is free and waits only before
//      its first remote store, so the barrier costs nothing but the wait for
//      the cluster's slowest block.
//   4. The fold in the same launch.  Each block then takes an integer
//      ticket for (image, slice) (atom.add.acq_rel on an unsigned, after a
//      __syncthreads).  The block that draws the slice's last ticket reads
//      the slice's cluster rows in index order (one round of loads), writes
//      Σx and Σx² of its channels, folds their groups into mul/add with the
//      scale and bias it loaded at its start (the arithmetic of PR 1's fold,
//      unchanged) and resets the ticket to 0 for the next launch on its
//      stream, so kCluster blocks fold an image in parallel.  No float
//      atomics: the result does not depend on which block came last, so
//      repeated runs match bit for bit.
//   What bounds it now (on an H100 80GB HBM3, gn_probe.py, PERF.md): at the
//   full-scale site the blocks finish reading x about 8 us after they
//   start, and the exchange, the ticket (two L2 round trips) and the fold
//   (one more) add about 2.7 us.  Every block triggers B2b's launch (below)
//   as its ring drains, so that tail is B2b's to use.
//
// B2b replaces _norm_kernel: y = round_to_T(x·mul) + add, mul/add per
// (image, channel).  It is bound by bytes (read x, write y: 10.1 us at the
// full-scale site, 2.56 us at the half-scale one), and at 3-24 us of work an
// empty launch (about 2 us) and the gap after the kernel before it are a
// large share.  Its design:
//   1. Under B2a's tail.  gn_forward launches B2a and then B2b from one host
//      call, B2b with the programmatic stream serialization attribute
//      (programmatic dependent launch).  Every B2a block issues
//      griddepcontrol.launch_dependents once its ring is drained, so B2b's
//      blocks start while B2a exchanges, draws tickets and folds, and load
//      their first rows of x then; griddepcontrol.wait comes before mul and
//      add.  The rule that makes this safe: before its wait a B2b block
//      reads nothing that the kernel launched just before it writes, and B2a
//      only reads x.  A bare gn_apply may follow the kernel that wrote x (a
//      conv), so it launches B2b without the attribute, in stream order,
//      where the wait returns at once.
//   2. A block-tiled grid.  Grid (chunks, batch): block (chunk, b) writes an
//      even split of image b's rows, apply_threads(C) threads, a multiple of
//      C/N, so thread (lane, v) owns one 16-byte channel vector: its mul and
//      add are loaded once, into registers, and no 64-bit division is left
//      per vector.  apply_plan (ops/group_norm.py) sets chunks: a few blocks
//      a SM, shared out over the batch.
//   3. Rows in registers.  A thread loads kApplyRows of its rows (16-byte
//      loads, L2 only) before it stores any, and stores y with 16-byte
//      stores.  Its shared memory is the image's mul and add alone (2·C
//      values, read once a block), so a block lands beside B2a blocks that
//      still hold their rings.  The tiled form (gn_probe.py --apply: 8 KB
//      tiles bulk-copied into a ring of three under the same launch, y
//      written over x and bulk-stored) was slower at every path site: the
//      bulk copies read x more slowly than 16-byte loads at these sizes,
//      and 16-byte stores out of the ring were slower still.
//   What bounds it now (H100 80GB HBM3 at 700 W, chip_smoke.py phase 8 and
//   gn_probe.py --apply, PERF.md): alone, B2b takes 12.3 / 5.4 / 16.3 /
//   9.4 / 22.9 us at the five path sites against byte bounds of 10.1 /
//   2.6 / 13.5 / 6.7 / 18.0, within a microsecond of the grid-stride kernel
//   it replaces; an empty launch is 2.0 us, and reading x alone 8.9 us at
//   the full-scale site and 4.9 at the half-scale one.  Under B2a's tail
//   the launch and the first loads are hidden: the pair takes 1.7-2.9 us
//   less than B2a and then B2b.
//
// The constants below are repeated in diga_tpu_torch/ops/group_norm.py (a
// CPU test holds them equal), whose stats_plan and apply_plan choose the
// grids.  Plain C interface, loaded with ctypes.  Each entry launches on the
// caller's stream, allocates nothing and returns the first CUDA error.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;      // B2a: one per 16-byte vector of a row, at most
constexpr int kTileBytes = 16384;  // B2a: one ring stage: kTileBytes / (C·elem) rows, at least one
constexpr int kStages = 6;         // B2a: tiles in flight per block
constexpr int kCluster = 8;        // B2a: blocks per cluster, along the chunk axis
constexpr int kFoldBatch = 8;      // B2a: cluster rows loaded together by a folding thread
constexpr int kApplyThreads = 256;  // B2b: a block's threads where a row has fewer vectors
constexpr int kApplyRows = 4;       // B2b: rows a thread has in flight (16-byte loads)

// 16 bytes of T as floats: 4 f32 or 8 bf16 values.
template <typename T> struct Pack;

template <> struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& a, float (&v)[N]) {
    v[0] = __uint_as_float(a.x);
    v[1] = __uint_as_float(a.y);
    v[2] = __uint_as_float(a.z);
    v[3] = __uint_as_float(a.w);
  }
  __device__ static void load(const float* p, float (&v)[N]) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), v);
  }
  __device__ static void store(float* p, const float (&v)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static float round(float v) { return v; }
  __device__ static float cast(float v) { return v; }
};

template <> struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& a, float (&v)[N]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void load(const __nv_bfloat16* p, float (&v)[N]) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), v);
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

// ---------------------------------------------------------------------------
// B2a's geometry, shared by host and device (the same formulas as
// ops/group_norm.py: block_threads, tile_rows, smem_bytes)
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int tile_rows(int c, int elem) {
  return kTileBytes / (c * elem) > 0 ? kTileBytes / (c * elem) : 1;
}

// One thread per 16-byte vector of a row (at most kThreads vectors), in as
// many lanes of rows as fit in kThreads.
__host__ __device__ constexpr int block_threads(int c, int elem) {
  return kThreads / (c * elem / 16) * (c * elem / 16);
}

// Dynamic shared memory: the ring and the scratch it is reused as after
// the last tile: the block's lanes [2][lanes][C] f32, then the receive
// buffer [kCluster][2][C / kCluster] f32 (every rank's row of this block's
// slice); later the fold's [lanes][C / 16] float4 over the lanes.
__host__ __device__ constexpr int scratch_bytes(int c, int elem) {
  const int threads = block_threads(c, elem), lanes = threads / (c * elem / 16);
  const int lanes_bytes = 8 * lanes * c + 8 * c;
  const int fold_bytes = 16 * (threads > c / 16 ? threads : c / 16);
  return lanes_bytes > fold_bytes ? lanes_bytes : fold_bytes;
}

__host__ __device__ constexpr int smem_bytes(int c, int elem) {
  return kStages * kTileBytes > scratch_bytes(c, elem) ? kStages * kTileBytes
                                                       : scratch_bytes(c, elem);
}

// Every C the kernel takes (C % 32 == 0, at most kThreads vectors a row)
// needs the ring's shared memory and no more, so the attribute that
// gn_stats_max_clusters raises once covers every launch.
constexpr bool ring_covers_scratch(int elem) {
  for (int c = 32; c * elem / 16 <= kThreads; c += 32)
    if (scratch_bytes(c, elem) > kStages * kTileBytes) return false;
  return true;
}
static_assert(ring_covers_scratch(2) && ring_covers_scratch(4), "scratch outgrows the ring");

// B2b's geometry (the same formulas as ops/group_norm.py: apply_threads,
// apply_smem_bytes; its apply_plan sets the grid).  Threads: one per 16-byte
// vector of a row, in as many lanes of rows as fit in kApplyThreads (one
// lane where a row has more).
__host__ __device__ constexpr int apply_threads(int c, int elem) {
  return (kApplyThreads / (c * elem / 16) > 0 ? kApplyThreads / (c * elem / 16) : 1) *
         (c * elem / 16);
}

// Dynamic shared memory: the image's mul and add, 2·C values (at most 32 KB).
__host__ __device__ constexpr int apply_smem_bytes(int c, int elem) { return 2 * c * elem; }

// ---------------------------------------------------------------------------
// mbarrier and the 1-D bulk copy (the TMA without a tensor map)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// A shared-memory address of this block as the same address in block
// `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Four floats into a cluster peer's shared memory, counted on its mbarrier.
__device__ __forceinline__ void st_async4(uint32_t addr, float a, float b, float c, float d,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(addr), "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
      : "memory");
}

// The two halves of the cluster barrier, so a block can arrive early and
// wait late.  The arrival is relaxed (it orders no memory operation): it
// signals a ring that is no longer read and an mbarrier whose
// initialisation fence.mbarrier_init has released; the wait acquires.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// An integer ticket: the old value, with release of what this block wrote
// before it (ordered by a __syncthreads) and acquire of what the blocks that
// drew earlier tickets wrote.
__device__ __forceinline__ unsigned draw_ticket(unsigned* t) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n" : "=r"(old) : "l"(t) : "memory");
  return old;
}

// Programmatic dependent launch.  A kernel launched after this one with the
// programmatic stream serialization attribute may start once every block of
// this one has triggered (or exited); without such a kernel, a no-op.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Until the kernel before this one on the stream has finished and its
// writes are visible; returns at once where the launch waited for it anyway.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// B2a
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void accumulate(const uint4& raw, float (&s)[Pack<T>::N],
                                           float (&s2)[Pack<T>::N]) {
  float a[Pack<T>::N];
  Pack<T>::unpack(raw, a);
#pragma unroll
  for (int k = 0; k < Pack<T>::N; ++k) {
    s[k] += a[k];
    s2[k] = fmaf(a[k], a[k], s2[k]);
  }
}

__device__ __forceinline__ void add4(float4& a, const float4& u) {
  a.x += u.x;
  a.y += u.y;
  a.z += u.z;
  a.w += u.w;
}

// Grid (n_chunks, batch) in clusters of (kCluster, 1, 1); block_threads(C)
// threads.  Slice r of the channels is [r·C/kCluster, (r+1)·C/kCluster),
// whole groups (groups % kCluster == 0).  part: [batch][kCluster][n_chunks /
// kCluster][2][C / kCluster] f32, each cluster's Σx and Σx² by slice;
// tickets: [batch][kCluster] unsigned, 0 on entry and on exit.
// Two blocks a SM (the ring's shared memory).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
gn_stats_kernel(const T* __restrict__ x, int hw, int c, int groups, float n, float eps,
                const float* __restrict__ scale, const float* __restrict__ bias,
                float* __restrict__ part, unsigned* __restrict__ tickets,
                float* __restrict__ sums, float* __restrict__ sumsq, T* __restrict__ mul,
                T* __restrict__ add) {
  constexpr int N = Pack<T>::N;
  // the ring starts 128-byte aligned: the TMA writes into it (a ring only
  // 16-byte aligned made B1's kernels slower on the H100, PERF.md)
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bars[kStages];
  __shared__ uint64_t gather;  // every rank's row of this block's slice
  __shared__ int last;
  cg::cluster_group cluster = cg::this_cluster();
  const int nv = c / N, lanes = blockDim.x / nv;
  const int tid = threadIdx.x, v = tid % nv, lane = tid / nv;
  const int b = blockIdx.y;
  const int tr = tile_rows(c, sizeof(T));
  // this block's rows [r0, r1) of image b: an even split, to a row
  const int r0 = (int)((long long)blockIdx.x * hw / gridDim.x);
  const int r1 = (int)((long long)(blockIdx.x + 1) * hw / gridDim.x);
  const int nt = (r1 - r0 + tr - 1) / tr;
  const T* img = x + (long long)b * hw * c;
  const int cs = c / kCluster;  // channels in a slice; cs <= blockDim.x
  const int rank = (int)cluster.block_rank();
  // this block's slice of the affine, loaded now in case it folds the slice
  const float sc = tid < cs ? scale[rank * cs + tid] : 0.f;
  const float bi = tid < cs ? bias[rank * cs + tid] : 0.f;
  if (tid == 0) {
    mbar_init(&gather);
    mbar_arrive_expect(&gather, 8 * c);  // kCluster·2·cs floats
    for (int j = 0; j < kStages; ++j) mbar_init(bars + j);
    mbar_init_fence();
  }

  float s[N], s2[N];
#pragma unroll
  for (int k = 0; k < N; ++k) s[k] = s2[k] = 0.f;

  T* ring = reinterpret_cast<T*>(smem);
  constexpr int stage = kTileBytes / sizeof(T);
  // tile i (rows r0 + i·tr ...) into stage i % kStages, by thread 0
  auto issue = [&](int i) {
    const uint32_t bytes = min(tr, r1 - r0 - i * tr) * c * sizeof(T);
    uint64_t* bar = bars + i % kStages;
    mbar_arrive_expect(bar, bytes);
    bulk_load(ring + (i % kStages) * stage, img + (long long)(r0 + i * tr) * c, bytes, bar);
  };
  if (tid == 0)
    for (int i = 0; i < min(kStages, nt); ++i) issue(i);
  __syncthreads();
  for (int i = 0; i < nt; ++i) {
    mbar_wait(bars + i % kStages, (i / kStages) & 1);  // the stage's (i / kStages)-th phase
    const int rows = min(tr, r1 - r0 - i * tr);
    const T* tile = ring + (i % kStages) * stage + v * N;
    for (int r = lane; r < rows; r += lanes)
      accumulate<T>(*reinterpret_cast<const uint4*>(tile + r * c), s, s2);
    __syncthreads();  // every thread is done with the stage
    if (tid == 0 && i + kStages < nt) issue(i + kStages);
  }

  cluster_arrive_relaxed();  // this block's ring is free, its mbarrier initialised
  launch_dependents();  // B2b may start: before its wait it only reads x, which B2a never writes

  // The block's lanes in [2][lanes][C] (lane-major), then the block's row:
  // the lanes folded in order, four channels at a time, each float4 sent
  // to the rank that owns its slice (C / kCluster is a multiple of 4) by
  // an asynchronous store counted on that rank's `gather` mbarrier.
  float* sh = reinterpret_cast<float*>(smem);
  float* recv = sh + 2 * lanes * c;  // [kCluster][2][cs]
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    *reinterpret_cast<float4*>(sh + lane * c + v * N + k) =
        make_float4(s[k], s[k + 1], s[k + 2], s[k + 3]);
    *reinterpret_cast<float4*>(sh + (lanes + lane) * c + v * N + k) =
        make_float4(s2[k], s2[k + 1], s2[k + 2], s2[k + 3]);
  }
  __syncthreads();
  cluster_wait();  // every peer's ring is free, its mbarrier initialised
  for (int j = 4 * tid; j < 2 * c; j += 4 * blockDim.x) {
    const int p = j / c, ch = j - p * c, owner = ch / cs;
    const float* col = sh + p * lanes * c + ch;
    float4 a = *reinterpret_cast<const float4*>(col);
    for (int l = 1; l < lanes; ++l) add4(a, *reinterpret_cast<const float4*>(col + l * c));
    const uint32_t at = smem_addr(recv + (rank * 2 + p) * cs + ch % cs);
    st_async4(map_rank(at, owner), a.x, a.y, a.z, a.w, map_rank(smem_addr(&gather), owner));
  }
  mbar_wait(&gather, 0);  // every rank's row of this block's slice

  // The cluster's row of slice `rank`: the ranks' rows summed in rank order.
  const int n_clusters = gridDim.x / kCluster;
  float* slice_rows = part + ((long long)b * kCluster + rank) * n_clusters * 2 * cs;
  for (int i = tid; i < 2 * cs; i += blockDim.x) {
    float a = recv[i];
#pragma unroll
    for (int q = 1; q < kCluster; ++q) a += recv[q * 2 * cs + i];
    slice_rows[(long long)(blockIdx.x / kCluster) * 2 * cs + i] = a;
  }
  __syncthreads();
  unsigned* ticket = tickets + b * kCluster + rank;
  if (tid == 0) last = draw_ticket(ticket) == (unsigned)n_clusters - 1;
  __syncthreads();
  if (!last) return;

  // The last cluster's block of rank r folds slice r of image b: thread
  // (fl lane, column) sums float4 column `col` of cluster rows lane,
  // lane + fl, ... in order (kFoldBatch loads in flight), then the lanes
  // are added in order; as many lanes as one round of loads needs.
  const int cols = cs / 2;  // float4 columns of a [2][cs] row
  const int fl = max(1, min((int)blockDim.x / cols, (n_clusters + kFoldBatch - 1) / kFoldBatch));
  float4* red = reinterpret_cast<float4*>(smem);  // [fl][cols]
  for (int j = tid; j < fl * cols; j += blockDim.x) {
    const int col = j % cols, l = j / cols;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* rows = reinterpret_cast<const float4*>(slice_rows) + col;
    for (int r = l; r < n_clusters; r += fl * kFoldBatch) {
      float4 u[kFoldBatch];
#pragma unroll
      for (int q = 0; q < kFoldBatch; ++q)
        if (r + q * fl < n_clusters) u[q] = __ldcg(rows + (long long)(r + q * fl) * cols);
#pragma unroll
      for (int q = 0; q < kFoldBatch; ++q)
        if (r + q * fl < n_clusters) add4(a, u[q]);
    }
    red[j] = a;
  }
  __syncthreads();
  for (int j = tid; j < cols; j += blockDim.x) {
    float4 a = red[j];
    for (int l = 1; l < fl; ++l) add4(a, red[l * cols + j]);
    red[j] = a;
  }
  __syncthreads();
  const float* ts = reinterpret_cast<const float*>(red);  // Σx [cs], then Σx² [cs]
  const float* ts2 = ts + cs;
  const int cgs = c / groups;
  if (tid < cs) {
    const int g0 = tid / cgs * cgs;
    float gs = 0.f, gs2 = 0.f;
#pragma unroll 8
    for (int k = 0; k < cgs; ++k) {
      gs += ts[g0 + k];
      gs2 += ts2[g0 + k];
    }
    const long long o = (long long)b * c + rank * cs + tid;
    const float mu = __fdiv_rn(gs, n);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(gs2, n), __fmul_rn(mu, mu)), 0.f);
    const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    const float inv_s = __fmul_rn(inv, sc);
    sums[o] = ts[tid];
    sumsq[o] = ts2[tid];
    mul[o] = Pack<T>::cast(inv_s);
    add[o] = Pack<T>::cast(__fsub_rn(bi, __fmul_rn(mu, inv_s)));
  }
  if (tid == 0) *ticket = 0;  // every cluster of image b has drawn this slice's ticket
}

// ---------------------------------------------------------------------------
// B2b
// ---------------------------------------------------------------------------

// Grid (chunks, batch), apply_threads(C) threads; mul/add are [batch, C]
// in T.  Block (chunk, b) writes rows [r0, r1) of image b, an even split of
// H·W (to a row); thread (lane, v) owns 16-byte channel vector v of rows
// r0 + lane, r0 + lane + lanes, ..., kApplyRows of them loaded into
// registers before any is stored.  Before grid_dependency_wait the thread
// reads only x, so the launch may overlap the tail of a kernel that does
// not write x (B2a, in gn_forward); after it, mul and add.
template <typename T>
__global__ void __launch_bounds__(1024)
gn_apply_kernel(const T* __restrict__ x, const T* __restrict__ mul, const T* __restrict__ add,
                T* __restrict__ y, int hw, int c) {
  constexpr int N = Pack<T>::N;
  extern __shared__ __align__(128) unsigned char smem[];  // mul, then add, of image b
  const int nv = c / N, lanes = blockDim.x / nv;
  const int tid = threadIdx.x, v = tid % nv, lane = tid / nv;
  const int b = blockIdx.y;
  const int r1 = (int)((long long)(blockIdx.x + 1) * hw / gridDim.x);
  int r = (int)((long long)blockIdx.x * hw / gridDim.x) + lane;  // this thread's next row
  const long long at = (long long)b * hw * c + v * N;  // image b, channel vector v
  uint4 xr[kApplyRows];
  auto load = [&]() {
#pragma unroll
    for (int u = 0; u < kApplyRows; ++u)
      if (r + u * lanes < r1)
        xr[u] = __ldcg(reinterpret_cast<const uint4*>(x + at + (long long)(r + u * lanes) * c));
  };
  load();
  grid_dependency_wait();
  // mul and add from L2 (ld.global.cg), each 16-byte vector once a block,
  // through shared memory: plain loads, through L1, read stale values under
  // the launch overlap on the card (chip_smoke.py's bitwise check)
  uint4* ma = reinterpret_cast<uint4*>(smem);
  for (int j = tid; j < 2 * nv; j += blockDim.x)
    ma[j] = __ldcg(reinterpret_cast<const uint4*>((j < nv ? mul : add) + (long long)b * c) +
                   j % nv);
  __syncthreads();
  float m[N], a[N];
  Pack<T>::unpack(ma[v], m);
  Pack<T>::unpack(ma[nv + v], a);
  for (;;) {
#pragma unroll
    for (int u = 0; u < kApplyRows; ++u)
      if (r + u * lanes < r1) {
        float xv[N], o[N];
        Pack<T>::unpack(xr[u], xv);
#pragma unroll
        for (int k = 0; k < N; ++k)
          o[k] = __fadd_rn(Pack<T>::round(__fmul_rn(xv[k], m[k])), a[k]);
        Pack<T>::store(y + at + (long long)(r + u * lanes) * c, o);
      }
    r += kApplyRows * lanes;
    if (r >= r1) break;
    load();
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename T>
bool stats_ok(int c, int groups) {
  constexpr int N = Pack<T>::N;
  return c >= 32 && c % 32 == 0 && c / N <= kThreads && groups >= kCluster &&
         groups % kCluster == 0 && c % groups == 0;
}

// The launch configuration of B2a: the cluster attribute and the shared
// memory.
template <typename T>
void stats_config(int c, dim3 grid, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                  cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(block_threads(c, sizeof(T)));
  cfg->dynamicSmemBytes = smem_bytes(c, sizeof(T));
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// The shared memory above 48 KB must be allowed before a launch; the
// wrapper queries max_clusters (which allows it) before it launches.
template <typename T>
int launch_stats(const void* x, int batch, int hw, int c, int groups, int n_chunks, float n,
                 float eps, const float* scale, const float* bias, float* part,
                 unsigned* tickets, float* sums, float* sumsq, void* mul, void* add,
                 cudaStream_t stream) {
  if (!stats_ok<T>(c, groups) || batch < 1 || hw < 1 || n_chunks < kCluster ||
      n_chunks % kCluster != 0)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  stats_config<T>(c, dim3(n_chunks, batch), stream, &cfg, &attr);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, gn_stats_kernel<T>, static_cast<const T*>(x), hw, c, groups, n,
                         eps, scale, bias, part, tickets, sums, sumsq, static_cast<T*>(mul),
                         static_cast<T*>(add));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Allows the kernel its shared memory on the current device, then counts
// the clusters that fit.
template <typename T>
int max_clusters(int c, int* out) {
  if (!stats_ok<T>(c, kCluster)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      gn_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(c, sizeof(T)));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  stats_config<T>(c, dim3(kCluster), nullptr, &cfg, &attr);
  return (int)cudaOccupancyMaxActiveClusters(
      out, reinterpret_cast<const void*>(gn_stats_kernel<T>), &cfg);
}

template <typename T>
bool apply_ok(int batch, int hw, int c, int chunks) {
  constexpr int N = Pack<T>::N;
  return c >= 32 && c % 32 == 0 && c / N <= 1024 && batch >= 1 && hw >= 1 && chunks >= 1 &&
         chunks <= hw;
}

// B2b on the stream; with `after_stats`, as a programmatic dependent of the
// kernel launched just before it (B2a on the same x), else in stream order.
template <typename T>
int launch_apply(const void* x, const void* mul, const void* add, void* y, int batch, int hw,
                 int c, int chunks, bool after_stats, cudaStream_t stream) {
  if (!apply_ok<T>(batch, hw, c, chunks)) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(chunks, batch);
  cfg.dynamicSmemBytes = apply_smem_bytes(c, sizeof(T));
  cfg.blockDim = dim3(apply_threads(c, sizeof(T)));
  cfg.stream = stream;
  cfg.attrs = after_stats ? &attr : nullptr;
  cfg.numAttrs = after_stats ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, gn_apply_kernel<T>, static_cast<const T*>(x),
                         static_cast<const T*>(mul), static_cast<const T*>(add),
                         static_cast<T*>(y), hw, c);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  groups % kCluster == 0.  part holds
// 2·batch·(n_chunks / kCluster)·C f32; tickets batch·kCluster zeroed
// unsigned (left zeroed).  gn_stats_max_clusters must have run on the
// device first (it allows the shared memory).
int gn_stats(int dtype, const void* x, int batch, int hw, int c, int groups,
             int n_chunks, float n, float eps, const void* scale, const void* bias, void* part,
             void* tickets, void* sums, void* sumsq, void* mul, void* add, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* pa = static_cast<float*>(part);
  unsigned* ti = static_cast<unsigned*>(tickets);
  float* su = static_cast<float*>(sums);
  float* sq = static_cast<float*>(sumsq);
#define GN_STATS_ARGS x, batch, hw, c, groups, n_chunks, n, eps, sc, bi, pa, ti, su, sq, mul, add, s
  if (dtype == 0) return launch_stats<float>(GN_STATS_ARGS);
  if (dtype == 1) return launch_stats<__nv_bfloat16>(GN_STATS_ARGS);
#undef GN_STATS_ARGS
  return (int)cudaErrorInvalidValue;
}

// How many clusters of gn_stats' blocks for C channels fit on the current
// device at once, into *out; first allows gn_stats its shared memory there.
int gn_stats_max_clusters(int dtype, int c, int* out) {
  if (dtype == 0) return max_clusters<float>(c, out);
  if (dtype == 1) return max_clusters<__nv_bfloat16>(c, out);
  return (int)cudaErrorInvalidValue;
}

// B2b alone, in stream order: it may follow the kernel that wrote x.
// chunks: blocks an image, 1 to hw (apply_plan).
int gn_apply(int dtype, const void* x, const void* mul, const void* add, void* y, int batch,
             int hw, int c, int chunks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GN_APPLY_ARGS x, mul, add, y, batch, hw, c, chunks, false, s
  if (dtype == 0) return launch_apply<float>(GN_APPLY_ARGS);
  if (dtype == 1) return launch_apply<__nv_bfloat16>(GN_APPLY_ARGS);
#undef GN_APPLY_ARGS
  return (int)cudaErrorInvalidValue;
}

// The pair of one GroupNorm, back to back from one host call: gn_stats'
// arguments, then y and B2b's chunks.  B2b is launched as B2a's programmatic
// dependent, so its blocks copy x into shared memory under B2a's tail.
int gn_forward(int dtype, const void* x, int batch, int hw, int c, int groups, int n_chunks,
               float n, float eps, const void* scale, const void* bias, void* part,
               void* tickets, void* sums, void* sumsq, void* mul, void* add, void* y,
               int apply_chunks, void* stream) {
  const int err = gn_stats(dtype, x, batch, hw, c, groups, n_chunks, n, eps, scale, bias, part,
                           tickets, sums, sumsq, mul, add, stream);
  if (err) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GN_APPLY_ARGS x, mul, add, y, batch, hw, c, apply_chunks, true, s
  if (dtype == 0) return launch_apply<float>(GN_APPLY_ARGS);
  if (dtype == 1) return launch_apply<__nv_bfloat16>(GN_APPLY_ARGS);
#undef GN_APPLY_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
