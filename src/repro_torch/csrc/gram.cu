// Pairwise cosine-similarity Gram matrices (paper Eq. 1), for a stack of K
// node batches.
//
// Replaces: repro/kernels/gram.py, cosine_gram_pallas (the JAX engine vmaps
// it over the node axis, core/engine.py:273-283).
//
// x (K, B, D) in bf16 or f32, contiguous; out (K, B, B) in f32:
// out[k, i, j] = <x_ki, x_kj> * rsqrt(max(|x_ki|^2, eps)) * rsqrt(max(|x_kj|^2, eps)),
// the Pallas kernel's row scaling.  The norms come from the same pass over
// D as the dot products, so x is read once and no normalised copy is ever
// written.
//
// What bounds it: at the round's shapes (B 32 anchors, D 768; one node in
// the loss, K 4 at the upload) it moves ~53 KB per node and does ~1.6
// MFLOP: both bounds are far under a microsecond, so the launch and the
// memory round trips on each block's serial path set its time.  Output
// tiles alone give a handful of blocks at these shapes (one 32 x 32 tile
// a node), and a block that walks all of D alone makes one round trip per
// chunk in series: hence the split of D below.
//
// Design:
//   * 32 x 32 output tiles.  A node's nt = ceil(B / 32) row tiles give
//     nt (nt + 1) / 2 tile pairs I <= J along blockIdx.x; a pair's tile is
//     computed once and stored at (I, J) and (J, I).  blockIdx.y is the
//     node.
//   * The D contraction is split to fill the card: across the CTAs of a
//     thread-block cluster along blockIdx.z (the wrapper's gram_plan: at
//     most 8, a portable cluster, each a contiguous range of whole
//     128-wide chunks, as many as it takes to give the card a block per
//     SM), and within a CTA across its 4 warps (warp w takes columns
//     [32 w, 32 w + 32) of every chunk).  A CTA streams its range through
//     a 2-stage cp.async ring; at the round's shapes the range is one
//     chunk, so each CTA makes one memory round trip.
//   * bf16 on the tensor cores: mma.sync m16n8k16, f32 accumulate.  Both
//     operands are rows of x, staged once in one swizzled tile, and both
//     load with plain ldmatrix: the A fragment of 16 rows at a k16 step is
//     also the B fragment of its two n8 tiles (rows 0-7: registers 0 and
//     2; rows 8-15: 1 and 3).  A k16 step is 2 ldmatrix (4 off the
//     diagonal) and 8 mma a warp.
//   * Norms from the same pass: each lane adds the squares of the bf16
//     values its fragments hold (exact products, f32 sums); an
//     off-diagonal tile holds no diagonal to take them from.
//   * f32 stays on FMAs (TF32 keeps ~3 decimal digits and would miss the
//     1e-5 f32 checks): each lane owns a 4 x 8 micro-tile over its warp's
//     columns, rows padded against bank conflicts; same tiles, ranges,
//     warps and reduction.
//   * Reduction: each warp's f32 partial tile and row sums go to shared
//     memory and the CTA adds them in warp order; the CTAs of rank > 0
//     then write their sums into slots in rank 0's shared memory through
//     distributed shared memory and exit, and rank 0 adds the slots in
//     rank order, scales and stores.  One cluster barrier phase, split
//     into an arrive at the start and a wait before the remote writes,
//     makes sure every CTA has started; a second (release / acquire)
//     hands the slots to rank 0.  (Rank 0 pulling the sums between two
//     full cluster barriers was slower on the H100.)  No workspace in
//     global memory, no second kernel.
//   * Edges: rows past B are zero-filled (cp.async source size 0) and
//     masked at the store; rows that are not whole aligned 16-byte chunks
//     (D % 8 in bf16, D % 4 in f32, or an unaligned base) are staged
//     element by element, out of line, with the same zero fill.
#include "mma.cuh"

#include <cooperative_groups.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

using namespace repro;
using bf16 = __nv_bfloat16;

constexpr int kTile = 32;                   // rows of each side of an output tile
constexpr int kChunk = 128;                 // columns of D a ring stage holds
constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kWarpCols = kChunk / kWarps;  // a warp's columns of each chunk
constexpr int kStages = 2;
constexpr int kMaxSplits = 8;               // D ranges: a portable cluster
constexpr int kAcc = kTile * kTile / 32;    // partial sums a lane holds
constexpr int kPitchF = kChunk + 4;         // f32 row: 16-byte aligned, banks apart

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, bf16>::value;
template <typename T>
constexpr int kPitch = kIsBf16<T> ? kChunk : kPitchF;    // elements a staged row
template <typename T>
__host__ __device__ constexpr int ring_bytes() {
  return kStages * 2 * kTile * kPitch<T> * static_cast<int>(sizeof(T));
}
// the reduction's space, carved from the ring once the loop is done
constexpr int kRed = kWarps * kAcc * 32;    // each warp's partial tile
constexpr int kRedSs = kWarps * 2 * kTile;  // each warp's row sums (I rows, J rows)
static_assert(4 * (kRed + kRedSs + 2 * kTile) <= ring_bytes<bf16>(), "fits in the ring");
// past the ring: rank 0's slots for the other ranks' sums, written while
// rank 0 may still be in its loop
constexpr int kPart = kAcc * 32 + 2 * kTile;  // a CTA's tile sums, then its row sums
template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return ring_bytes<T>() + 4 * (kMaxSplits - 1) * kPart;
}

// the cluster barrier, split: arrive (relaxed, or releasing this thread's
// writes) and wait (acquiring the others')
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// tile pair p -> (ti, tj), ti <= tj, row by row over the upper triangle
__device__ __forceinline__ void tile_pair(int p, int nt, int& ti, int& tj) {
  ti = 0;
  while (p >= nt - ti) {
    p -= nt - ti;
    ++ti;
  }
  tj = ti + p;
}

// (row, column) in the tile of partial sum q of lane `lane`
template <typename T>
__device__ __forceinline__ void acc_at(int q, int lane, int& row, int& col) {
  if (kIsBf16<T>) {       // q = 4 (4 mt + nt) + c: the mma's C fragment
    row = 16 * (q >> 4) + (lane >> 2) + 8 * ((q & 3) >> 1);
    col = 8 * ((q >> 2) & 3) + 2 * (lane & 3) + (q & 1);
  } else {                // q = 4 j + i: rows ty + 8 i, columns tx + 4 j
    row = (lane >> 2) + 8 * (q & 3);
    col = (lane & 3) + 4 * (q >> 2);
  }
}

// ------------------------------------------------------------------ staging
// kTile rows from r0 and the chunk's columns from d0 into one half of a
// stage: rows past nrows, columns past ncols are 0.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int r0, int d0,
                                           int nrows, int ncols, int ld, bool vec, int tid) {
  stage_tile<kTile, kChunk, kThreads>(dst, src, r0, d0, nrows, ncols, ld, 1, vec, tid);
}

__device__ __noinline__ void stage_elems_f32(float* dst, const float* src, int r0, int d0,
                                             int nrows, int ncols, int ld, int tid) {
  for (int i = tid; i < kTile * kChunk; i += kThreads) {
    const int rr = i / kChunk, cc = i % kChunk, gr = r0 + rr, gc = d0 + cc;
    dst[rr * kPitchF + cc] =
        gr < nrows && gc < ncols ? src[static_cast<size_t>(gr) * ld + gc] : 0.f;
  }
}

__device__ __forceinline__ void stage_rows(float* dst, const float* src, int r0, int d0,
                                           int nrows, int ncols, int ld, bool vec, int tid) {
  if (!vec) {
    stage_elems_f32(dst, src, r0, d0, nrows, ncols, ld, tid);
    return;
  }
  constexpr int CH = kChunk / 4, PER = kTile * CH / kThreads;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * kThreads, rr = i / CH, c = i % CH;
    const int gr = r0 + rr, gc = d0 + 4 * c;
    const bool ok = gr < nrows && gc < ncols;
    cp_async16(dst + rr * kPitchF + 4 * c, ok ? src + static_cast<size_t>(gr) * ld + gc : src,
               ok);
  }
}

// ------------------------------------------------------------- chunk bodies
__device__ __forceinline__ float sq2(uint32_t v) {    // squares of a bf16 pair, summed
  const float lo = __uint_as_float(v << 16), hi = __uint_as_float(v & 0xffff0000u);
  return fmaf(lo, lo, hi * hi);
}

// bf16: this warp's k16 steps of one staged chunk (cols: its valid columns).
// ss[2 mt + h] is the sum of squares of I row 16 mt + 8 h + lane / 4 (this
// lane's columns only), ss[4 + ...] the same of J.
__device__ __forceinline__ void chunk_sums(float (&acc)[kAcc / 4][4], float (&ss)[8],
                                           const bf16* si, const bf16* sj, bool diag,
                                           int warp, int lane, int cols) {
#pragma unroll
  for (int h = 0; h < kWarpCols / 16; ++h) {
    const int kk = warp * (kWarpCols / 16) + h;       // k16 step of the chunk
    if (16 * kk >= cols) break;
    uint32_t fi[2][4], fj[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldsm_x4(fi[mt], si + swz<kChunk>(16 * mt + (lane & 15), 2 * kk + (lane >> 4)));
    if (diag) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) fj[mt][e] = fi[mt][e];
    } else {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(fj[mt], sj + swz<kChunk>(16 * mt + (lane & 15), 2 * kk + (lane >> 4)));
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_bf16(acc[4 * mt + nt], fi[mt], fj[nt >> 1][nt & 1], fj[nt >> 1][(nt & 1) + 2]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        ss[2 * mt + h2] += sq2(fi[mt][h2]) + sq2(fi[mt][h2 + 2]);
        ss[4 + 2 * mt + h2] += sq2(fj[mt][h2]) + sq2(fj[mt][h2 + 2]);
      }
  }
}

// f32: this warp's columns of one staged chunk.  ss[0] / ss[1]: the sums
// of squares of I row / J row `lane` over those columns.
__device__ __forceinline__ void chunk_sums(float (&acc)[kAcc / 4][4], float (&ss)[8],
                                           const float* si, const float* sj, bool, int warp,
                                           int lane, int cols) {
  const int c0 = warp * kWarpCols, ty = lane >> 2, tx = lane & 3;
  if (c0 >= cols) return;
#pragma unroll 8
  for (int c = c0; c < c0 + kWarpCols; ++c) {
    float iv[4], jv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) iv[i] = si[(ty + 8 * i) * kPitchF + c];
#pragma unroll
    for (int j = 0; j < 8; ++j) jv[j] = sj[(tx + 4 * j) * kPitchF + c];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(iv[i], jv[j], acc[j][i]);
  }
#pragma unroll 8
  for (int c = 0; c < kWarpCols; ++c) {               // rotated: lanes on distinct banks
    const int d = c0 + ((c + lane) & (kWarpCols - 1));
    const float a = si[lane * kPitchF + d], b = sj[lane * kPitchF + d];
    ss[0] = fmaf(a, a, ss[0]);
    ss[1] = fmaf(b, b, ss[1]);
  }
}

// -------------------------------------------------------------------- kernel
// One 32 x 32 tile pair of node blockIdx.y over the D range blockIdx.z of
// d_split columns; the ranges of one tile form a cluster along z, whose
// rank 0 sums them, scales and stores.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const T* __restrict__ x, float* __restrict__ out, int B, int D, float eps,
            int d_split, int vec) {
  constexpr int STAGE = 2 * kTile * kPitch<T>;        // I rows, then J rows
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int ti, tj;
  tile_pair(blockIdx.x, (B + kTile - 1) / kTile, ti, tj);
  const bool diag = ti == tj;
  const int i0 = ti * kTile, j0 = tj * kTile;
  const T* xk = x + static_cast<size_t>(blockIdx.y) * B * D;
  const int dbeg = blockIdx.z * d_split, dend = min(D, dbeg + d_split);
  const int nchunks = (dend - dbeg + kChunk - 1) / kChunk;
  const bool clustered = gridDim.z > 1;
  if (clustered) cluster_arrive_relaxed();            // phase 0: this CTA has started

  auto load_chunk = [&](int c) {
    T* s = ring + (c % kStages) * STAGE;
    const int d0 = dbeg + c * kChunk;
    stage_rows(s, xk, i0, d0, B, dend, D, vec, tid);
    if (!diag) stage_rows(s + kTile * kPitch<T>, xk, j0, d0, B, dend, D, vec, tid);
  };

  float acc[kAcc / 4][4], ss[8];
#pragma unroll
  for (int q = 0; q < kAcc / 4; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) ss[e] = 0.f;

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nchunks) load_chunk(c);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    if (c + kStages - 1 < nchunks) load_chunk(c + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();                     // chunk c has landed
    __syncthreads();
    const T* s = ring + (c % kStages) * STAGE;
    chunk_sums(acc, ss, s, diag ? s : s + kTile * kPitch<T>, diag, warp, lane,
               dend - (dbeg + c * kChunk));
    __syncthreads();                                  // stage c % kStages is free
  }
  cp_async_wait<0>();
  __syncthreads();                                    // the ring is free: reuse it

  float* red = reinterpret_cast<float*>(smem_raw);    // [kWarps][kAcc][32]
  float* red_ss = red + kRed;                         // [kWarps][2 kTile]
  float* rn = red_ss + kRedSs;                        // [2 kTile] clamped rsqrt norms
  float* slots = reinterpret_cast<float*>(smem_raw + ring_bytes<T>());  // [7][kPart]
#pragma unroll
  for (int q = 0; q < kAcc; ++q) red[(warp * kAcc + q) * 32 + lane] = acc[q >> 2][q & 3];
  if (kIsBf16<T>) {
#pragma unroll
    for (int e = 0; e < 8; ++e) ss[e] = group_sum<4>(ss[e]);   // over the lanes of a row
    if ((lane & 3) == 0)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        red_ss[warp * 2 * kTile + kTile * (e >> 2) + 16 * ((e >> 1) & 1) + 8 * (e & 1) +
               (lane >> 2)] = ss[e];
  } else {
    red_ss[warp * 2 * kTile + lane] = ss[0];
    red_ss[warp * 2 * kTile + kTile + lane] = ss[1];
  }
  __syncthreads();

  constexpr int PER = kAcc * 32 / kThreads;           // sums a thread finishes
  float tot[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {                     // warps in order
    const int e = tid + u * kThreads;
    float v = red[e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[w * kAcc * 32 + e];
    tot[u] = v;
  }
  float sst = 0.f;
  if (tid < 2 * kTile) {
    sst = red_ss[tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sst += red_ss[w * 2 * kTile + tid];
  }
  if (clustered) {
    // rank z > 0 writes its sums into slot z - 1 of rank 0 and exits; rank
    // 0 adds the slots in rank order and finishes
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned rank = cluster.block_rank();
    cluster_wait();                                   // phase 0: every CTA has started
    if (rank > 0) {
      float* slot = cluster.map_shared_rank(slots + (rank - 1) * kPart, 0);
#pragma unroll
      for (int u = 0; u < PER; ++u) slot[tid + u * kThreads] = tot[u];
      if (tid < 2 * kTile) slot[kAcc * 32 + tid] = sst;
    }
    cluster_arrive_release();                         // phase 1: the slots are written
    if (rank > 0) return;
    cluster_wait();
    for (unsigned z = 1; z < cluster.num_blocks(); ++z) {
      const float* slot = slots + (z - 1) * kPart;
#pragma unroll
      for (int u = 0; u < PER; ++u) tot[u] += slot[tid + u * kThreads];
      if (tid < 2 * kTile) sst += slot[kAcc * 32 + tid];
    }
  }
  if (tid < 2 * kTile) rn[tid] = rsqrtf(fmaxf(sst, eps));
  __syncthreads();

  float* ok = out + static_cast<size_t>(blockIdx.y) * B * B;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = tid + u * kThreads;
    int row, col;
    acc_at<T>(e >> 5, e & 31, row, col);
    const int i = i0 + row, j = j0 + col;
    if (i >= B || j >= B) continue;
    const float v = tot[u] * rn[row] * rn[kTile + col];
    ok[static_cast<size_t>(i) * B + j] = v;
    if (!diag) ok[static_cast<size_t>(j) * B + i] = v;
  }
}

template <typename T>
int launch(const void* x, void* out, int K, int B, int D, float eps, int n_split,
           int d_split, int vec, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        gram_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int nt = (B + kTile - 1) / kTile;
  // one cluster per (tile pair, node): its blocks along z take the D ranges
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nt * (nt + 1) / 2, K, n_split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = n_split;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, gram_kernel<T>, static_cast<const T*>(x),
                                             static_cast<float*>(out), B, D, eps, d_split,
                                             vec));
}

}  // namespace

// The D split comes from the wrapper's gram_plan: n_split ranges (at most
// 8) of d_split columns (a multiple of 128), none empty.  x is contiguous,
// so its rows load in 16-byte chunks when a row is whole chunks and x
// starts on a 16-byte address.  Returns a cudaError_t: 0 when the launch
// was accepted.
extern "C" int gram_launch(const void* x, void* out, int K, int B, int D, float eps,
                           int is_bf16, int n_split, int d_split, void* stream) {
  if (K < 1 || B < 1 || D < 1 || K > 65535 || (B + kTile - 1) / kTile > 16384 ||
      n_split < 1 || n_split > kMaxSplits || d_split < 1 || d_split % kChunk != 0 ||
      static_cast<long long>(n_split - 1) * d_split >= D ||
      static_cast<long long>(n_split) * d_split < D)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = D % (is_bf16 ? 8 : 4) == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<bf16>(x, out, K, B, D, eps, n_split, d_split, vec, st);
  return launch<float>(x, out, K, B, D, eps, n_split, d_split, vec, st);
}
