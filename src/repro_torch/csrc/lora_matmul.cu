// The fused GeoLoRA linear y = x @ W + (x @ A) @ B, forward and the input
// gradient of its backward.
//
// Replaces: repro/kernels/lora_matmul.py, lora_matmul_pallas (scale 1: no
// caller of the JAX linear passes another).
//
// x (M, K) contiguous; W (K, N), A (K, r) and B (r, N) each with its own
// element strides; y (M, N) contiguous, all in one dtype (bf16 or f32).
// Both products accumulate in f32, and the rank-r product is added to the
// f32 sums before the single rounding at the store.  Because W, A and B are
// read through strides, the backward's input gradient dx = dy @ W^T +
// (dy @ B^T) @ A^T is this same function of (dy, W^T, B^T, A^T): the
// wrapper passes the transposes as swapped strides, never as copies.  When
// `xa` is not null, the f32 bottleneck x @ A (M, r) is written there too
// (by the blocks of the first column tile), so the backward's dB = (x @
// A)^T @ dy needs no second pass over x.
//
// What bounds it: at the round's shapes (M 512 tokens, K 768, N 768 or
// 256, r 8, bf16) the function moves 1.4-2.8 MB and does 0.2-0.6 GFLOP:
// bytes bound it at 0.0008 / 0.0004 ms on the H100 (~140-220 flops per
// byte, under the ~295 of the bf16 ridge).  At these sizes every operand
// sits in the 50 MB L2 after its first read; the time goes to the launch,
// to each block's serial K loop (a step waits on its tiles' loads and on
// its chains of ldmatrix and mma), and to the epilogue.
//
// What held the first port back (PR 12's kernel, 0.071 ms at N 768, 4x
// torch.addmm(x @ W, x @ A, B)): both products ran as f32 FMAs on the CUDA
// cores from operands widened to f32 in shared memory (~9 us of FMAs
// alone at N 768); one 64 x 64 tile a block gave 96 blocks at N 768 and 32
// at N 256 for 132 SMs; every load was a scalar, one element a thread.
//
// bf16 design (a tiled GEMM on the tensor cores; the f32 instantiation
// keeps the first port's FMA body, second kernel below):
//   * mma.sync m16n8k16 bf16 -> f32.  A block of 4 warps owns a 64 x BN
//     output tile (BN 64 or 32); a warp owns 16 rows of it, its A
//     fragments (x) by ldmatrix.
//     The fragments of k16 step kk + 1 load while step kk's mma run.
//   * The K loop is fed by a 3-stage ring of bf16 tiles (x: 64 x 64, W:
//     64 x BN, A: 64 x 32 RT) that cp.async fills 16 bytes a thread.  Each
//     tile keeps the global layout of its operand, so rows copy straight,
//     and its 16-byte chunks are XOR-swizzled (repro::swz) so the 8 rows
//     of an ldmatrix phase hit 8 distinct bank groups.
//   * Both orientations of the second operand: in the forward W (K, N) and
//     A (K, r) have their N / r axis contiguous, the tile is [k][n] and
//     the B fragments come by ldmatrix.trans; in dx the views W^T and B^T
//     have the loop axis contiguous, the tile is [n][k] and plain ldmatrix
//     gives the fragments.  The orientation of W and of A is each a
//     template parameter, chosen by the wrapper from the strides.
//   * The bottleneck x @ A on the tensor cores in the same K loop: A's
//     tile holds RT rank tiles of 32 (RT = 1 up to rank 32, 2 up to 64,
//     the Pallas kernel's range; a template parameter, so ranks <= 32
//     carry no registers, shared memory or loads for a second tile), zero
//     past r, and each k16 step adds one mma per 8 ranks (at most 4 RT)
//     per 16 rows to the bottleneck's f32 fragments.
//     After the loop the fragments go to shared memory with B's r x BN
//     tile, and each thread adds r f32 FMAs per output element to its
//     accumulator fragments: the bottleneck stays f32, as in the plain
//     version (the Pallas kernel rounds it to bf16 before @ B).  Then one
//     bf16 rounding and the store.
//   * Filling the card: 64 x 64 tiles load the fewest bytes a step of
//     output, but give only 96 blocks at M 512, N 768.  The wrapper's
//     tile_plan takes the wider tile and cuts the K loop into just enough
//     ranges of whole 64-wide steps (4 or more) for a block per SM; the
//     ranges of one tile are one thread-block cluster along blockIdx.z,
//     and its rank 0 adds the others' f32 sums (y's and x @ A's) through
//     distributed shared memory in rank order, then finishes the tile: no
//     workspace in global memory, no second kernel.  At the round's
//     shapes: 64 x 64 in 2 ranges for the forward at N 768 and its dx,
//     64 x 32 in 3 ranges for the forward at N 256, 64 x 32 whole for the
//     dx over a loop of 256; 192 blocks each.
//   * Small code: the staging loops have fixed trip counts and unroll into
//     straight-line code, the element path is out of line, and the rank-r
//     epilogue is a loop.  (A first version, with generic staging loops
//     inlined at every call site, compiled to ~8k instructions a kernel,
//     and its blocks stalled on instruction fetch.)  Tried on the card and
//     slower or no better at these shapes: a TMA-fed ring, 8-warp blocks,
//     2 or 4 stages, BK 32 or 128, a split-K workspace with a second
//     reduce kernel, and 128 x 64 or 128 x 128 tiles (fewer bytes from L2,
//     but a longer serial K loop a block, or, split into short ranges, a
//     costlier reduction even when every rank reduces a slice of rows).
//   * A node axis: x (nodes, M, K) and y (nodes, M, N) contiguous, with A and B
//     each read at its own node stride (0 where the operand is shared).  The
//     node-stacked round gives every node its own B and shares W and A; in
//     dx the per-node B^T sits in A's slot and the shared A^T in B's, so
//     both slots take a node stride.  The nodes are folded into blockIdx.y
//     (node-major over the M tiles), so a block never spans two nodes and
//     the tile plan counts nodes x M tiles; with one node and strides 0 the
//     kernel is the single-node one.
//   * Edges: rows past M, N or K are zero-filled by cp.async's source size
//     0 and masked at the store.  An operand whose rows are not whole
//     16-byte chunks (K or N not a multiple of 8, r < 8, a base or pitch
//     off 16 bytes, or neither axis contiguous) is staged element by
//     element into the same swizzled tile, with the same zero fill.
#include "mma.cuh"

#include <cooperative_groups.h>

namespace {

namespace cg = cooperative_groups;

using namespace repro;
using bf16 = __nv_bfloat16;

constexpr int kRankTile = 32;                         // ranks a tile of A holds
constexpr int kMaxRank = 2 * kRankTile;               // the Pallas kernel's r <= 64

struct Strides {
  long long w0, w1, a0, a1, b0, b1;
  long long a_node, b_node;                           // 0: shared by every node
};

// The node of this block and the first row of its tile: blockIdx.y walks
// the M tiles of node 0, then of node 1, and so on.
__device__ __forceinline__ int node_tile(int M, int bm, int& m0) {
  const int mtiles = (M + bm - 1) / bm;
  m0 = (blockIdx.y % mtiles) * bm;
  return blockIdx.y / mtiles;
}

// ---------------------------------------------------------------- bf16 path
constexpr int kBK = 64;                               // K per ring stage
constexpr int kStages = 3;                            // the cp.async ring
constexpr int kBM = 64;                               // rows of an output tile
constexpr int kWarps = kBM / 16, kMmaThreads = 32 * kWarps;  // 16 rows a warp
constexpr int kMaxSplits = 8;                         // K ranges: a portable cluster

// bits of `flags`, set by the wrapper from the strides and addresses
constexpr int kVecX = 1, kVecW = 2, kVecA = 4, kRowW = 8, kRowA = 16;

template <int BN, int RT>
__host__ __device__ constexpr int mma_smem_bytes() {
  return static_cast<int>(sizeof(bf16)) * kStages *
         (kBM * kBK + kBK * BN + kBK * kRankTile * RT);
}

// B fragments of two n8 tiles (columns 16 p .. 16 p + 15) at k16 step kk of
// a staged tile.  ROW: the tile is [k][n] (the operand's n axis
// contiguous), read by ldmatrix.trans; else [n][k], read by plain ldmatrix.
// b[0], b[1] are the first n8 tile's fragments, b[2], b[3] the second's.
template <bool ROW, int COLS>
__device__ __forceinline__ void ldsm_b(uint32_t (&b)[4], const bf16* tile, int kk, int p,
                                       int lane) {
  if (ROW) {
    const int row = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
    ldsm_x4_trans(b, tile + swz<COLS>(row, 2 * p + (lane >> 4)));
  } else {
    const int row = 16 * p + (lane & 7) + 8 * (lane >> 4);
    ldsm_x4(b, tile + swz<COLS>(row, 2 * kk + ((lane >> 3) & 1)));
  }
}

// One 64 x BN output tile over the K range [z k_split, (z + 1) k_split) of
// blockIdx.z = z; the blocks of one tile form a cluster along z, and its
// rank 0 sums their ranges and finishes the tile (bottleneck product,
// rounding, store).  RT: rank tiles of 32 in A's tile.
template <int BN, int RT, bool WROW, bool AROW>
__global__ void __launch_bounds__(kMmaThreads)
lora_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const bf16* __restrict__ a, const bf16* __restrict__ b,
                bf16* __restrict__ y, float* __restrict__ xa_out, int M, int K, int N,
                int r, Strides st, int flags, int k_split) {
  constexpr int FN = BN / 8;                          // n8 tiles of a warp's row
  static_assert(FN % 2 == 0, "unsupported tile");
  constexpr int RP = kRankTile * RT;                  // columns of A's tile
  constexpr int XN = 4 * RT;                          // n8 tiles of the bottleneck
  constexpr int XA_PITCH = RP + 1;                    // f32 row of the bottleneck
  constexpr int XT = kBM * kBK, WT = kBK * BN, AT = kBK * RP;  // elements a stage
  static_assert(4 * (kBM * XA_PITCH + RP * BN) <= mma_smem_bytes<BN, RT>() &&
                    4 * (FN * 4 + XN * 4) * kMmaThreads <= mma_smem_bytes<BN, RT>(),
                "the epilogue and the cluster exchange fit in the ring");
  constexpr int STAGE = XT + WT + AT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* const ring = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4;
  int m0;
  const int node = node_tile(M, kBM, m0);
  const int n0 = blockIdx.x * BN;
  x += static_cast<size_t>(node) * M * K;
  y += static_cast<size_t>(node) * M * N;
  if (xa_out != nullptr) xa_out += static_cast<size_t>(node) * M * r;
  a += node * st.a_node;
  b += node * st.b_node;
  const int kbeg = blockIdx.z * k_split, kend = min(K, kbeg + k_split);
  const int nsteps = (kend - kbeg + kBK - 1) / kBK;
  const int nr8 = (r + 7) / 8;                        // n8 tiles of the bottleneck
  const bool vx = flags & kVecX, vw = flags & kVecW, va = flags & kVecA;

  auto load_stage = [&](int step) {
    bf16* sX = ring + (step % kStages) * STAGE;
    bf16* sW = sX + XT;
    bf16* sA = sW + WT;
    const int k0 = kbeg + step * kBK;
    stage_tile<kBM, kBK, kMmaThreads>(sX, x, m0, k0, M, K, K, 1, vx, tid);
    if (WROW)
      stage_tile<kBK, BN, kMmaThreads>(sW, w, k0, n0, K, N, st.w0, st.w1, vw, tid);
    else
      stage_tile<BN, kBK, kMmaThreads>(sW, w, n0, k0, N, K, st.w1, st.w0, vw, tid);
    if (AROW)
      stage_tile<kBK, RP, kMmaThreads>(sA, a, k0, 0, K, r, st.a0, st.a1, va, tid);
    else
      stage_tile<RP, kBK, kMmaThreads>(sA, a, 0, k0, r, K, st.a1, st.a0, va, tid);
  };

  float acc[FN][4], xacc[XN][4];
#pragma unroll
  for (int j = 0; j < FN; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < XN; ++j) xacc[j][0] = xacc[j][1] = xacc[j][2] = xacc[j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {             // kStages - 1 steps ahead
    if (s < nsteps) load_stage(s);
    cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    if (step + kStages - 1 < nsteps) load_stage(step + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();                     // this step's tiles have landed
    __syncthreads();
    const bf16* sX = ring + (step % kStages) * STAGE;
    const bf16* sW = sX + XT;
    const bf16* sA = sW + WT;
    // the fragments of k16 step kk + 1 load while step kk's mma run
    uint32_t fa[2][4], fw[2][FN / 2][4], fx[2][XN / 2][4];
    auto load_frags = [&](int kk, int buf) {
      ldsm_x4(fa[buf], sX + swz<kBK>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
      for (int p = 0; p < FN / 2; ++p)
        ldsm_b<WROW, WROW ? BN : kBK>(fw[buf][p], sW, kk, p, lane);
#pragma unroll
      for (int p = 0; p < XN / 2; ++p)
        if (2 * p < nr8) ldsm_b<AROW, AROW ? RP : kBK>(fx[buf][p], sA, kk, p, lane);
    };
    load_frags(0, 0);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const int buf = kk & 1;
      if (kk + 1 < kBK / 16) load_frags(kk + 1, buf ^ 1);
#pragma unroll
      for (int p = 0; p < FN / 2; ++p) {
        mma_bf16(acc[2 * p], fa[buf], fw[buf][p][0], fw[buf][p][1]);
        mma_bf16(acc[2 * p + 1], fa[buf], fw[buf][p][2], fw[buf][p][3]);
      }
#pragma unroll
      for (int p = 0; p < XN / 2; ++p) {
        if (2 * p < nr8) mma_bf16(xacc[2 * p], fa[buf], fx[buf][p][0], fx[buf][p][1]);
        if (2 * p + 1 < nr8)
          mma_bf16(xacc[2 * p + 1], fa[buf], fx[buf][p][2], fx[buf][p][3]);
      }
    }
    __syncthreads();                                  // stage step % kStages is free
  }
  cp_async_wait<0>();

  // this lane's fragment positions: rows 16 warp + gr (+ 8), columns
  // 8 j + 2 tq (+ 1) of the tile; bottleneck ranks 8 j + 2 tq (+ 1)
  const int row0 = warp * 16 + gr, col0 = 2 * tq;
  __syncthreads();                                    // the ring is free: reuse it
  if (gridDim.z > 1) {
    // The K ranges of one tile are one cluster along z.  Rank z > 0 leaves
    // its f32 sums in its shared memory, fragment by fragment; rank 0 adds
    // them in rank order through distributed shared memory and finishes.
    cg::cluster_group cluster = cg::this_cluster();
    float* xch = reinterpret_cast<float*>(smem_raw);  // [(FN + XN) * 4][kMmaThreads]
    const unsigned rank = cluster.block_rank();
    if (rank > 0) {
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) xch[(4 * j + e) * kMmaThreads + tid] = acc[j][e];
#pragma unroll
      for (int j = 0; j < XN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xch[(4 * (FN + j) + e) * kMmaThreads + tid] = xacc[j][e];
    }
    cluster.sync();
    if (rank == 0) {
      for (unsigned z = 1; z < cluster.num_blocks(); ++z) {
        const float* peer = cluster.map_shared_rank(xch, z);
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] += peer[(4 * j + e) * kMmaThreads + tid];
#pragma unroll
        for (int j = 0; j < XN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            xacc[j][e] += peer[(4 * (FN + j) + e) * kMmaThreads + tid];
      }
    }
    cluster.sync();                                   // the peers' memory is read
    if (rank > 0) return;
  }

  float* sXA = reinterpret_cast<float*>(smem_raw);    // [kBM][XA_PITCH]
  float* sB = sXA + kBM * XA_PITCH;                   // [RP][BN]
#pragma unroll
  for (int j = 0; j < XN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + 8 * (e >> 1), s = 8 * j + 2 * tq + (e & 1);
      if (s < r) {
        sXA[row * XA_PITCH + s] = xacc[j][e];
        if (xa_out != nullptr && blockIdx.x == 0 && m0 + row < M)
          xa_out[static_cast<size_t>(m0 + row) * r + s] = xacc[j][e];
      }
    }
  for (int e = tid; e < r * BN; e += kMmaThreads) {   // walked along B's unit stride
    int s, c;
    if (st.b1 == 1) { s = e / BN; c = e % BN; } else { c = e / r; s = e % r; }
    const int n = n0 + c;
    sB[s * BN + c] = n < N ? __bfloat162float(b[s * st.b0 + n * st.b1]) : 0.f;
  }
  __syncthreads();

#pragma unroll 1
  for (int s = 0; s < r; ++s) {                       // rank by rank, as the plain sum
    const float xa0 = sXA[row0 * XA_PITCH + s], xa1 = sXA[(row0 + 8) * XA_PITCH + s];
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      const float b0 = sB[s * BN + col0 + 8 * j], b1 = sB[s * BN + col0 + 8 * j + 1];
      acc[j][0] = fmaf(xa0, b0, acc[j][0]);
      acc[j][1] = fmaf(xa0, b1, acc[j][1]);
      acc[j][2] = fmaf(xa1, b0, acc[j][2]);
      acc[j][3] = fmaf(xa1, b1, acc[j][3]);
    }
  }

  const bool pairs = N % 2 == 0;                      // y rows 4-byte aligned
#pragma unroll
  for (int j = 0; j < FN; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + row0 + 8 * h, n = n0 + col0 + 8 * j;
      if (m >= M || n >= N) continue;
      bf16* dst = y + static_cast<size_t>(m) * N + n;
      if (pairs) {
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
      } else {
        dst[0] = __float2bfloat16(acc[j][2 * h]);
        if (n + 1 < N) dst[1] = __float2bfloat16(acc[j][2 * h + 1]);
      }
    }
}

struct Args {
  const bf16 *x, *w, *a, *b;
  bf16* y;
  float* xa;
  int M, K, N, r, flags, k_split, nodes;
  Strides st;
};

template <int BN, int RT, bool WROW, bool AROW>
int launch_mma(const Args& g, cudaStream_t stream) {
  constexpr int bytes = mma_smem_bytes<BN, RT>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        lora_mma_kernel<BN, RT, WROW, AROW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  // one cluster per output tile: its blocks along z take the K ranges
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((g.N + BN - 1) / BN, g.nodes * ((g.M + kBM - 1) / kBM),
                     (g.K + g.k_split - 1) / g.k_split);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = cfg.gridDim.z;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, lora_mma_kernel<BN, RT, WROW, AROW>, g.x,
                                             g.w, g.a, g.b, g.y, g.xa, g.M, g.K, g.N, g.r,
                                             g.st, g.flags, g.k_split));
}

template <int BN, int RT>
int launch_tile(const Args& g, cudaStream_t stream) {
  const bool wrow = g.flags & kRowW, arow = g.flags & kRowA;
  if (wrow)
    return arow ? launch_mma<BN, RT, true, true>(g, stream)
                : launch_mma<BN, RT, true, false>(g, stream);
  return arow ? launch_mma<BN, RT, false, true>(g, stream)
              : launch_mma<BN, RT, false, false>(g, stream);
}

template <int BN>
int launch_ranks(const Args& g, cudaStream_t stream) {
  return g.r <= kRankTile ? launch_tile<BN, 1>(g, stream) : launch_tile<BN, 2>(g, stream);
}

int launch_bf16(const Args& g, int bn, cudaStream_t stream) {
  const int splits = g.k_split < 1 ? 0 : (g.K + g.k_split - 1) / g.k_split;
  if (g.k_split < 1 || g.k_split % kBK != 0 || splits > kMaxSplits ||
      static_cast<long long>(g.nodes) * ((g.M + kBM - 1) / kBM) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bn == 64) return launch_ranks<64>(g, stream);
  if (bn == 32) return launch_ranks<32>(g, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ----------------------------------------------------------------- f32 path
// One block of 256 threads per 64 x 64 output tile.  Each step of the K
// loop stages a 64 x 32 tile of x, a 32 x 64 tile of W and a 32 x r tile of
// A in shared memory (rows padded by one word); each loader walks its tile
// in the order of its operand's unit stride, so the loads of a transposed
// operand stay coalesced.  A thread issues all of its loads of a step
// together into registers, and the next step's loads before it computes on
// the current tiles, so a step costs one memory round trip and that trip
// overlaps the arithmetic.  Each thread owns a 4 x 4 micro-tile of the
// output (rows ty + 16 i, columns tx + 16 j) and up to 8 RT of the tile's
// 64 x r bottleneck sums in registers (row tid / 4, ranks tid % 4 + 4 q),
// so no index inside the K loop divides by the runtime rank; RT, the rank
// tiles of 32, is a template parameter as in the bf16 path.  After the
// loop the bottleneck goes to shared memory, and B's rows take W's place
// one rank tile of BK = 32 at a time (W's tile holds BK rows): each thread
// adds the tile's rank product before the next is staged, then stores.
// Static shared memory stays under 48 KB (41.7 KB at RT 2).  Edges past M, N,
// K are zero-filled on load and masked on store.  TF32 tensor cores keep
// ~3 decimal digits and would not hold chip_smoke.py's f32 checks (1e-4
// on the kernel, 1e-3 on the federation oracle).
constexpr int BM = 64, BN = 64, BK = 32, kThreads = 256;
static_assert(BM * 4 == kThreads, "four threads share each row of the bottleneck");
static_assert(BK == kRankTile, "a rank tile of B fills W's tile");
constexpr int kXLoads = BM * BK / kThreads;              // per thread per K step
constexpr int kWLoads = BK * BN / kThreads;

// Element e of a thread's share of each tile sits at (row, col): the order
// follows the operand's unit stride, so neighbouring threads load
// neighbouring addresses.
__device__ __forceinline__ void x_at(int e, int& row, int& col) {
  row = e / BK;
  col = e % BK;
}
__device__ __forceinline__ void w_at(int e, const Strides& st, int& row, int& col) {
  if (st.w1 == 1) { row = e / BN; col = e % BN; } else { col = e / BK; row = e % BK; }
}
// A's tile is walked as BK x RP, so no index needs a division by the
// runtime rank; the lanes past r load nothing and store zeros.
template <int RP>
__device__ __forceinline__ void a_at(int e, const Strides& st, int& row, int& s) {
  if (st.a1 == 1) {
    row = e / RP;
    s = e % RP;
  } else {
    s = e / BK;
    row = e % BK;
  }
}

// One K step's loads, all in flight together.
template <int RT>
__device__ __forceinline__ void load_step(const float* __restrict__ x,
                                          const float* __restrict__ w,
                                          const float* __restrict__ a, int m0, int n0,
                                          int k0, int M, int K, int N, int r,
                                          const Strides& st, int tid, float* xr, float* wr,
                                          float* ar) {
#pragma unroll
  for (int j = 0; j < kXLoads; ++j) {
    int row, col;
    x_at(tid + j * kThreads, row, col);
    const int m = m0 + row, k = k0 + col;
    xr[j] = (m < M && k < K) ? x[static_cast<size_t>(m) * K + k] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kWLoads; ++j) {
    int row, col;
    w_at(tid + j * kThreads, st, row, col);
    const int k = k0 + row, n = n0 + col;
    wr[j] = (k < K && n < N) ? w[k * st.w0 + n * st.w1] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < BK * kRankTile * RT / kThreads; ++j) {
    int row, s;
    a_at<kRankTile * RT>(tid + j * kThreads, st, row, s);
    const int k = k0 + row;
    ar[j] = (s < r && k < K) ? a[k * st.a0 + s * st.a1] : 0.f;
  }
}

template <int RT>
__global__ void __launch_bounds__(kThreads)
lora_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ y, float* __restrict__ xa_out, int M, int K, int N,
                int r, Strides st) {
  constexpr int RP = kRankTile * RT;                // columns of A's tile
  constexpr int kXaPerThread = RP / 4;              // bottleneck sums a thread owns
  constexpr int kALoads = BK * RP / kThreads;
  __shared__ float sX[BM][BK + 1];
  __shared__ float sW[BK][BN + 1];                  // after the K loop: B's rank tiles
  __shared__ float sA[BK][RP + 1];
  __shared__ float sXA[BM][RP + 1];

  int m0;
  const int node = node_tile(M, BM, m0);
  const int n0 = blockIdx.x * BN;
  x += static_cast<size_t>(node) * M * K;
  y += static_cast<size_t>(node) * M * N;
  if (xa_out != nullptr) xa_out += static_cast<size_t>(node) * M * r;
  a += node * st.a_node;
  b += node * st.b_node;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // the bottleneck sums a thread owns: row xa_row, ranks xa_s0 + 4 q < r
  const int xa_row = tid / 4, xa_s0 = tid % 4;

  float acc[4][4], xa[kXaPerThread];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int q = 0; q < kXaPerThread; ++q) xa[q] = 0.f;

  float xr[kXLoads], wr[kWLoads], ar[kALoads];
  load_step<RT>(x, w, a, m0, n0, 0, M, K, N, r, st, tid, xr, wr, ar);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int j = 0; j < kXLoads; ++j) {
      int row, col;
      x_at(tid + j * kThreads, row, col);
      sX[row][col] = xr[j];
    }
#pragma unroll
    for (int j = 0; j < kWLoads; ++j) {
      int row, col;
      w_at(tid + j * kThreads, st, row, col);
      sW[row][col] = wr[j];
    }
#pragma unroll
    for (int j = 0; j < kALoads; ++j) {
      int row, s;
      a_at<RP>(tid + j * kThreads, st, row, s);
      sA[row][s] = ar[j];
    }
    __syncthreads();
    if (k0 + BK < K)                      // the next step's loads overlap this step's math
      load_step<RT>(x, w, a, m0, n0, k0 + BK, M, K, N, r, st, tid, xr, wr, ar);

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = sX[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = sW[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += xv[i] * wv[j];
    }
#pragma unroll
    for (int q = 0; q < kXaPerThread; ++q) {
      const int s = xa_s0 + 4 * q;
      if (s < r) {
        float sum = 0.f;
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) sum += sX[xa_row][kk] * sA[kk][s];
        xa[q] += sum;
      }
    }
    __syncthreads();                                 // tiles read before they are replaced
  }

#pragma unroll
  for (int q = 0; q < kXaPerThread; ++q) {
    const int s = xa_s0 + 4 * q;
    if (s < r) {
      sXA[xa_row][s] = xa[q];
      if (xa_out != nullptr && blockIdx.x == 0 && m0 + xa_row < M)
        xa_out[static_cast<size_t>(m0 + xa_row) * r + s] = xa[q];
    }
  }
#pragma unroll
  for (int t = 0; t < RT; ++t) {                    // B's rank tiles, in W's place
    const int s0 = t * BK;
    if (s0 >= r) break;
    const int rt = RT == 1 ? r : min(r - s0, BK);
    if (t > 0) __syncthreads();                      // the previous tile is read
    for (int e = tid; e < rt * BN; e += kThreads) {
      int s, col;
      if (st.b1 == 1) { s = e / BN; col = e % BN; } else { col = e / rt; s = e % rt; }
      const int n = n0 + col;
      sW[s][col] = n < N ? b[(s0 + s) * st.b0 + n * st.b1] : 0.f;
    }
    __syncthreads();

    for (int s = 0; s < rt; ++s) {
      float xv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = sXA[ty + 16 * i][s0 + s];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sW[s][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += xv[i] * bv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) y[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

int launch_f32(const Args& g, const void* x, const void* w, const void* a, const void* b,
               void* y, cudaStream_t stream) {
  if (static_cast<long long>(g.nodes) * ((g.M + BM - 1) / BM) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((g.N + BN - 1) / BN, g.nodes * ((g.M + BM - 1) / BM));
  const float *xf = static_cast<const float*>(x), *wf = static_cast<const float*>(w),
              *af = static_cast<const float*>(a), *bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  if (g.r <= kRankTile)
    lora_fma_kernel<1><<<grid, kThreads, 0, stream>>>(xf, wf, af, bf, yf, g.xa, g.M, g.K,
                                                      g.N, g.r, g.st);
  else
    lora_fma_kernel<2><<<grid, kThreads, 0, stream>>>(xf, wf, af, bf, yf, g.xa, g.M, g.K,
                                                      g.N, g.r, g.st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides are in elements; ranks 1..64.  `nodes` stacks x, y and xa (each
// (nodes, M, .) contiguous); A and B advance by sa_node / sb_node elements
// from one node to the next (0: shared).  bf16 only: `flags` (kVec* / kRow*
// bits), the tile width bn (64 or 32) and k_split (a multiple of 64; K /
// k_split rounded up is the number of K ranges, at most 8) come from the
// wrapper.  Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int lora_matmul_launch(const void* x, const void* w, const void* a,
                                  const void* b, void* y, void* xa, int M, int K, int N,
                                  int r, long long sw0, long long sw1,
                                  long long sa0, long long sa1, long long sb0,
                                  long long sb1, int flags, int bn, int k_split,
                                  int is_bf16, int nodes, long long sa_node,
                                  long long sb_node, void* stream) {
  if (M < 1 || K < 1 || N < 1 || r < 1 || r > kMaxRank || nodes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args g{static_cast<const bf16*>(x), static_cast<const bf16*>(w),
               static_cast<const bf16*>(a), static_cast<const bf16*>(b),
               static_cast<bf16*>(y), static_cast<float*>(xa), M, K, N, r, flags, k_split,
               nodes, Strides{sw0, sw1, sa0, sa1, sb0, sb1, sa_node, sb_node}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_bf16(g, bn, s);
  return launch_f32(g, x, w, a, b, y, s);
}
