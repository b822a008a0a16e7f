// Causal, full, sliding-window or chunked full-sequence (prefill and
// training) attention with an online softmax, forward only.
//
// Replaces: repro/kernels/flash_attention.py, flash_attention_pallas
// (`_flash_kernel`; its jnp twin blockwise_attention is what the JAX
// prefill runs).
//
// q (B, T, H, dh), k (B, S, KV, dh), v (B, S, KV, dv) -- the
// blockwise_attention layout, so gqa_forward passes its projections
// without a transpose copy; out (B, T, H, dv) in q's dtype (bf16 or f32);
// dv == dh but for MLA's (192, 128).  Query head h reads KV head
// h / (H / KV).  Causal masking is aligned bottom-right, k <= q + (S - T),
// as in the JAX oracle; with S == T (prefill) it is the Pallas rule.  With
// window > 0 a key is also dropped once it lies window or more behind the
// row, q + (S - T) - k < window (blockwise_attention's "sliding" kind: the
// dense family's sliding-window variant and the hybrid family's local
// attention).  With chunk > 0 a key is visible when it also lies in the
// row's chunk of positions, k >= qk - qk % chunk with qk = q + (S - T)
// (blockwise_attention's "chunked" kind: llama4's local attention; the
// Pallas kernel has no such mask).  window and chunk exclude each other;
// both set a first visible key per row that never decreases down the
// rows (first_key).  A row with no visible key gets 0.  Key tiles above
// the diagonal of a block's last row, and tiles wholly before the first
// visible key of its first row, are never loaded; a warp skips the loaded
// tiles that lie outside its own rows' range.
//
// causal == 0 is the Pallas kernel's full mask (the audio family's
// encoder and its decoder's cross attention, T != S allowed): every key
// 0..S-1 is visible to every row, a key past S never.  The kernels take it
// as the causal mask with the rows shifted past the last key (shift = S
// instead of S - T): the diagonal then lies beyond every tile, so no tile
// is skipped, no row masks a key of its own and the first key is 0 (the
// wrapper refuses a window or a chunk with it).  Only the key-past-S test
// of the ragged last tile stays.  Every row does equal work, so the
// causal pairing of segments below is harmless there.
//
// The causal pairing of segments below balances a triangle of work, not
// the staircase a chunked mask leaves: under a chunk a block still loads
// every tile from its first row's chunk start, and a warp whose rows lie
// in a later chunk skips most of them.
//
// What bounds it: causal attention does ~2 T^2 dh H flops on
// ~4 T (H + KV) dh bytes of bf16 input and output, so its flops per byte
// grow with T.  At fedmm-base prefill (T = S = 512, H 16, KV 8, dh 64) that
// is ~170 flop/byte, under the H100's ~295 bf16 ridge: the bound is bytes
// (~0.9 us); from T ~ 900 on it is the tensor cores.  At these sizes the
// time is set by latency and instruction issue on the SMs that hold the
// longest causal rows, not by either bound.
//
// Before (the first port): one block of 256 threads per 64-row query tile ran
// both products as f32 FMAs on the CUDA cores, every FMA pair fed by two
// shared-memory loads, with no overlap of a tile's load and the previous
// tile's math.  The last tile at T 512 walks 8 key tiles, 8 x 2 x 64^3 ~
// 4.2 M FMAs on one SM's 128 f32 lanes: ~18 us of FMAs alone, ~79 us in
// all.  At the round's T 16 three quarters of each 64-row tile was padding.
//
// bf16 design (FlashAttention-2 in shape, mma.sync on the tensor cores):
//   * A warp owns 16 query rows of one head and keeps their Q fragments in
//     registers for the whole key loop (loaded once from global memory).
//   * S = Q K^T runs as mma.sync.m16n8k16 bf16 -> f32, K fragments by
//     ldmatrix.  The online softmax runs in registers on the f32
//     accumulator fragments; the row max and row sum reduce over the 4
//     lanes of a row.  The max is kept in raw-score units and the dh^-0.5
//     log2(e) scale is applied in f32 inside one FFMA before ex2.approx,
//     so Q is never scaled in bf16 (at dh 128 the scale is not a power of
//     two and Q would be rounded twice).
//   * P is rounded to bf16 in registers and is the A operand of P V
//     directly; V fragments come by ldmatrix.trans.  The row sum l takes
//     the f32 p before rounding.
//   * K and V tiles of 64 keys are staged as bf16 in a two-stage ring
//     filled by cp.async (16 bytes a thread, zero-fill past S), so the
//     next tiles load while these compute.  Each 16-byte chunk c of key
//     row r lies at chunk c ^ (r & 7) of its row: the 8 rows an ldmatrix
//     phase reads hit 8 distinct bank groups.
//   * Rows: a block holds HB heads of one KV group (one K/V tile serves all
//     of them) x RQ query rows per head, one row warp per 16 rows, at most
//     4 row warps.  RQ = 16 ceil(T / 16) capped at 64; HB is the largest
//     divisor of rep = H / KV with HB RQ / 16 <= 4.  The 16-row segments
//     of a head are dealt to its P blocks in pairs, segment j with 2P-1-j
//     (then 2P+j with 4P-1-j), so every block holds a short and a long
//     causal row range: at T 512 each block does 18 warp-tiles of work
//     instead of 1 to 32.
//   * Keys: while the grid is short of 4 blocks an SM, the row warps are
//     repeated in KS = 2 or 4 key groups (4 only at dh 64, where a thread
//     fits in 128 registers); group kg takes key tiles kg, kg + KS, ...
//     with its own (m, l, o), and the groups merge through shared memory
//     at the end.  This shortens the serial key loop and gives each SM
//     more warps to hide latency with.
//   * The serve prefill (T 512, H 16, KV 8) runs 128 blocks of 4 row warps
//     x 4 key groups; the round (T 16, rep 3) runs 128 blocks of 3 warps,
//     the 3 heads of a group in one block with no padded rows.
//
// dh 256 (RecurrentGemma's local attention) does not fit that plan: the
// O accumulator alone is 16 x 256 f32 a warp, 128 registers a lane, and
// the Q fragments held across the key loop would add 64 more.  So at dh
// 256 a tile holds 32 keys (the score and P fragments halve), each warp
// stages its 16 Q rows once in shared memory (cp.async, swizzled as the K
// tile) and reads them by ldmatrix for every tile, and one key group
// runs (KS 1): 128 threads and 96 KB of shared memory a block, two blocks
// an SM.  dh 64 and 128 keep the plan above.
//
// DeepSeek-V2's MLA prefill gives q.k heads of 192 (128 nope + 64 rope)
// and v heads of 128, so both kernels are templated on the two head dims
// (DQK, DV), and the wrapper accepts a pair only where it is built: (64,
// 64), (128, 128), (256, 256) and (192, 128).  At (192, 128) the bf16
// plan is dh 128's (64-key tiles, Q fragments in registers: 12 k-steps of
// 4 registers, beside an O accumulator of 16 x 128), with a K tile of 192
// columns (24 16-byte chunks a row, swizzled like the others) and a V
// tile of 128; its shared memory is 80 KB a key group.  Nothing is
// padded: K and V are read at their own widths.
//
// Phi-3-vision's heads of 96 (its prefill: T up to ~2,000, H = KV 32)
// take dh 64's and 128's plan: 64-key tiles, Q fragments in registers (6
// k-steps of 4 registers) beside an O accumulator of 16 x 96.  A 192-byte
// row is 12 16-byte chunks, which c ^ (r & 7) would carry out of the row,
// and padding it to 128 elements would cost a third more shared memory
// and copies; mma.cuh's swz keeps the row at 12 chunks and swizzles its
// last 4 as a 64-byte row, still free of ldmatrix bank conflicts.
// kMaxKS<96> is 2 from ptxas's report: at 2 (256 threads, <= 255
// registers) the kernel takes 178 registers and spills nothing; at 4 (512
// threads, <= 128) it spills 108 bytes.  48 KB of shared memory a key
// group.
//
// The f32 instantiations keep the FMA body of the first port (the second kernel
// below).  They exist for chip_smoke.py's f32 checks (TOL 1e-4) and its
// f32 serve oracle (1e-3 of max |logit|); TF32 tensor cores keep ~3
// decimal digits and would not hold those tolerances.  In it one block of
// 256 threads per (64-row query tile, head, batch) holds Q (pre-scaled by
// dh^-0.5), K, V and the probability tile in shared memory as f32; each
// thread owns a 4 x 4 score micro-tile and a 4 x (dh / 16) accumulator.
// At dh 256 a tile's 16-byte loads are issued 8 at a time (the staging
// registers of 16 would not fit beside the accumulator), and its shared
// memory is 209 KB, one block an SM.
//
// q, k and v must be 16-byte aligned (the wrapper checks).
#include "mma.cuh"

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

using namespace repro;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- bf16 path
constexpr int kMaxWarps = 4;                          // row warps per key group
constexpr int kStages = 2;                            // the cp.async ring

// keys per tile: 64, and 32 at dh 256 (see the note at the top); DQK is
// the q.k head dim
template <int DQK>
constexpr int kBK = DQK == 256 ? 32 : 64;

// Q fragments from shared memory (dh 256) instead of registers
template <int DQK>
constexpr bool kQShared = DQK == 256;

// key groups per block at most: 16 warps of <= 128 registers at dh 64, 8
// warps at dh 96, 128 and (192, 128) (more registers a thread), 4 at dh
// 256
template <int DQK>
constexpr int kMaxKS = DQK == 64 ? 4 : DQK == 256 ? 1 : 2;

// 2^x on the special-function unit (exp2f adds range handling around it)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the first key a row at position qk may see: past its window (window
// > 0) and at or after the start of its chunk (chunk > 0); 0 for the
// causal mask.  Never decreases as qk grows.
__device__ __forceinline__ int first_key(int qk, int window, int chunk) {
  int lo = window > 0 ? qk - window + 1 : 0;
  if (chunk > 0 && qk > 0) lo = max(lo, qk - qk % chunk);
  return lo;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int DQK, int DV>
constexpr size_t mma_smem_bytes(int ks) {
  return sizeof(bf16) * (kStages * ks * kBK<DQK> * (DQK + DV) +
                         (kQShared<DQK> ? kMaxWarps * 16 * DQK : 0));
}

template <int DQK, int DV>
__global__ void __launch_bounds__(32 * kMaxWarps * kMaxKS<DQK>)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int Tq,
                 int S, int H, int KV, int RQ, int HB, int KS, int window,
                 int chunk, int causal, float scale_log2) {
  constexpr int BK = kBK<DQK>;                        // keys per tile
  constexpr int NJ = BK / 8;                          // 8-key column tiles of S
  constexpr int NKC = BK / 16;                        // 16-key k-steps of P V
  constexpr bool QS = kQShared<DQK>;
  constexpr int CH = DQK / 8;                         // 16-byte chunks per key row
  constexpr int CHV = DV / 8;                         // ... per value row
  constexpr int KC = DQK / 16;                        // k-steps of Q K^T
  constexpr int NO = DV / 8;                          // 8-column tiles of the output
  constexpr int TILE = BK * DQK;                      // elements of one K tile
  constexpr int TILEV = BK * DV;                      // ... of one V tile
  constexpr int NS = kStages;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);       // [NS stages][KS][BK][DQK], swizzled
  bf16* sV = sK + NS * KS * TILE;                     // [NS][KS][BK][DV], swizzled

  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, gr = lane / 4, tq = lane % 4;
  const int nw = HB * (RQ / 16);                      // warps per key group
  const int kg = warp / nw, rw = warp % nw;           // key group, row warp
  const int wph = RQ / 16;                            // row warps per head
  const int h = blockIdx.y * HB + rw / wph;
  // the 16-row segments of a head are dealt to its gridDim.x blocks so that
  // each holds a cheap and a dear one under the causal mask: row warp w of
  // block j takes segment j (w = 0), 2P - 1 - j (w = 1), 2P + j (w = 2), ...
  const int P = gridDim.x, j = blockIdx.x;
  auto segment = [&](int w) { return (w / 2) * 2 * P + (w % 2 ? 2 * P - 1 - j : j); };
  const int t0 = segment(rw % wph) * 16;              // this warp's first row
  const int b = blockIdx.z;
  const int g = blockIdx.y * HB / (H / KV);
  // bottom-right causal alignment; under the full mask the rows lie past
  // every key (see the note at the top)
  const int shift = causal ? S - Tq : S;
  // keys past kend are masked for every row of the block, and keys before
  // kbeg by the window or chunk of every row; past wend or before wbeg
  // for every row of this warp (wend 0 when the warp holds no row)
  int first = Tq, last = -1;                          // the block's first and last row
  for (int w = 0; w < wph; ++w)
    if (segment(w) * 16 < Tq) {
      first = min(first, segment(w) * 16);
      last = max(last, min(Tq - 1, segment(w) * 16 + 15));
    }
  const int kend = min(S, last + 1 + shift);
  const int kbeg = max(0, first_key(first + shift, window, chunk));
  const int tile0 = kbeg / BK;                        // the first tile loaded
  const int ntiles = kend > 0 ? max(0, (kend + BK - 1) / BK - tile0) : 0;
  const int nsteps = (ntiles + KS - 1) / KS;          // key group kg takes tile step * KS + kg
  const int wend = t0 < Tq ? min(S, min(t0 + 15, Tq - 1) + 1 + shift) : 0;
  const int wbeg = first_key(t0 + shift, window, chunk);
  // a tile from here on (and at or below the diagonal) is whole for
  // every row of the warp
  const int whole_beg = first_key(t0 + 15 + shift, window, chunk);

  // K and V chunks of one key row from one thread, back to back (a K
  // loop then a V loop ran the dh 64 / 128 / 256 prefills 27-32% slower
  // on an H100); V's row has CHV <= CH chunks, and DV == DQK folds the test
  auto load_step = [&](int step) {                    // the KS tiles of one step
    const int stage = step % NS;
    for (int i = tid; i < KS * BK * CH; i += nthreads) {
      const int j = i / (BK * CH), r = i / CH % BK, c = i % CH;
      const int tile = step * KS + j, s = (tile0 + tile) * BK + r;
      if (tile >= ntiles) break;                      // j only grows along i
      const size_t row = (static_cast<size_t>(b) * S + min(s, S - 1)) * KV + g;
      cp_async16(sK + (stage * KS + j) * TILE + swz<DQK>(r, c), k + row * DQK + c * 8,
                 s < S);
      if (DV == DQK || c < CHV)
        cp_async16(sV + (stage * KS + j) * TILEV + swz<DV>(r, c), v + row * DV + c * 8,
                   s < S);
    }
  };
  // at dh 256 each warp stages its own 16 Q rows (zero past Tq) with the
  // first step's tiles; they have landed when that step's wait returns
  bf16* sQ = sV + NS * KS * TILEV + warp * 16 * DQK;  // [16][DQK], swizzled
  if constexpr (QS) {
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = i / CH, c = i % CH, row = t0 + r;
      cp_async16(sQ + swz<DQK>(r, c),
                 q + ((static_cast<size_t>(b) * Tq + min(row, Tq - 1)) * H + h) * DQK + c * 8,
                 row < Tq);
    }
  }
#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {               // NS - 1 steps ahead
    if (st < nsteps) load_step(st);
    cp_async_commit();
  }

  // Q fragments (A operand, 16 rows x DQK) straight from global memory
  const int ra = t0 + gr, rb = ra + 8;                // this lane's two rows
  const int lo[2] = {first_key(ra + shift, window, chunk),
                     first_key(rb + shift, window, chunk)};
  uint32_t qf[QS ? 1 : KC][4];
  if constexpr (!QS) {
    const bf16* qa = q + ((static_cast<size_t>(b) * Tq + ra) * H + h) * DQK + 2 * tq;
    const bf16* qb = q + ((static_cast<size_t>(b) * Tq + rb) * H + h) * DQK + 2 * tq;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      qf[kk][0] = ra < Tq ? ld32(qa + 16 * kk) : 0u;
      qf[kk][1] = rb < Tq ? ld32(qb + 16 * kk) : 0u;
      qf[kk][2] = ra < Tq ? ld32(qa + 16 * kk + 8) : 0u;
      qf[kk][3] = rb < Tq ? ld32(qb + 16 * kk + 8) : 0u;
    }
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int step = 0; step < nsteps; ++step) {
    if (step + NS - 1 < nsteps) load_step(step + NS - 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();                          // this step's tiles have landed
    __syncthreads();
    const int k0 = (tile0 + step * KS + kg) * BK;
    if (k0 < wend && k0 + BK > wbeg) {                // warp-uniform
      const bf16* Ks = sK + ((step % NS) * KS + kg) * TILE;
      const bf16* Vs = sV + ((step % NS) * KS + kg) * TILEV;

      float sc[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      if constexpr (QS) {
#pragma unroll
        for (int p = 0; p < KC / 2; ++p) {            // 32 dh each
          uint32_t qa[2][4];                          // k-steps 2p and 2p + 1
          ldsm_x4(qa[0], sQ + swz<DQK>(lane & 15, 4 * p + (lane >> 4)));
          ldsm_x4(qa[1], sQ + swz<DQK>(lane & 15, 4 * p + 2 + (lane >> 4)));
#pragma unroll
          for (int j = 0; j < NJ; ++j) {              // 8 keys each
            uint32_t kb[4];
            ldsm_x4(kb, Ks + swz<DQK>(8 * j + (lane & 7), 4 * p + (lane >> 3)));
            mma_bf16(sc[j], qa[0], kb[0], kb[1]);
            mma_bf16(sc[j], qa[1], kb[2], kb[3]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {                // 8 keys each
#pragma unroll
          for (int p = 0; p < KC / 2; ++p) {          // 32 dh each
            uint32_t kb[4];
            const int r = 8 * j + (lane & 7);
            ldsm_x4(kb, Ks + swz<DQK>(r, 4 * p + (lane >> 3)));
            mma_bf16(sc[j], qf[2 * p], kb[0], kb[1]);
            mma_bf16(sc[j], qf[2 * p + 1], kb[2], kb[3]);
          }
        }
      }

      // every key of the tile visible to every row of the warp?  Else
      // mask; m is kept in units of raw scores (the scale is positive)
      float mx[2] = {-INFINITY, -INFINITY};
      if (k0 + BK <= S && k0 + BK - 1 <= t0 + shift && k0 >= whole_beg) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      } else {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * tq + (e & 1);
            const int qk = (e < 2 ? ra : rb) + shift;   // the row's own key
            if (key >= S || key > qk || key < lo[e >> 1]) sc[j][e] = -INFINITY;
            mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
          }
      }
      float base[2], corr[2];                         // base: the row max, scaled
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], group_max<4>(mx[i]));
        base[i] = m_new == -INFINITY ? 0.f : m_new * scale_log2;  // none seen: p = 0
        corr[i] = fast_exp2(fmaf(m[i], scale_log2, -base[i]));
        m[i] = m_new;
      }

      float rs[2] = {0.f, 0.f};
      uint32_t pf[NKC][4];                            // P as A operand, 16 keys each
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p0 = fast_exp2(fmaf(sc[j][0], scale_log2, -base[0]));
        const float p1 = fast_exp2(fmaf(sc[j][1], scale_log2, -base[0]));
        const float p2 = fast_exp2(fmaf(sc[j][2], scale_log2, -base[1]));
        const float p3 = fast_exp2(fmaf(sc[j][3], scale_log2, -base[1]));
        rs[0] += p0 + p1;
        rs[1] += p2 + p3;
        pf[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
        pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + group_sum<4>(rs[i]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }

#pragma unroll
      for (int kc = 0; kc < NKC; ++kc) {              // 16 keys each
#pragma unroll
        for (int n2 = 0; n2 < NO / 2; ++n2) {         // 16 output columns each
          uint32_t vb[4];
          const int r = 16 * kc + (lane & 7) + 8 * ((lane >> 3) & 1);
          ldsm_x4_trans(vb, Vs + swz<DV>(r, 2 * n2 + (lane >> 4)));
          mma_bf16(o[2 * n2], pf[kc], vb[0], vb[1]);
          mma_bf16(o[2 * n2 + 1], pf[kc], vb[2], vb[3]);
        }
      }
    }
    __syncthreads();                                  // stage step % NS is free again
  }
  if constexpr (QS) cp_async_wait<0>();               // no copy outlives the block

  if (KS > 1) {
    // key groups 1 .. KS-1 hand their (m, l, o) to group 0 through shared
    // memory (the K/V ring is free: every copy has landed and every read is
    // done); each lane of a row warp holds the same fragment positions in
    // every group
    constexpr int W = NO * 4 + 4;                     // floats per lane
    cp_async_wait<0>();
    float* xch = reinterpret_cast<float*>(smem_raw) + (rw * 32 + lane) * W;
    const int gstride = nw * 32 * W;                  // floats per key group
    if (kg > 0) {
      float* x = xch + (kg - 1) * gstride;
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[4 * n + e] = o[n][e];
      x[4 * NO] = m[0];
      x[4 * NO + 1] = m[1];
      x[4 * NO + 2] = l[0];
      x[4 * NO + 3] = l[1];
    }
    __syncthreads();
    if (kg != 0) return;
    for (int from = 1; from < KS; ++from) {
      const float* x = xch + (from - 1) * gstride;
      float c0[2], c1[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m1 = x[4 * NO + i], m_new = fmaxf(m[i], m1);
        const float base = m_new == -INFINITY ? 0.f : m_new;
        c0[i] = fast_exp2((m[i] - base) * scale_log2);
        c1[i] = fast_exp2((m1 - base) * scale_log2);
        l[i] = l[i] * c0[i] + x[4 * NO + 2 + i] * c1[i];
        m[i] = m_new;
      }
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = o[n][e] * c0[e >> 1] + x[4 * n + e] * c1[e >> 1];
    }
  }

  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? rb : ra;
    if (row >= Tq) continue;
    bf16* dst = out + ((static_cast<size_t>(b) * Tq + row) * H + h) * DV + 2 * tq;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          pack_bf16(o[n][2 * i] * inv[i], o[n][2 * i + 1] * inv[i]);
  }
}

template <int DQK, int DV>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B, int Tq,
               int S, int H, int KV, int window, int chunk, int causal, float scale,
               cudaStream_t stream) {
  static int n_sm = 0;                                // set on the first launch
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_mma_kernel<DQK, DV>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(mma_smem_bytes<DQK, DV>(kMaxKS<DQK>)));
    if (err != cudaSuccess) {
      n_sm = 0;
      return static_cast<int>(err);
    }
  }
  // block shape: RQ query rows per head x HB heads of one KV group, one
  // warp per 16 rows, at most kMaxWarps warps, times KS key groups (see
  // the note at the top)
  const int rep = H / KV;
  const int rq = std::min(64, (Tq + 15) / 16 * 16);
  int hb = 1;
  for (int d = 1; d <= rep; ++d)
    if (rep % d == 0 && d * (rq / 16) <= kMaxWarps) hb = d;
  const dim3 grid((Tq + rq - 1) / rq, H / hb, B);
  // key groups: split the key tiles while the grid leaves the card short
  // of 4 blocks' worth per SM, never past the number of key tiles
  const long long blocks = static_cast<long long>(grid.x) * grid.y * grid.z;
  int ks = 1;
  while (2 * ks <= kMaxKS<DQK> && 2 * ks <= (S + kBK<DQK> - 1) / kBK<DQK> &&
         blocks * 2 * ks <= 4LL * n_sm)
    ks *= 2;
  const size_t bytes = mma_smem_bytes<DQK, DV>(ks);
  flash_mma_kernel<DQK, DV><<<grid, 32 * hb * (rq / 16) * ks, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Tq, S, H, KV, rq, hb, ks,
      window, chunk, causal, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------------- f32 path
constexpr int kThreads = 256;
constexpr int BQ = 64, BK = 64;

template <int DQK, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (DQK + 1) + BK * (DQK + 1) + BK * DV + BQ * (BK + 1));
}

// the most of n (<= 8) that divides n: 16-byte loads in flight together
__host__ __device__ constexpr int in_flight(int n) {
  int nb = n < 8 ? n : 8;
  while (n % nb) --nb;
  return nb;
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int Tq, int S,
                 int H, int KV, int window, int chunk, int causal, float scale) {
  using T = float;
  constexpr int DH = DQK;                             // Q and K rows
  constexpr int CPT = DV / 16;                        // output columns per thread
  constexpr int VEC = kVec<T>;
  constexpr int NV = BQ * DH / VEC / kThreads;        // 16-byte loads per Q / K tile per thread
  constexpr int NB = in_flight(NV);                   // of them in flight together
  static_assert(BQ == BK && NV * VEC * kThreads == BQ * DH && DV <= DH && DV % VEC == 0,
                "a tile must split into whole 16-byte loads");
  extern __shared__ float smem[];
  float* sQ = smem;                                   // [BQ][DH + 1]
  float* sK = sQ + BQ * (DH + 1);                     // [BK][DH + 1]
  float* sV = sK + BK * (DH + 1);                     // [BK][DV]
  float* sP = sV + BK * DV;                           // [BQ][BK + 1]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int shift = causal ? S - Tq : S;              // as in the bf16 kernel

#pragma unroll
  for (int j0 = 0; j0 < NV; j0 += NB) {
    uint4 qr[NB];                                     // NB loads in flight, then widen
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int i = (tid + (j0 + j) * kThreads) * VEC, t = q0 + i / DH;
      qr[j] = make_uint4(0u, 0u, 0u, 0u);
      if (t < Tq)
        qr[j] = *reinterpret_cast<const uint4*>(
            q + ((static_cast<size_t>(b) * Tq + t) * H + h) * DH + i % DH);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int i = (tid + (j0 + j) * kThreads) * VEC, r = i / DH, d = i % DH;
      float* dst = &sQ[r * (DH + 1) + d];
      widen16<T>(qr[j], dst);
#pragma unroll
      for (int e = 0; e < VEC; ++e) dst[e] *= scale;
    }
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // keys past kend are masked for every row of this tile, and keys before
  // kbeg by the window or chunk of every row
  const int kend = min(S, q0 + BQ + shift);
  const int kbeg = max(0, first_key(q0 + shift, window, chunk)) / BK * BK;
  int lo[4];                                          // my rows' first visible keys
#pragma unroll
  for (int i = 0; i < 4; ++i) lo[i] = first_key(q0 + ty + 16 * i + shift, window, chunk);
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();                                  // last tile's shared reads are done
    // the K and V elements of one key row from one thread, loads in flight
    // together (as in the bf16 path); V's row has DV <= DH elements
#pragma unroll
    for (int j0 = 0; j0 < NV; j0 += NB) {
      uint4 kr[NB], vr[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int i = (tid + (j0 + j) * kThreads) * VEC, s = k0 + i / DH, d = i % DH;
        kr[j] = vr[j] = make_uint4(0u, 0u, 0u, 0u);     // the ragged tail stages as 0
        if (s < S) {
          const size_t row = (static_cast<size_t>(b) * S + s) * KV + g;
          kr[j] = *reinterpret_cast<const uint4*>(k + row * DH + d);
          if (DV == DH || d < DV) vr[j] = *reinterpret_cast<const uint4*>(v + row * DV + d);
        }
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int i = (tid + (j0 + j) * kThreads) * VEC, r = i / DH, d = i % DH;
        widen16<T>(kr[j], &sK[r * (DH + 1) + d]);
        if (DV == DH || d < DV) widen16<T>(vr[j], &sV[r * DV + d]);
      }
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(ty + 16 * i) * (DH + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = sK[(tx + 16 * j) * (DH + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += qa[i] * kb[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = k0 + tx + 16 * j;
        ok[j] = s < S && s <= t + shift && s >= lo[i];
        mx = fmaxf(mx, ok[j] ? sc[i][j] : kNegInf);
      }
      const float m_new = fmaxf(m[i], group_max<16>(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        sP[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + group_sum<16>(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = sV[kk * DV + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] += pv[i] * vv[c];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* o = out + ((static_cast<size_t>(b) * Tq + t) * H + h) * DV;
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[tx + 16 * c] = from_f<T>(acc[i][c] * inv);
  }
}

template <int DQK, int DV>
int launch_fma(const void* q, const void* k, const void* v, void* out, int B, int Tq,
               int S, int H, int KV, int window, int chunk, int causal, float scale,
               cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DQK, DV>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fma_kernel<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fma_kernel<DQK, DV><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Tq, S, H, KV, window, chunk,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted.  causal != 0 with
// window and chunk 0 is the causal mask; window > 0 the sliding one, chunk
// > 0 the chunked one (not both); causal == 0 the full mask (no window or
// chunk).  dh is q's and k's head dim, dv v's and out's; a pair the
// kernels are not built for is cudaErrorInvalidValue.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int Tq, int S, int H, int KV,
                                      int dh, int dv, int window, int chunk, int causal,
                                      float scale, int is_bf16, void* stream) {
  if (B < 1 || Tq < 1 || S < 1 || KV < 1 || H % KV != 0 || B > 65535 || H > 65535 ||
      window < 0 || chunk < 0 || (window > 0 && chunk > 0) ||
      (!causal && (window > 0 || chunk > 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf = is_bf16 != 0;
#define FLASH_CASE(DQK, DV)                                                              \
  if (dh == DQK && dv == DV)                                                             \
    return bf ? launch_mma<DQK, DV>(q, k, v, out, B, Tq, S, H, KV, window, chunk, causal, \
                                    scale, st)                                          \
              : launch_fma<DQK, DV>(q, k, v, out, B, Tq, S, H, KV, window, chunk, causal, \
                                    scale, st);
  FLASH_CASE(64, 64)
  FLASH_CASE(96, 96)
  FLASH_CASE(128, 128)
  FLASH_CASE(256, 256)
  FLASH_CASE(192, 128)
#undef FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
