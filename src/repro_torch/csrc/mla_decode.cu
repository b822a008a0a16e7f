// Absorbed multi-head latent attention (MLA) decode over the serving
// latent pool: DeepSeek-V2's decode attention, one query per slot.
//
// Replaces: no Pallas kernel.  The JAX package computes this attention
// with jnp einsums inside repro/models/attention.py, mla_decode_slots (the
// scores q_c . c_kv + q_rope . k_rope, the masked softmax, alpha . c_kv).
// The port's two attention kernels cannot take its shape -- every query
// head reads one shared latent row per position, the score side is 576
// wide (512 latent + 64 rope) and the value side is the key's first 512
// values -- so this kernel was added for it.
//
// q_c (S, H, 512) (q_nope with w_uk absorbed), q_rope (S, H, 64), c_kv
// (S, C, 512), k_rope (S, C, 64), lens (S,) int32; out (S, H, 512) in q's
// dtype (bf16 or f32).  Entry c of slot s is visible when c <= lens[s]
// (the reference's mask; at lens == C every entry is).  Scores are
// (q_c . c_kv + q_rope . k_rope) * scale, with the scale passed in
// (DeepSeek-V2's is (nope + rope)^-0.5 = 192^-0.5, not 576^-0.5).
//
// What bounds it: at DeepSeek-V2's pool (S 8, H 128) each latent row a
// slot reads serves 128 heads: 2 x 128 x (576 + 512) flops per 1,152
// bytes of bf16, ~240 flop/byte, just under the H100's bf16 ridge (~295).
// So the visible rows' bytes and the tensor cores bound it about equally
// (chip_smoke.py prints which is larger for its lens): a kernel on the
// CUDA cores' FMAs could not come within ~10x of that.
//
// Three designs; kernels/mla_decode.py (mla_plan) names the one a call
// takes from (dtype, H), and the launch refuses a design the shape does
// not fit:
//
// * wgmma (bf16, H 64 or 128; DeepSeek-V2's decode): built for Hopper.
//   - A CTA takes 64 query heads (wgmma's M).  Its 64 rows of [q_c |
//     q_rope] (73,728 bytes) and 64-position tiles of [c_kv | k_rope]
//     come into shared memory by TMA, each as 9 boxes of 64 columns with
//     the 128-byte swizzle wgmma reads, through a two-stage ring of
//     mbarriers (full: the bytes landed; empty: the consumers are done).
//     One thread of a producer warpgroup issues the loads; two consumer
//     warpgroups compute, with setmaxnreg moving registers to them.
//   - Warpgroup 0 computes a tile's scores S = Q . K^T by 36 wgmma
//     m64n64k16 (K-major operands), masks, and writes its exp2
//     probabilities into a 64 x 64 P tile in bf16 (the row sums take the
//     f32 values) with each row's rescale; warpgroup 1 takes them through
//     shared memory (two named barriers).  Each warpgroup then adds P . V
//     to its 256 output columns by 4 wgmma m64n256k16, V being columns
//     256 w .. 256 w + 255 of the SAME tile read MN-major: a latent row
//     leaves memory once for both products.  O (64 x 256 f32 a
//     warpgroup) stays in registers, 128 of the 232 a consumer thread
//     has.  (Splitting the scores by positions, m64n32 in each warpgroup,
//     reads Q from shared memory twice and was slower.)
//   - At H 128 each of the two CTAs of a share loads every box itself,
//     the second read of a row hitting L2.  (A cluster of the two, each
//     multicasting half of a tile's boxes to both, timed within 3% of
//     this at DeepSeek-V2's pool and slower at most share counts, so it
//     was dropped.)
//   - Work split by visible rows, on the device: the grid is fixed by
//     (S, H, C) -- G shares x H / 64 CTAs, G >= S -- so a step stays
//     capturable.  Every CTA's producer warp reads lens and finds its
//     share (share_cap, find_share below), at least F tiles of a slot
//     (the launch's least share; kernels/mla_decode.py says why): a
//     share never crosses a slot,
//     so a CTA loads Q once and ends with one epilogue.  A slot of one
//     share is written to out directly; the shares of a longer slot each
//     write an f32 piece (m, l, acc).  The combine pass derives the same
//     pieces from lens and merges them in share order, so the result is
//     bit for bit run to run.  kernels/mla_decode.py share_plan is this
//     arithmetic in Python.  (Equal shares of the whole (slot, tile)
//     sequence, crossing slots, cost the CTAs that crossed a second Q
//     load and a second piece store, and were slower.)  The pieces are
//     what costs most beyond the tiles: at that pool 54 of them, 14.2 MB
//     written and read back by the combine pass.
//   - Rows past lens inside a box still hold old pool data: their scores
//     are masked to -inf (their P is 0); rows past C read as zeros.
// * mma (bf16, H 16 .. 48; the first design, kept for those head counts):
//   - Split pass: one block per (chunk of the pool, group of 16 heads,
//     slot).  The wrapper cuts C into n_split chunks of split_len
//     positions (whole tiles of 32; the last chunk takes the ragged tail)
//     for about two blocks per SM (kernels/mla_decode.py, split_plan).  A
//     block walks its chunk's visible tiles only (up to lens[s]); a chunk
//     past lens[s] writes m = -inf, l = 0 and no acc.
//   - 4 warps, mma.sync m16n8k16 through mma.cuh: the block's 16 query
//     rows [q_c | q_rope] are staged once in shared memory, 576 wide and
//     swizzled; 32-position tiles of [c_kv | k_rope] come through a
//     two-stage cp.async ring (zero past the visible range), 36 KB each.
//     Warp w computes the scores of positions 8w .. 8w+7 of the tile over
//     all 576 values (A = Q by ldmatrix, B = the tile's rows), the row
//     maxima of the 4 warps meet in shared memory, each warp writes its
//     exp2 probabilities to a 16 x 32 P tile in bf16 (the row sums take
//     the f32 values), and then warp w multiplies P by columns 128w ..
//     128w+127 of the same tile's latent part (ldmatrix.trans).  O (16 x
//     128 a warp) stays in f32 registers.
// * fma (f32, for the f32 checks and oracles): the mma design's blocks
//   and tiles, staged in shared memory as f32 with padded rows; thread
//   (row h, lane j of 16) computes two scores and 32 output columns on the
//   CUDA cores.
// * Their combine pass (n_split > 1): one block per (head, slot) merges
//   the chunks' f32 (m, l, acc): m* = max m_i, out = sum acc_i e^(m_i -
//   m*) / max(sum l_i e^(m_i - m*), 1e-30), empty chunks skipped.  With
//   one chunk the split pass writes the output itself.
//
// P is rounded to bf16 for its product in both bf16 designs, as flash
// does; the plain version keeps it in f32 (the reference rounds the
// normalised alpha to bf16 instead).  Both passes launch from
// mla_decode_launch; it allocates nothing (the wrapper passes the
// scratch) and returns cudaGetLastError().  All inputs must be contiguous
// and 16-byte aligned (the wrapper checks); the wgmma design encodes its
// four tensor maps on every call (a CUDA graph keeps them by value).
#include "hopper.cuh"
#include "mma.cuh"

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

using namespace repro;
using bf16 = __nv_bfloat16;

constexpr int KVR = 512;                              // latent width (kv_lora_rank)
constexpr int RD = 64;                                // rope key width
constexpr int DK = KVR + RD;                          // score width
constexpr int HG = 16;                                // query heads a block
constexpr int BK = 32;                                // positions a tile
constexpr int NS = 2;                                 // the cp.async ring (bf16)
constexpr int kWarps = 4;                             // bf16 block: 4 warps
constexpr int kFmaThreads = 256;                      // f32 block

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the chunk [c_beg, c_end) of slot s that block (split, ., s) walks:
// positions below the chunk's end and at or below lens[s]
struct Chunk {
  int beg, end;
};
__device__ __forceinline__ Chunk chunk_of(const int* lens, int s, int C, int split,
                                          int n_split, int split_len) {
  const int n_vis = max(0, min(lens[s] + 1, C));
  const int beg = split * split_len;
  const int end = min(split == n_split - 1 ? C : beg + split_len, n_vis);
  return {beg, end};
}

// the block's partial results: acc (S, H, n_split, KVR) then (m, l) (S, H,
// n_split, 2), so every acc record is 16-byte aligned
__device__ __forceinline__ size_t rec(int s, int H, int h, int n_split, int split) {
  return (static_cast<size_t>(s) * H + h) * n_split + split;
}

// ---------------------------------------------------------------- bf16 path
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (NS * BK * DK + HG * DK + HG * BK) + sizeof(float) * 2 * kWarps * HG;
}

__global__ void __launch_bounds__(32 * kWarps)
mla_mma_kernel(const bf16* __restrict__ q_c, const bf16* __restrict__ q_rope,
               const bf16* __restrict__ c_kv, const bf16* __restrict__ k_rope,
               const int* __restrict__ lens, bf16* __restrict__ out, float* __restrict__ part,
               int C, int H, int split_len, float scale) {
  constexpr int CH = DK / 8;                          // 16-byte chunks a row
  constexpr int CL = KVR / 8;                         // ... of them latent
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);       // [NS][BK][DK], swizzled
  bf16* sQ = sK + NS * BK * DK;                       // [HG][DK], swizzled
  bf16* sP = sQ + HG * DK;                            // [HG][BK], swizzled
  float* sMax = reinterpret_cast<float*>(sP + HG * BK);  // [kWarps][HG]
  float* sSum = sMax + kWarps * HG;                   // [kWarps][HG]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4;
  const int split = blockIdx.x, n_split = gridDim.x, h0 = blockIdx.y * HG, s = blockIdx.z;
  const Chunk ck = chunk_of(lens, s, C, split, n_split, split_len);
  const int ntiles = ck.end > ck.beg ? (ck.end - ck.beg + BK - 1) / BK : 0;
  const float scale_log2 = scale * 1.4426950408889634f;

  auto load_tile = [&](int t) {
    bf16* dst = sK + (t % NS) * BK * DK;
    const int k0 = ck.beg + t * BK;
    for (int i = tid; i < BK * CH; i += 32 * kWarps) {
      const int r = i / CH, c = i % CH, key = k0 + r;
      const bool ok = key < ck.end;
      const size_t row = static_cast<size_t>(s) * C + (ok ? key : ck.beg);
      const bf16* src = c < CL ? c_kv + row * KVR + c * 8 : k_rope + row * RD + (c - CL) * 8;
      cp_async16(dst + swz<DK>(r, c), src, ok);
    }
  };
  if (ntiles > 0) {
    for (int i = tid; i < HG * CH; i += 32 * kWarps) {
      const int r = i / CH, c = i % CH;
      const size_t row = static_cast<size_t>(s) * H + h0 + r;
      cp_async16(sQ + swz<DK>(r, c),
                 c < CL ? q_c + row * KVR + c * 8 : q_rope + row * RD + (c - CL) * 8, true);
    }
    load_tile(0);
  }
  cp_async_commit();

  float o[16][4];                                     // 16 x 128 columns of this warp
#pragma unroll
  for (int n = 0; n < 16; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows gr, gr + 8

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_tile(t + 1);
    cp_async_commit();
    cp_async_wait<1>();                               // tile t (and Q) have landed
    __syncthreads();
    const bf16* Ks = sK + (t % NS) * BK * DK;
    const int k0 = ck.beg + t * BK;

    // scores of positions 8 warp .. 8 warp + 7 over all 576 values
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 6
    for (int p = 0; p < DK / 32; ++p) {               // 32 values each
      uint32_t qa[2][4], kb[4];
      ldsm_x4(qa[0], sQ + swz<DK>(lane & 15, 4 * p + (lane >> 4)));
      ldsm_x4(qa[1], sQ + swz<DK>(lane & 15, 4 * p + 2 + (lane >> 4)));
      ldsm_x4(kb, Ks + swz<DK>(8 * warp + (lane & 7), 4 * p + (lane >> 3)));
      mma_bf16(sc, qa[0], kb[0], kb[1]);
      mma_bf16(sc, qa[1], kb[2], kb[3]);
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (k0 + 8 * warp + 2 * tq + (e & 1) >= ck.end) sc[e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[e]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = group_max<4>(mx[i]);
      if (tq == 0) sMax[warp * HG + gr + 8 * i] = mx[i];
    }
    __syncthreads();
    float base[2], corr[2];                           // m kept in raw-score units
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float m_new = m[i];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) m_new = fmaxf(m_new, sMax[w * HG + gr + 8 * i]);
      base[i] = m_new == -INFINITY ? 0.f : m_new * scale_log2;
      corr[i] = fast_exp2(fmaf(m[i], scale_log2, -base[i]));
      m[i] = m_new;
    }
    const float p0 = fast_exp2(fmaf(sc[0], scale_log2, -base[0]));
    const float p1 = fast_exp2(fmaf(sc[1], scale_log2, -base[0]));
    const float p2 = fast_exp2(fmaf(sc[2], scale_log2, -base[1]));
    const float p3 = fast_exp2(fmaf(sc[3], scale_log2, -base[1]));
    *reinterpret_cast<uint32_t*>(sP + swz<BK>(gr, warp) + 2 * tq) = pack_bf16(p0, p1);
    *reinterpret_cast<uint32_t*>(sP + swz<BK>(gr + 8, warp) + 2 * tq) = pack_bf16(p2, p3);
    const float rs[2] = {group_sum<4>(p0 + p1), group_sum<4>(p2 + p3)};
    if (tq == 0) {
      sSum[warp * HG + gr] = rs[0];
      sSum[warp * HG + gr + 8] = rs[1];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += sSum[w * HG + gr + 8 * i];
      l[i] = l[i] * corr[i] + sum;
    }
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
    // P (16 x 32) . the tile's latent columns 128 warp .. 128 warp + 127
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t pa[4];
      ldsm_x4(pa, sP + swz<BK>(lane & 15, 2 * kc + (lane >> 4)));
      const int r = 16 * kc + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int n2 = 0; n2 < 8; ++n2) {                // 16 columns each
        uint32_t vb[4];
        ldsm_x4_trans(vb, Ks + swz<DK>(r, 16 * warp + 2 * n2 + (lane >> 4)));
        mma_bf16(o[2 * n2], pa, vb[0], vb[1]);
        mma_bf16(o[2 * n2 + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();                                  // the stage, P and the maxima are free
  }
  cp_async_wait<0>();                                 // no copy outlives the block

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int h = h0 + gr + 8 * i;
    const int col = 128 * warp + 2 * tq;
    if (part == nullptr) {                            // one chunk: the output itself
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      bf16* dst = out + (static_cast<size_t>(s) * H + h) * KVR + col;
#pragma unroll
      for (int n = 0; n < 16; ++n)
        *reinterpret_cast<uint32_t*>(dst + 8 * n) =
            pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    } else {
      const size_t r = rec(s, H, h, gridDim.x, split);
      float* acc = part + r * KVR + col;
      if (ntiles > 0)                                 // the combine skips an empty chunk
#pragma unroll
        for (int n = 0; n < 16; ++n)
          *reinterpret_cast<float2*>(acc + 8 * n) = make_float2(o[n][2 * i], o[n][2 * i + 1]);
      if (warp == 0 && tq == 0) {
        float* ml = part + static_cast<size_t>(gridDim.z) * H * gridDim.x * KVR + 2 * r;
        ml[0] = m[i] == -INFINITY ? -INFINITY : m[i] * scale;   // natural units
        ml[1] = l[i];
      }
    }
  }
}

// ----------------------------------------------------------------- f32 path
constexpr int DKP = DK + 1;                           // padded shared rows
constexpr int CPT = KVR / 16;                         // output columns a thread

constexpr size_t fma_smem_bytes() {
  return sizeof(float) * (HG * DKP + BK * DKP + HG * (BK + 1));
}

__global__ void __launch_bounds__(kFmaThreads)
mla_fma_kernel(const float* __restrict__ q_c, const float* __restrict__ q_rope,
               const float* __restrict__ c_kv, const float* __restrict__ k_rope,
               const int* __restrict__ lens, float* __restrict__ out, float* __restrict__ part,
               int C, int H, int split_len, float scale) {
  constexpr int V4 = DK / 4;                          // 16-byte loads a row
  constexpr int VL = KVR / 4;                         // ... of them latent
  extern __shared__ float smem[];
  float* sQ = smem;                                   // [HG][DKP]
  float* sK = sQ + HG * DKP;                          // [BK][DKP]
  float* sP = sK + BK * DKP;                          // [HG][BK + 1]
  const int tid = threadIdx.x, hr = tid / 16, j = tid % 16;   // row, lane of the row
  const int split = blockIdx.x, n_split = gridDim.x, h0 = blockIdx.y * HG, s = blockIdx.z;
  const Chunk ck = chunk_of(lens, s, C, split, n_split, split_len);
  const int ntiles = ck.end > ck.beg ? (ck.end - ck.beg + BK - 1) / BK : 0;

  auto row4 = [&](const float* lat, const float* rope, size_t row, int c) {
    return c < VL ? *reinterpret_cast<const float4*>(lat + row * KVR + 4 * c)
                  : *reinterpret_cast<const float4*>(rope + row * RD + 4 * (c - VL));
  };
  auto put4 = [](float* dst, float4 x) {
    dst[0] = x.x;
    dst[1] = x.y;
    dst[2] = x.z;
    dst[3] = x.w;
  };
  if (ntiles > 0)
    for (int i = tid; i < HG * V4; i += kFmaThreads)
      put4(sQ + i / V4 * DKP + 4 * (i % V4),
           row4(q_c, q_rope, static_cast<size_t>(s) * H + h0 + i / V4, i % V4));

  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f;                       // natural units of scaled scores

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = ck.beg + t * BK;
    __syncthreads();                                  // the last tile's reads are done
    for (int i = tid; i < BK * V4; i += kFmaThreads) {
      const int r = i / V4, c = i % V4, key = k0 + r;
      const float4 x = key < ck.end ? row4(c_kv, k_rope, static_cast<size_t>(s) * C + key, c)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
      put4(sK + r * DKP + 4 * c, x);
    }
    __syncthreads();
    float sc[2] = {0.f, 0.f};                         // positions j and j + 16
#pragma unroll 8
    for (int d = 0; d < DK; ++d) {
      const float qv = sQ[hr * DKP + d];
      sc[0] = fmaf(qv, sK[j * DKP + d], sc[0]);
      sc[1] = fmaf(qv, sK[(j + 16) * DKP + d], sc[1]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[e] = k0 + j + 16 * e < ck.end ? sc[e] * scale : -INFINITY;
      mx = fmaxf(mx, sc[e]);
    }
    const float m_new = fmaxf(m, group_max<16>(mx));
    const float base = m_new == -INFINITY ? 0.f : m_new;
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float p = expf(sc[e] - base);
      sP[hr * (BK + 1) + j + 16 * e] = p;
      sum += p;
    }
    const float corr = expf(m - base);
    l = l * corr + group_sum<16>(sum);
    m = m_new;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[c] *= corr;
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float p = sP[hr * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] = fmaf(p, sK[kk * DKP + j + 16 * c], acc[c]);
    }
  }

  const int h = h0 + hr;
  if (part == nullptr) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* dst = out + (static_cast<size_t>(s) * H + h) * KVR;
#pragma unroll
    for (int c = 0; c < CPT; ++c) dst[j + 16 * c] = acc[c] * inv;
  } else {
    const size_t r = rec(s, H, h, n_split, split);
    if (ntiles > 0)                                   // the combine skips an empty chunk
#pragma unroll
      for (int c = 0; c < CPT; ++c) part[r * KVR + j + 16 * c] = acc[c];
    if (j == 0) {
      float* ml = part + static_cast<size_t>(gridDim.z) * H * n_split * KVR + 2 * r;
      ml[0] = m;
      ml[1] = l;
    }
  }
}

// ------------------------------------------------------------ combine pass
template <typename T>
__global__ void __launch_bounds__(KVR / 4)
mla_combine_kernel(const float* __restrict__ part, T* __restrict__ out, int n_split) {
  const int h = blockIdx.x, H = gridDim.x, s = blockIdx.y, S = gridDim.y;
  const int col = 4 * threadIdx.x;
  const float* ml = part + static_cast<size_t>(S) * H * n_split * KVR;
  const size_t r0 = rec(s, H, h, n_split, 0);
  float mstar = -INFINITY;
  for (int i = 0; i < n_split; ++i) mstar = fmaxf(mstar, ml[2 * (r0 + i)]);
  float lsum = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < n_split; ++i) {
    const float mi = ml[2 * (r0 + i)];
    if (mi == -INFINITY) continue;                    // a chunk with nothing visible
    const float w = expf(mi - mstar);
    lsum += w * ml[2 * (r0 + i) + 1];
    const float4 a = *reinterpret_cast<const float4*>(part + (r0 + i) * KVR + col);
    acc[0] += w * a.x;
    acc[1] += w * a.y;
    acc[2] += w * a.z;
    acc[3] += w * a.w;
  }
  const float inv = 1.f / fmaxf(lsum, 1e-30f);
  T* dst = out + (static_cast<size_t>(s) * H + h) * KVR + col;
#pragma unroll
  for (int e = 0; e < 4; ++e) dst[e] = from_f<T>(acc[e] * inv);
}

// ------------------------------------------------------ wgmma path (bf16)
constexpr int WBN = 64;                               // positions a tile
constexpr int WBOX = 64;                              // columns a TMA box: 128 bytes
constexpr int NBOX = DK / WBOX;                       // 9 boxes a row: 8 of c_kv, 1 of k_rope
constexpr int WHEADS = 64;                            // query heads a CTA (wgmma's M)
constexpr int WSTAGES = 2;                            // the TMA ring
constexpr uint32_t BOX_BYTES = WBN * WBOX * 2;        // 8,192 (a Q box: 64 heads x 64)
constexpr uint32_t TILE_BYTES = NBOX * BOX_BYTES;     // 73,728 (Q's too)
constexpr int kConsumers = 256;                       // two consumer warpgroups
constexpr int kWgThreads = kConsumers + 128;          // and the producer warpgroup
// registers a thread: 384 threads launch at 168 (65,536 / 384); the
// producer warpgroup gives 128 of them to each consumer thread, whose O
// alone takes 128
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kProducerRegs + 2 * kConsumerRegs == 3 * 168, "the CTA's registers");
// shared memory from a 1,024-byte-aligned base: Q, the ring, P, the rows'
// rescale, sum and max, the barriers, the share's plan
constexpr size_t OFF_K = TILE_BYTES;
constexpr size_t OFF_P = OFF_K + WSTAGES * TILE_BYTES;
constexpr size_t OFF_ROW = OFF_P + WHEADS * WBN * 2;
constexpr size_t OFF_BAR = OFF_ROW + 3 * WHEADS * sizeof(float);
constexpr size_t OFF_PLAN = OFF_BAR + sizeof(uint64_t) * (2 * WSTAGES + 1);
constexpr size_t wg_smem_bytes() { return OFF_PLAN + 8 * sizeof(int) + 1024; }
static_assert(wg_smem_bytes() <= 232448, "one CTA a SM");
constexpr int kMaxShares = 1024;                      // G at most (so S too)
static_assert(WHEADS * WBN * 2 >= kMaxShares * sizeof(int), "the P tile holds the slots' rows");

// The work split.  Slot s shows visible_rows (c <= lens[s], at most C)
// in n_s = slot_tiles tiles, at least 1.  A share never crosses a slot:
// slot s is cut into k_s = ceil(n_s / B) shares of floor or ceil(n_s /
// k_s) tiles, B the least cap of at least F for which the shares of all
// slots number at most G (the launch takes G >= S, so B = max n_s always
// fits; a larger cap only cuts fewer shares).  Shares
// are numbered slot after slot; the CTAs past the last one have none.  A
// slot of one share writes out; the k_s shares of another each write a
// piece, numbered slot after slot: at most G pieces.
__device__ __forceinline__ int visible_rows(const int* lens, int s, int C) {
  const int l = lens[s];
  return l < 0 ? 0 : (l >= C ? C : l + 1);
}
__device__ __forceinline__ int slot_tiles(int n_vis) { return max(1, (n_vis + WBN - 1) / WBN); }
// the slots' visible rows into shared memory, threads t, t + n, ...: the
// passes below then read lens from shared memory, not L2 each time
__device__ __forceinline__ void stage_visible(const int* lens, int S, int C, int* nv, int t,
                                              int n) {
  for (int s = t; s < S; s += n) nv[s] = visible_rows(lens, s, C);
}

__device__ __forceinline__ int warp_sum_int(int x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ int warp_max_int(int x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ int warp_scan_int(int x, int lane) {   // inclusive
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// one warp, every lane: the cap B.  One pass gives T = sum n_s and max
// n_s; B lies in [max(F, ceil(T / G)), ceil(T / (G - S))] (the upper end
// fits: sum ceil(n_s / B) <= T / B + S) or, when G == S, at max n_s; a
// binary search takes the least that fits (one step at DeepSeek-V2's pool)
__device__ int share_cap(const int* nv, int S, int G, int F, int lane) {
  int T = 0, most = 1;
  for (int c0 = 0; c0 < S; c0 += 32) {
    const int n = c0 + lane < S ? slot_tiles(nv[c0 + lane]) : 0;
    T += warp_sum_int(n);
    most = max(most, warp_max_int(n));
  }
  int lo = max(F, (T + G - 1) / G);
  int hi = max(lo, G > S ? min(most, (T + G - S - 1) / (G - S)) : most);
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    int shares = 0;
    for (int c0 = 0; c0 < S; c0 += 32) {
      const int n = c0 + lane < S ? slot_tiles(nv[c0 + lane]) : 0;
      shares += warp_sum_int((n + mid - 1) / mid);
    }
    if (shares <= G)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// a share: tiles [a, b) of `slot` (n_vis visible rows), and its piece (-1
// when the slot is one share); slot -1 for a CTA with none
struct Share {
  int slot, a, b, piece, n_vis;
};

// one warp, every lane: share g, by a scan over the slots 32 at a time
// (nv_s: the slots' visible rows in shared memory)
__device__ Share find_share(const int* nv_s, int S, int B, int g, int lane) {
  int carry_k = 0, carry_p = 0;
  for (int c0 = 0; c0 < S; c0 += 32) {
    const int s = c0 + lane;
    const int nv = s < S ? nv_s[s] : 0;
    const int n = s < S ? slot_tiles(nv) : 0;
    const int k = (n + B - 1) / B;                    // the slot's shares (0 past S)
    const int np = k > 1 ? k : 0;                     // ... and pieces
    const int incl_k = warp_scan_int(k, lane), incl_p = warp_scan_int(np, lane);
    const int first_k = carry_k + incl_k - k, base = carry_p + incl_p - np;
    const bool hit = s < S && first_k <= g && g < first_k + k;
    const unsigned found = __ballot_sync(0xffffffffu, hit);
    if (found) {
      const int src = __ffs(found) - 1;
      const int sk = __shfl_sync(0xffffffffu, k, src), sn = __shfl_sync(0xffffffffu, n, src);
      const int j = g - __shfl_sync(0xffffffffu, first_k, src);
      const int sb = __shfl_sync(0xffffffffu, base, src);
      return {c0 + src, static_cast<int>(static_cast<long long>(j) * sn / sk),
              static_cast<int>(static_cast<long long>(j + 1) * sn / sk), sk > 1 ? sb + j : -1,
              __shfl_sync(0xffffffffu, nv, src)};
    }
    carry_k += __shfl_sync(0xffffffffu, incl_k, 31);
    carry_p += __shfl_sync(0xffffffffu, incl_p, 31);
  }
  return {-1, 0, 0, -1, 0};
}

// CTA (share g, head group hg): blockIdx.x = g * (H / 64) + hg
__global__ void __launch_bounds__(kWgThreads, 1)
mla_wgmma_kernel(const __grid_constant__ CUtensorMap tm_qc, const __grid_constant__ CUtensorMap tm_qr,
                 const __grid_constant__ CUtensorMap tm_ckv,
                 const __grid_constant__ CUtensorMap tm_kr, const int* __restrict__ lens,
                 bf16* __restrict__ out, float* __restrict__ part, int S, int C, int H, int G,
                 int F, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (sm90::shared_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = sm;                             // [9 boxes][64 heads][64], swizzled
  unsigned char* sK = sm + OFF_K;                     // [stage][9 boxes][64 positions][64]
  unsigned char* sP = sm + OFF_P;                     // [64 heads][64 positions] bf16, swizzled
  float* sCorr = reinterpret_cast<float*>(sm + OFF_ROW);  // [64 heads]: this tile's rescale
  float* sL = sCorr + WHEADS;                         // [64 heads]: l and m after this tile
  float* sM = sL + WHEADS;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + OFF_BAR);   // the stage's bytes landed
  uint64_t* empty = full + WSTAGES;                  // both consumer warpgroups are done
  uint64_t* q_full = empty + WSTAGES;
  int* plan = reinterpret_cast<int*>(sm + OFF_PLAN);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int groups = H / WHEADS, hg = blockIdx.x % groups, g = blockIdx.x / groups;
  constexpr int kProducer = kConsumers / 32;          // warp 8 plans and loads

  if (tid == 0) {
    for (int j = 0; j < WSTAGES; ++j) {
      sm90::mbar_init(&full[j], 1);
      sm90::mbar_init(&empty[j], 2);                  // each consumer warpgroup
    }
    sm90::mbar_init(q_full, 1);
    sm90::fence_barrier_init();
  }
  if (warp == kProducer) {                            // plan the share
    if (lane == 0) {
      sm90::prefetch_tensor_map(&tm_qc);
      sm90::prefetch_tensor_map(&tm_qr);
      sm90::prefetch_tensor_map(&tm_ckv);
      sm90::prefetch_tensor_map(&tm_kr);
    }
    int* nv = reinterpret_cast<int*>(sP);             // the P tile: free until the first scores
    stage_visible(lens, S, C, nv, lane, 32);
    __syncwarp();
    const Share sh = find_share(nv, S, share_cap(nv, S, G, F, lane), g, lane);
    if (lane == 0) {
      plan[0] = sh.slot;
      plan[1] = sh.a;
      plan[2] = sh.b;
      plan[3] = sh.piece;
      plan[4] = sh.n_vis;
    }
  }
  __syncthreads();
  // this CTA's tiles [t0, t1) of slot `slot`: Q loaded once, one epilogue
  const int slot = plan[0], t0 = plan[1], t1 = plan[2], piece = plan[3], n_vis = plan[4];

  if (warp >= kProducer) {
    // ------------------------------------------------------------ producer
    sm90::reg_dealloc<kProducerRegs>();
    if (warp == kProducer && lane == 0) {
      int stage = 0;
      uint32_t ph = 0;
      if (t0 < t1) {                                  // the slot's 64 query rows
        sm90::mbar_expect_tx(q_full, TILE_BYTES);
        const int row = slot * H + hg * WHEADS;
        for (int i = 0; i < NBOX - 1; ++i)
          sm90::tma_load_2d(sQ + i * BOX_BYTES, &tm_qc, q_full, i * WBOX, row);
        sm90::tma_load_2d(sQ + (NBOX - 1) * BOX_BYTES, &tm_qr, q_full, 0, row);
      }
      for (int t = t0; t < t1; ++t) {
        // the second tile goes out once the first has landed: at the start
        // every CTA's Q and first tiles come from HBM at once, and the
        // first tile lands sooner without the second beside it
        if (t == t0 + 1) sm90::mbar_wait(&full[0], 0);
        sm90::mbar_wait(&empty[stage], ph ^ 1);
        sm90::mbar_expect_tx(&full[stage], TILE_BYTES);
        unsigned char* dst = sK + stage * TILE_BYTES;
        const int pos = t * WBN;
        for (int i = 0; i < NBOX; ++i)
          sm90::tma_load_3d(dst + i * BOX_BYTES, i < NBOX - 1 ? &tm_ckv : &tm_kr, &full[stage],
                            i < NBOX - 1 ? i * WBOX : 0, pos, slot);
        if (++stage == WSTAGES) {
          stage = 0;
          ph ^= 1;
        }
      }
    }
    sm90::launch_dependents();
  } else {
    // ----------------------------------------------------------- consumers
    // Warpgroup 0 computes a tile's scores and softmax and hands P and the
    // rows' rescale to warpgroup 1 through shared memory (named barrier 1:
    // P is ready; 2: warpgroup 1 is done reading it); each then adds P . V
    // to its 256 output columns.  One warpgroup's m64n64 products read Q
    // once for all 64 positions; two warpgroups' m64n32 products read it
    // twice.
    sm90::reg_alloc<kConsumerRegs>();
    const int wg = warp / 4, wt = tid % 128;
    const int q4 = lane % 4, r0 = (warp % 4) * 16 + lane / 4;   // rows r0 and r0 + 8
    const float scale_log2 = scale * 1.4426950408889634f;
    float o[128];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // warpgroup 0's running stats
    int stage = 0;
    uint32_t ph = 0;
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] = 0.f;
    if (wg == 1) sm90::named_barrier_arrive(2, kConsumers);    // P starts free
    if (wg == 0 && t0 < t1) sm90::mbar_wait(q_full, 0);
    for (int t = t0; t < t1; ++t) {
      sm90::mbar_wait(&full[stage], ph);
      const unsigned char* tile = sK + stage * TILE_BYTES;
      float corr[2];
      if (wg == 0) {
        // scores of the tile's 64 positions over the 576 values
        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.f;
        sm90::fence_regs(sc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk) {
          const int off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
          sm90::wgmma_m64n64k16<0>(sc, sm90::sw128_desc(sQ + off, 16, 1024),
                                   sm90::sw128_desc(tile + off, 16, 1024), kk > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sc);

        const int pos0 = t * WBN + 2 * q4;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (pos0 + 8 * j + (e & 1) >= n_vis) sc[4 * j + e] = -INFINITY;
            mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
          }
        float base[2];                                // m kept in raw-score units
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float m_new = fmaxf(m[i], group_max<4>(mx[i]));
          base[i] = m_new == -INFINITY ? 0.f : m_new * scale_log2;
          corr[i] = fast_exp2(fmaf(m[i], scale_log2, -base[i]));
          m[i] = m_new;
        }
        sm90::named_barrier(2, kConsumers);           // warpgroup 1 is done with the last P
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float p0 = fast_exp2(fmaf(sc[4 * j + 2 * i], scale_log2, -base[i]));
            const float p1 = fast_exp2(fmaf(sc[4 * j + 2 * i + 1], scale_log2, -base[i]));
            rs[i] += p0 + p1;
            const int r = r0 + 8 * i;
            *reinterpret_cast<uint32_t*>(sP + r * 128 + ((j ^ (r & 7)) << 4) + q4 * 4) =
                pack_bf16(p0, p1);
          }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          l[i] = l[i] * corr[i] + group_sum<4>(rs[i]);
          if (q4 == 0) {
            sCorr[r0 + 8 * i] = corr[i];
            sL[r0 + 8 * i] = l[i];
            sM[r0 + 8 * i] = m[i];
          }
        }
        sm90::fence_proxy_async();                    // P is read by wgmma
        sm90::named_barrier_arrive(1, kConsumers);    // P and the rescale are ready
      } else {
        sm90::named_barrier(1, kConsumers);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          corr[i] = sCorr[r0 + 8 * i];
          l[i] = sL[r0 + 8 * i];
          m[i] = sM[r0 + 8 * i];
        }
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }

      // O += P (64 x 64) . columns 256 wg .. 256 wg + 255 of the tile's latent part
      sm90::fence_regs(o);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WBN / 16; ++kk)
        sm90::wgmma_m64n256k16<1>(
            o, sm90::sw128_desc(sP + kk * 32, 16, 1024),
            sm90::sw128_desc(tile + 4 * wg * BOX_BYTES + kk * 16 * 128, BOX_BYTES, 1024), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      if (wg == 1) sm90::named_barrier_arrive(2, kConsumers);  // P is free
      if (wt == 0) sm90::mbar_arrive(&empty[stage]);   // the stage is free
      if (++stage == WSTAGES) {
        stage = 0;
        ph ^= 1;
      }
    }
    if (t0 < t1) {                                    // the share's epilogue
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int h = hg * WHEADS + r0 + 8 * i;
        const int col = 256 * wg + 2 * q4;
        if (piece < 0) {                            // the whole slot: out itself
          const float inv = 1.f / fmaxf(l[i], 1e-30f);
          bf16* dst = out + (static_cast<size_t>(slot) * H + h) * KVR + col;
#pragma unroll
          for (int j = 0; j < 32; ++j)
            *reinterpret_cast<uint32_t*>(dst + 8 * j) =
                pack_bf16(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
        } else {
          const size_t r = static_cast<size_t>(piece) * H + h;
          float* acc = part + r * KVR + col;
#pragma unroll
          for (int j = 0; j < 32; ++j)
            *reinterpret_cast<float2*>(acc + 8 * j) =
                make_float2(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
          if (wg == 0 && q4 == 0) {
            float* ml = part + static_cast<size_t>(G) * H * KVR + 2 * r;
            ml[0] = m[i] == -INFINITY ? -INFINITY : m[i] * scale;   // natural units
            ml[1] = l[i];
          }
        }
      }
    }
    // the combine pass may start its own prologue (programmatic dependent
    // launch); it waits for this grid's memory before reading any piece
    sm90::launch_dependents();
  }
}

// Merges the pieces of each slot that more than one share walked, in
// share order, a (head, slot) at a time; a slot of one share was written
// by the split pass.  One wave of blocks (kCombineBlocks) strides over the
// H x S (head, slot) items: each block first derives every slot's pieces
// from lens (share_cap, then a scan), so items of slots without pieces
// cost a shared-memory read, not a block.  Per item the pieces' (m, l,
// acc) are loaded sixteen at a time (every piece of most slots at
// DeepSeek-V2's pool), so the loads are in flight together rather than
// one chain of round trips, and merged into a running max, sum and
// accumulator (out = sum acc_i e^(m_i - m*) / sum l_i e^(m_i - m*), m* the
// max, each batch rescaled to the new max).  Launched as a
// programmatic dependent of the split pass: the derivation runs while the
// split pass ends.  Every block waits for the split pass before it ends,
// one with nothing to merge too: the grid's completion is what the next
// kernel in the stream waits for, and out is the split pass's.
constexpr int kBatch = 16;
constexpr int kCombineBlocks = 4 * 132;               // 4 a SM (123 registers a thread)
__global__ void __launch_bounds__(KVR / 4)
mla_piece_combine_kernel(const int* __restrict__ lens, const float* __restrict__ part,
                         bf16* __restrict__ out, int S, int C, int H, int G, int F) {
  const int tid = threadIdx.x;
  __shared__ int np_s[kMaxShares];                    // visible rows, then pieces, a slot
  __shared__ int base_s[kMaxShares];                  // a slot's first piece
  stage_visible(lens, S, C, np_s, tid, blockDim.x);
  __syncthreads();
  if (tid < 32) {
    const int B = share_cap(np_s, S, G, F, tid);
    int carry = 0;
    for (int c0 = 0; c0 < S; c0 += 32) {
      const int sl = c0 + tid;
      const int k = sl < S ? (slot_tiles(np_s[sl]) + B - 1) / B : 0;
      const int np = k > 1 ? k : 0;
      const int incl = warp_scan_int(np, tid);
      if (sl < S) {
        np_s[sl] = np;
        base_s[sl] = carry + incl - np;
      }
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
  __syncthreads();
  sm90::wait_prerequisite_grid();                     // the split pass's pieces and out
  const float* ml = part + static_cast<size_t>(G) * H * KVR;
  const int col = 4 * tid;
  for (int item = blockIdx.x; item < H * S; item += gridDim.x) {
    const int s = item / H, h = item % H, np = np_s[s], base = base_s[s];
    if (np == 0) continue;                            // block-uniform
    // sixteen pieces' (m, l, acc) loaded at once, merged into a running
    // max, sum and accumulator in piece order
    float mstar = -INFINITY, lsum = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i0 = 0; i0 < np; i0 += kBatch) {
      float4 a[kBatch];
      float mi[kBatch], li[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const bool live = i0 + u < np;
        const size_t r = static_cast<size_t>(base + i0 + u) * H + h;
        mi[u] = live ? ml[2 * r] : -INFINITY;
        li[u] = live ? ml[2 * r + 1] : 0.f;
        a[u] = live ? *reinterpret_cast<const float4*>(part + r * KVR + col)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float mb = mstar;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) mb = fmaxf(mb, mi[u]);
      if (mb == -INFINITY) continue;                  // nothing visible yet
      const float keep = mstar == -INFINITY ? 0.f : expf(mstar - mb);
      lsum *= keep;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] *= keep;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (mi[u] == -INFINITY) continue;             // a piece with nothing visible, or none
        const float w = expf(mi[u] - mb);
        lsum += w * li[u];
        acc[0] += w * a[u].x;
        acc[1] += w * a[u].y;
        acc[2] += w * a[u].z;
        acc[3] += w * a[u].w;
      }
      mstar = mb;
    }
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    bf16* dst = out + (static_cast<size_t>(s) * H + h) * KVR + col;
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[e] = __float2bfloat16(acc[e] * inv);
  }
}

// raise a kernel's dynamic shared memory limit once
cudaError_t allow_smem(const void* kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  done = err == cudaSuccess;
  return err;
}

// the wgmma design's two passes: the four tensor maps, the split pass, the
// piece combine (none at G == S, where no slot is cut)
cudaError_t launch_wgmma(const void* q_c, const void* q_rope, const void* c_kv,
                         const void* k_rope, const void* lens, void* out, void* part, int S,
                         int C, int H, int G, int F, float scale, cudaStream_t st) {
  CUtensorMap maps[4];
  const cuuint64_t rows = static_cast<cuuint64_t>(S) * H;
  const cuuint64_t qc_dims[2] = {KVR, rows}, qc_strides[1] = {KVR * 2};
  const cuuint64_t qr_dims[2] = {RD, rows}, qr_strides[1] = {RD * 2};
  const cuuint64_t kv_dims[3] = {KVR, static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(S)};
  const cuuint64_t kv_strides[2] = {KVR * 2, static_cast<cuuint64_t>(C) * KVR * 2};
  const cuuint64_t kr_dims[3] = {RD, static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(S)};
  const cuuint64_t kr_strides[2] = {RD * 2, static_cast<cuuint64_t>(C) * RD * 2};
  const cuuint32_t q_box[2] = {WBOX, WHEADS}, kv_box[3] = {WBOX, WBN, 1};
  if (!encode_bf16_sw128(&maps[0], q_c, 2, qc_dims, qc_strides, q_box) ||
      !encode_bf16_sw128(&maps[1], q_rope, 2, qr_dims, qr_strides, q_box) ||
      !encode_bf16_sw128(&maps[2], c_kv, 3, kv_dims, kv_strides, kv_box) ||
      !encode_bf16_sw128(&maps[3], k_rope, 3, kr_dims, kr_strides, kv_box))
    return cudaErrorInvalidValue;
  static bool done = false;
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(mla_wgmma_kernel), wg_smem_bytes(), done);
  if (err != cudaSuccess) return err;
  const int* lens_p = static_cast<const int*>(lens);
  bf16* out_p = static_cast<bf16*>(out);
  float* part_p = static_cast<float*>(part);
  mla_wgmma_kernel<<<G * (H / WHEADS), kWgThreads, wg_smem_bytes(), st>>>(
      maps[0], maps[1], maps[2], maps[3], lens_p, out_p, part_p, S, C, H, G, F, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || G == S) return err;       // G == S: every slot is one share
  cudaLaunchConfig_t ccfg = {};
  ccfg.gridDim = dim3(std::min(H * S, kCombineBlocks));
  ccfg.blockDim = dim3(KVR / 4);
  ccfg.stream = st;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  ccfg.attrs = pdl;
  ccfg.numAttrs = 1;
  void* cargs[] = {&lens_p, &part_p, &out_p, &S, &C, &H, &G, &F};
  return cudaLaunchKernelExC(&ccfg, reinterpret_cast<const void*>(mla_piece_combine_kernel),
                             cargs);
}

}  // namespace

// The designs mla_decode_launch takes (kernels/mla_decode.py DESIGNS)
enum Design { kFma = 0, kMma = 1, kWgmma = 2 };

// Returns a cudaError_t: 0 when both passes were accepted, and
// cudaErrorInvalidValue for a design the shape does not fit.  kvr must be
// 512 and rd 64 (the only latent the kernels are built for).
//   fma (f32) and mma (bf16): H a multiple of 16 up to 128; part is the
//     f32 scratch of S x H x n_split x (kvr + 2) values when n_split > 1
//     (else unused); chunks are split_len positions (a multiple of 32),
//     the last one taking the ragged tail.
//   wgmma (bf16, H 64 or 128): n_split is the share count G (S .. 1,024),
//     split_len the least tiles of 64 positions a share takes (F >= 1);
//     part is the f32 scratch of G x H x (kvr + 2) values (the pieces'
//     acc, then their (m, l); at most G pieces), unused at G == S.
extern "C" int mla_decode_launch(const void* q_c, const void* q_rope, const void* c_kv,
                                 const void* k_rope, const void* lens, void* out, void* part,
                                 int S, int C, int H, int kvr, int rd, float scale, int design,
                                 int n_split, int split_len, void* stream) {
  if (kvr != KVR || rd != RD || S < 1 || S > 65535 || C < 1 || n_split < 1 || split_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design == kWgmma) {
    if ((part == nullptr && n_split > S) || n_split > kMaxShares || n_split < S ||
        (H != WHEADS && H != 2 * WHEADS))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_wgmma(q_c, q_rope, c_kv, k_rope, lens, out, part, S, C, H,
                                         n_split, split_len, scale, st));
  }
  if ((design != kFma && design != kMma) || H < HG || H > 128 || H % HG != 0 ||
      (n_split > 1 && (part == nullptr || split_len % BK != 0 ||
                       static_cast<long long>(n_split - 1) * split_len >= C)))
    return static_cast<int>(cudaErrorInvalidValue);
  float* scratch = n_split > 1 ? static_cast<float*>(part) : nullptr;
  const dim3 grid(n_split, H / HG, S);
  cudaError_t err;
  if (design == kMma) {
    static bool done = false;
    err = allow_smem(reinterpret_cast<const void*>(mla_mma_kernel), mma_smem_bytes(), done);
    if (err != cudaSuccess) return static_cast<int>(err);
    mla_mma_kernel<<<grid, 32 * kWarps, mma_smem_bytes(), st>>>(
        static_cast<const bf16*>(q_c), static_cast<const bf16*>(q_rope),
        static_cast<const bf16*>(c_kv), static_cast<const bf16*>(k_rope),
        static_cast<const int*>(lens), static_cast<bf16*>(out), scratch, C, H, split_len, scale);
  } else {
    static bool done = false;
    err = allow_smem(reinterpret_cast<const void*>(mla_fma_kernel), fma_smem_bytes(), done);
    if (err != cudaSuccess) return static_cast<int>(err);
    mla_fma_kernel<<<grid, kFmaThreads, fma_smem_bytes(), st>>>(
        static_cast<const float*>(q_c), static_cast<const float*>(q_rope),
        static_cast<const float*>(c_kv), static_cast<const float*>(k_rope),
        static_cast<const int*>(lens), static_cast<float*>(out), scratch, C, H, split_len, scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  if (design == kMma)
    mla_combine_kernel<bf16><<<dim3(H, S), KVR / 4, 0, st>>>(scratch, static_cast<bf16*>(out),
                                                             n_split);
  else
    mla_combine_kernel<float><<<dim3(H, S), KVR / 4, 0, st>>>(scratch, static_cast<float*>(out),
                                                              n_split);
  return static_cast<int>(cudaGetLastError());
}

// dynamic shared memory a block of `design` takes, bytes (0: no such design)
extern "C" int mla_decode_smem(int design) {
  return static_cast<int>(design == kWgmma ? wg_smem_bytes()
                          : design == kMma ? mma_smem_bytes()
                          : design == kFma ? fma_smem_bytes()
                                           : 0);
}
