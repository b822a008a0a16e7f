// Single-token decode attention over the packed serving KV pool, split
// along the pool (flash-decoding).
//
// Replaces: repro/kernels/decode_attention.py, decode_attention_pallas
// (`_decode_kernel`).
//
// q (S, H, dh), k / v (S, C, KV, dh), q_pos (S,) and kv_pos (S, C) int32;
// out (S, H, dh) in q's dtype (bf16 or f32).  Query head h reads KV head
// h / rep.  Entry c of slot s is visible when
//     kv_pos <= q_pos  and  q_pos - kv_pos < window
// which covers causality, empty (sentinel-position) entries, padded tails
// and ring-buffer windows in one rule.  With chunk > 0 (llama4's chunked
// attention; the Pallas kernel always applies the sliding rule) an entry
// must also lie in the query's chunk, kv_pos >= q_pos - q_pos % chunk: the
// same rule with a per-slot window of min(window, q_pos % chunk + 1),
// computed once a block.  A slot with no visible entry gets exactly 0, as
// the Pallas kernel does.
//
// What bounds it: memory.  Each output row needs the K and V of its slot's
// visible entries for its KV head and does 4 flops per byte of bf16 K/V --
// far below the ~295 flop/byte the H100 needs before its tensor cores are
// the limit.  The bound is the visible entries' K/V (masked tiles are
// skipped): 7.44 MB, about 2.2 us at 3.35 TB/s, for the lens of
// chip_smoke.py's fedmm-base case (S 8, C 1024, KV 8, dh 64, bf16), which
// is the bound chip_smoke.py reports.  A full pool would be 16.8 MB, 5 us.
//
// Before (the first port): one block per (KV head, slot) walked its slot's
// whole pool serially: 8 x 8 = 64 blocks at fedmm-base, so 68 of the 132
// SMs sat idle, and the slots of 1,000 entries took 16 tiles of one
// global round trip each (~3 us a tile, 51.7 us in all).
//
// Design: two passes, both launched from decode_attention_launch, so the
// host pays one ctypes call per layer and step.
//   * Split pass: the pool axis C is cut into n_split contiguous chunks of
//     split_len positions (whole tiles; the last chunk also takes the
//     ragged tail); the wrapper picks n_split for about two blocks per SM
//     (kernels/decode_attention.py, split_plan: 8 chunks of 128 at
//     fedmm-base, 512 blocks).  One block per (chunk, KV head, slot).  The
//     rep query rows of the group are staged once in shared memory,
//     pre-scaled by dh^-0.5, so K and V are read once for all rep heads.
//     A loop runs over the chunk's tiles of TC positions.  Each tile's
//     kv_pos mask is staged first (from positions loaded two tiles ahead)
//     and a tile with no visible entry is skipped without touching its
//     K/V.  Otherwise each thread loads 16-byte chunks of K and V straight
//     into registers, one tile ahead: tile t + 1's K/V is in flight while
//     tile t computes.  Thread t holds chunk t % CPR of the rows t / CPR +
//     KPS j.  The scores are its chunk's partial dots with the staged q,
//     summed over the CPR lanes of a row by shuffles; the online softmax
//     runs in f32 with one warp per query row; and each thread adds p V
//     for its own chunk of dh and its own rows into a (rep, chunk)
//     accumulator in registers (sized by a compile-time bound on rep).  No
//     K or V goes through shared memory; the partial accumulators are
//     summed over threads once, at the end of the chunk.
//     The block writes its chunk's row max m, row sum l and un-normalised
//     accumulator (rep x dh) in f32 to the wrapper's scratch; a chunk with
//     no visible entry writes m = -inf, l = 0.  With n_split 1 the split
//     pass writes the output itself and the combine is not launched.
//   * Combine pass: one block per (KV head, slot, 128 of its rep x dh
//     outputs) merges the chunks:
//     m* = max m_i, l* = sum l_i e^(m_i - m*), out = sum acc_i e^(m_i - m*)
//     / max(l*, 1e-30), in one pass that reads 8 chunks at once and
//     rescales its running sums when m* grows.  Empty chunks are skipped
//     explicitly, so a slot with no visible entry anywhere gets exactly 0;
//     cast to q's dtype.
//   * dh 256 (RecurrentGemma's local attention: rep 16 over one KV head,
//     so a pool of 8 slots is 8 (slot, KV) pairs and the split alone
//     fills the card): tiles of 16 positions; a thread holds 8 elements
//     of a row (two 16-byte loads in f32), so a row is one warp and the
//     per-thread registers are those of dh 128.  At rep 16 the warps'
//     partial accumulators (64 KB) would not fit the static shared
//     memory, so the warps add theirs into one (rep, dh) buffer in turn.
//     The wrapper's split_plan keeps each chunk at 4 rep positions or
//     more, so the f32 partials written and read back stay under about
//     half the K/V the chunk reads: 32 chunks of 64 at the hybrid's pool.
//   * dh 96 (Phi-3-vision, MHA: rep 1): 4096 / 96 is no whole tile and a
//     row is 12 16-byte chunks in bf16, which no power-of-two count of
//     threads splits into whole loads.  So a tile holds 32 positions and a
//     row is dealt to 8 threads of 12 elements each: 8 at 8 ch (one
//     16-byte load in bf16, two in f32) and 4 at 64 + 4 ch (one 8-byte
//     load in bf16, one 16-byte in f32), so every load is aligned and the
//     8 threads of a row read 128, then 64 contiguous bytes (12
//     contiguous elements would put every odd chunk off 16 bytes).  A
//     thread holds 2 rows of a tile and 12 accumulators a query head: 128
//     registers at rep <= 2 without spills, 4 blocks an SM as at dh 64 and
//     128.
//
// K, V and the pool must be 16-byte aligned (the wrapper checks).
#include "common.cuh"

#include <cmath>

namespace {

using namespace repro;

constexpr int kThreads = 128;
constexpr int kMaxRep = 16;

// positions a tile: 64 at dh 64, 32 at dh 96 and 128, 16 at dh 256
template <int DH>
constexpr int kTile = DH == 96 ? 32 : 4096 / DH;

// elements of a row one thread holds: one 16-byte load, or at dh 256 in
// f32 two, so that a row never spans more than one warp; 12 at dh 96
template <typename T, int DH>
constexpr int kChunk = DH == 96 ? 12 : kVec<T> > DH / 32 ? kVec<T> : DH / 32;

// elements of a thread's chunk that lie in the row's last 32 (dh 96)
template <int DH>
constexpr int kTail = DH == 96 ? 4 : 0;

// the row element that element e of chunk ch holds
template <typename T, int DH>
__device__ __forceinline__ int chunk_elem(int ch, int e) {
  constexpr int VEC = kChunk<T, DH>, VB = kTail<DH>, VA = VEC - VB, CPR = DH / VEC;
  return e < VA ? ch * VA + e : CPR * VA + ch * VB + (e - VA);
}

// N elements (8 or 16 bytes) into registers: a chunk's tail piece at dh
// 96, 8 bytes in bf16 kept in .x and .y
template <typename T, int N>
__device__ __forceinline__ uint4 load_piece(const T* p) {
  if constexpr (N * sizeof(T) == 16) {
    return *reinterpret_cast<const uint4*>(p);
  } else {
    static_assert(N * sizeof(T) == 8, "pieces of 8 or 16 bytes");
    const uint2 h = *reinterpret_cast<const uint2*>(p);
    return make_uint4(h.x, h.y, 0u, 0u);
  }
}

template <typename T, int N>
__device__ __forceinline__ void widen_n(const uint4& raw, float* dst) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = to_f(e[i]);
}

// the warps' partial accumulators summed in turn through one buffer when
// all of them together would take more than 32 KB of shared memory
template <int DH, int MAXREP>
constexpr bool kSerialSum = (kThreads / 32) * MAXREP * DH * 4 > 32768;

// 4 blocks an SM (<= 128 registers a thread, no spills) for bf16 at rep <= 2:
// the split pass of a fedmm-base pool (512 blocks) then runs in one wave
template <typename T, int DH, int MAXREP>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 && MAXREP <= 2 ? 4 : 1)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ q_pos,
                    const int* __restrict__ kv_pos, T* __restrict__ out,
                    float* __restrict__ part, int C, int KV, int rep, int window,
                    int chunk, float scale, int split_len) {
  constexpr int TC = kTile<DH>;
  constexpr int VEC = kChunk<T, DH>;                   // elements per chunk of a row
  constexpr int VB = kTail<DH>, VA = VEC - VB;         // ... in the row's tail, before it
  constexpr int NA = VA / kVec<T>;                     // 16-byte loads of the head
  constexpr int LPC = NA + (VB > 0);                   // pieces (loads) per chunk
  constexpr int NT = VB > 0 ? VB : kVec<T>;            // elements of the tail piece
  constexpr int CPR = DH / VEC;                        // chunks per key row
  constexpr int KPS = kThreads / CPR;                  // key rows per sweep of the block
  constexpr int NV = TC / KPS;                         // K (and V) chunks per thread per tile
  constexpr int NW = kThreads / 32;
  constexpr bool SERIAL = kSerialSum<DH, MAXREP>;
  static_assert(NV * KPS == TC && CPR <= 32 && 32 % CPR == 0 && VA % 4 == 0 &&
                    VB % 4 == 0 && NA * kVec<T> == VA,
                "a tile must split into whole pieces of 8 or 16 bytes per thread");
  // where piece u of chunk ch starts in the row
  auto piece_at = [&](int ch, int u) { return chunk_elem<T, DH>(ch, u * kVec<T>); };
  __shared__ __align__(16) float sq[MAXREP][DH];
  __shared__ float ss[MAXREP][TC];
  __shared__ float sred[SERIAL ? 1 : NW][MAXREP][DH];
  __shared__ int sok[2][TC];                           // the masks of this tile and the next
  __shared__ float sm[MAXREP], sl[MAXREP], scorr[MAXREP];

  const int split = blockIdx.x, n_split = gridDim.x;
  const int g = blockIdx.y, s = blockIdx.z, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ch = tid % CPR, key0 = tid / CPR;          // my chunk of a row; my keys key0 + KPS j
  const int H = KV * rep, nq = rep * DH;
  const int c_begin = split * split_len;
  const int c_end = split + 1 == n_split ? C : c_begin + split_len;
  const int ntiles = (c_end - c_begin + TC - 1) / TC;
  const int* pos = kv_pos + static_cast<size_t>(s) * C;
  const int qp = q_pos[s];
  // the chunked rule as this slot's window: entries from its chunk's start
  const int win = chunk > 0 && qp >= 0 ? min(window, qp % chunk + 1) : window;
  const size_t row0 = (static_cast<size_t>(s) * H + static_cast<size_t>(g) * rep) * DH;

  // thread tid < TC stages entry tid of each tile's mask from kv_pos it
  // loaded two tiles ahead
  auto load_pos = [&](int tile) {
    const int c = c_begin + tile * TC + tid;
    return tid < TC && tile < ntiles && c < c_end ? pos[c] : 0;
  };
  auto stage_mask = [&](int tile, int kp) {            // 1 where my entry is visible
    int ok = 0;
    if (tid < TC) {
      ok = c_begin + tile * TC + tid < c_end && kp <= qp && qp - kp < win;
      sok[tile & 1][tid] = ok;
    }
    return ok;
  };
  auto load_kv = [&](int tile, uint4 (&kr)[NV * LPC], uint4 (&vr)[NV * LPC]) {
    const int c0 = c_begin + tile * TC;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int cc = key0 + KPS * j;
#pragma unroll
      for (int u = 0; u < LPC; ++u) {
        const int x = j * LPC + u;
        kr[x] = vr[x] = make_uint4(0u, 0u, 0u, 0u);     // masked entries stay 0
        if (sok[tile & 1][cc]) {
          const size_t off =
              ((static_cast<size_t>(s) * C + c0 + cc) * KV + g) * DH + piece_at(ch, u);
          kr[x] = u < NA ? load_piece<T, kVec<T>>(k + off) : load_piece<T, NT>(k + off);
          vr[x] = u < NA ? load_piece<T, kVec<T>>(v + off) : load_piece<T, NT>(v + off);
        }
      }
    }
  };

  auto widen = [&](const uint4& raw, float* dst, int u) {   // piece u to f32
    if (u < NA)
      widen16<T>(raw, dst);
    else
      widen_n<T, NT>(raw, dst);
  };

  int kp0 = load_pos(0), kp1 = load_pos(1);
  for (int i = tid; i < nq; i += kThreads) sq[i / DH][i % DH] = to_f(q[row0 + i]) * scale;
  if (tid < MAXREP) {
    sm[tid] = kNegInf;
    sl[tid] = 0.f;
  }
  float acc[MAXREP][VEC];                              // my chunk of each row, my keys only
#pragma unroll
  for (int r = 0; r < MAXREP; ++r)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;

  // a tile with no visible entry is skipped before its K/V load; the K/V
  // of tile t + 1 is in flight while tile t computes
  uint4 kr[NV * LPC], vr[NV * LPC];
  int any = __syncthreads_or(stage_mask(0, kp0));
  if (any) load_kv(0, kr, vr);
  for (int t = 0; t < ntiles; ++t) {
    // also the barrier between tile t - 1's reads of ss and tile t's writes
    const int any_next = __syncthreads_or(t + 1 < ntiles ? stage_mask(t + 1, kp1) : 0);
    kp1 = load_pos(t + 2);
    uint4 kn[NV * LPC], vn[NV * LPC];
    if (any_next) load_kv(t + 1, kn, vn);
    if (any) {
      const int* ok = sok[t & 1];

      // scores: each thread dots its chunk, the CPR lanes of a key sum by shuffles
      float kf[NV][VEC];
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int u = 0; u < LPC; ++u) widen(kr[j * LPC + u], kf[j] + u * kVec<T>, u);
#pragma unroll
      for (int r = 0; r < MAXREP; ++r) {
        if (r >= rep) break;
        float qv[VEC];
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          *reinterpret_cast<float4*>(&qv[e]) =
              *reinterpret_cast<const float4*>(&sq[r][chunk_elem<T, DH>(ch, e)]);
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot += qv[e] * kf[j][e];
          dot = group_sum<CPR>(dot);
          const int cc = key0 + KPS * j;
          if (ch == 0) ss[r][cc] = ok[cc] ? dot : kNegInf;
        }
      }
      __syncthreads();

      for (int r = warp; r < rep; r += NW) {           // one warp per query row
        float mx = kNegInf;
        for (int cc = lane; cc < TC; cc += 32) mx = fmaxf(mx, ss[r][cc]);
        const float m_prev = sm[r];
        const float m_new = fmaxf(m_prev, group_max<32>(mx));
        float sum = 0.f;
        for (int cc = lane; cc < TC; cc += 32) {
          const float p = ok[cc] ? expf(ss[r][cc] - m_new) : 0.f;
          ss[r][cc] = p;
          sum += p;
        }
        sum = group_sum<32>(sum);
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          sl[r] = sl[r] * corr + sum;
          sm[r] = m_new;
          scorr[r] = corr;
        }
      }
      __syncthreads();

      float vf[NV][VEC];
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int u = 0; u < LPC; ++u) widen(vr[j * LPC + u], vf[j] + u * kVec<T>, u);
#pragma unroll
      for (int r = 0; r < MAXREP; ++r) {
        if (r >= rep) break;
        const float corr = scorr[r];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] *= corr;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const float p = ss[r][key0 + KPS * j];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r][e] += p * vf[j][e];
        }
      }
    }
    any = any_next;
#pragma unroll
    for (int j = 0; j < NV * LPC; ++j) {
      kr[j] = kn[j];
      vr[j] = vn[j];
    }
  }
  __syncthreads();                                     // sl and sm are final

  // sum each chunk's accumulator over the threads that hold it: the lanes
  // ch + CPR i of a warp by shuffles, then the warps through shared memory
  // (all at once, or in turn into one buffer)
  for (int w = 0; w < (SERIAL ? NW : 1); ++w) {
    if (!SERIAL || warp == w) {
#pragma unroll
      for (int r = 0; r < MAXREP; ++r) {
        if (r >= rep) break;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float x = acc[r][e];
#pragma unroll
          for (int o = CPR; o < 32; o *= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
          if (lane < CPR) {
            float& dst = sred[SERIAL ? 0 : warp][r][chunk_elem<T, DH>(ch, e)];
            dst = SERIAL && w > 0 ? dst + x : x;
          }
        }
      }
    }
    __syncthreads();
  }

  // scratch: acc (S, KV, n_split, rep, DH), then (m, l) (S, KV, n_split, rep, 2)
  const size_t prow = ((static_cast<size_t>(s) * KV + g) * n_split + split) * rep;
  for (int e = tid; e < nq; e += kThreads) {
    const int r = e / DH, d = e % DH;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < (SERIAL ? 1 : NW); ++w) a += sred[w][r][d];
    if (part == nullptr)                               // one chunk: the output itself
      out[row0 + e] = from_f<T>(a / fmaxf(sl[r], 1e-30f));
    else
      part[prow * DH + e] = a;
  }
  if (part != nullptr && tid < rep) {
    float* pml = part + static_cast<size_t>(gridDim.z) * KV * n_split * rep * DH + prow * 2;
    pml[2 * tid] = sl[tid] > 0.f ? sm[tid] : -INFINITY;
    pml[2 * tid + 1] = sl[tid];
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part, T* __restrict__ out, int KV,
                      int rep, int n_split) {
  constexpr int NB = 8;                                // chunks read together
  const int g = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  const int e0 = blockIdx.z * kThreads, estride = gridDim.z * kThreads;
  const size_t prow = (static_cast<size_t>(s) * KV + g) * n_split * rep;
  const float* pacc = part + prow * DH;
  const float* pml = part + static_cast<size_t>(S) * KV * n_split * rep * DH + prow * 2;
  const size_t row0 = (static_cast<size_t>(s) * KV * rep + static_cast<size_t>(g) * rep) * DH;
  for (int e = e0 + threadIdx.x; e < rep * DH; e += estride) {
    const int r = e / DH, d = e % DH;
    // a running (m*, l*, out) over the chunks, NB of them loaded at once;
    // an empty chunk (l = 0) is skipped, never weighted by e^(-inf + inf)
    float m_star = -INFINITY, l_star = 0.f, a = 0.f;
    for (int i0 = 0; i0 < n_split; i0 += NB) {
      float m[NB], l[NB], x[NB];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        m[i] = -INFINITY;
        l[i] = x[i] = 0.f;
        if (i0 + i < n_split) {
          const int row = (i0 + i) * rep + r;
          m[i] = pml[2 * row];
          l[i] = pml[2 * row + 1];
          x[i] = pacc[row * DH + d];
        }
      }
      float m_new = m_star;
#pragma unroll
      for (int i = 0; i < NB; ++i)
        if (l[i] > 0.f) m_new = fmaxf(m_new, m[i]);
      if (m_new == -INFINITY) continue;                // nothing visible yet
      const float corr = expf(m_star - m_new);         // 0 while m* is -inf
      l_star *= corr;
      a *= corr;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        if (!(l[i] > 0.f)) continue;
        const float w = expf(m[i] - m_new);
        l_star += l[i] * w;
        a += x[i] * w;
      }
      m_star = m_new;
    }
    out[row0 + e] = from_f<T>(a / fmaxf(l_star, 1e-30f));
  }
}

template <typename T, int DH, int MAXREP>
void launch_split(const void* q, const void* k, const void* v, const void* q_pos,
                  const void* kv_pos, void* out, float* part, int S, int C, int KV,
                  int rep, int window, int chunk, float scale, int n_split,
                  int split_len, cudaStream_t stream) {
  decode_split_kernel<T, DH, MAXREP><<<dim3(n_split, KV, S), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(q_pos), static_cast<const int*>(kv_pos),
      static_cast<T*>(out), part, C, KV, rep, window, chunk, scale, split_len);
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           const void* kv_pos, void* out, void* part, int S, int C, int KV, int rep,
           int window, int chunk, float scale, int n_split, int split_len,
           cudaStream_t stream) {
  if (split_len < 1 || split_len % kTile<DH> != 0 ||
      static_cast<long long>(n_split - 1) * split_len >= C ||
      (n_split > 1) != (part != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* scratch = static_cast<float*>(part);
  // the accumulators are registers: size them by rep
  if (rep <= 2)
    launch_split<T, DH, 2>(q, k, v, q_pos, kv_pos, out, scratch, S, C, KV, rep, window,
                           chunk, scale, n_split, split_len, stream);
  else if (rep <= 4)
    launch_split<T, DH, 4>(q, k, v, q_pos, kv_pos, out, scratch, S, C, KV, rep, window,
                           chunk, scale, n_split, split_len, stream);
  else if (rep <= 8)
    launch_split<T, DH, 8>(q, k, v, q_pos, kv_pos, out, scratch, S, C, KV, rep, window,
                           chunk, scale, n_split, split_len, stream);
  else
    launch_split<T, DH, kMaxRep>(q, k, v, q_pos, kv_pos, out, scratch, S, C, KV, rep,
                                 window, chunk, scale, n_split, split_len, stream);
  if (n_split > 1)                                     // kThreads outputs a block
    decode_combine_kernel<T, DH>
        <<<dim3(KV, S, (rep * DH + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
            scratch, static_cast<T*>(out), KV, rep, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t: 0 when both launches were accepted.  `part` is
// the f32 scratch of S * KV * n_split * rep * (dh + 2) values, null when
// n_split is 1.  window >= 1 (the pool length for none); chunk 0 for no
// chunked rule.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* q_pos, const void* kv_pos, void* out,
                                       void* part, int S, int C, int KV, int rep, int dh,
                                       int window, int chunk, float scale, int is_bf16,
                                       int n_split, int split_len, void* stream) {
  if (rep < 1 || rep > kMaxRep || S < 1 || C < 1 || KV < 1 || S > 65535 || KV > 65535 ||
      n_split < 1 || window < 1 || chunk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_DECODE_LAUNCH(T, DH)                                                    \
  return launch<T, DH>(q, k, v, q_pos, kv_pos, out, part, S, C, KV, rep, window, chunk, \
                       scale, n_split, split_len, st)
  switch (dh * 2 + (is_bf16 ? 1 : 0)) {
    case 129: REPRO_DECODE_LAUNCH(__nv_bfloat16, 64);
    case 128: REPRO_DECODE_LAUNCH(float, 64);
    case 193: REPRO_DECODE_LAUNCH(__nv_bfloat16, 96);
    case 192: REPRO_DECODE_LAUNCH(float, 96);
    case 257: REPRO_DECODE_LAUNCH(__nv_bfloat16, 128);
    case 256: REPRO_DECODE_LAUNCH(float, 128);
    case 513: REPRO_DECODE_LAUNCH(__nv_bfloat16, 256);
    case 512: REPRO_DECODE_LAUNCH(float, 256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_DECODE_LAUNCH
}
