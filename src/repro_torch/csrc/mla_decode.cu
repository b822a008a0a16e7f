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
// Design (a simple one: right first, fast later):
//   * Split pass: one block per (chunk of the pool, group of 16 heads,
//     slot).  The wrapper cuts C into n_split chunks of split_len
//     positions (whole tiles of 32; the last chunk takes the ragged tail)
//     for about two blocks per SM (kernels/mla_decode.py, split_plan: 8
//     chunks of 544 at DeepSeek-V2's pool, 512 blocks).  A block walks its
//     chunk's visible tiles only (up to lens[s]); a chunk past lens[s]
//     writes m = -inf, l = 0 at once.
//   * bf16 (4 warps, mma.sync m16n8k16 through mma.cuh): the block's 16
//     query rows [q_c | q_rope] are staged once in shared memory, 576 wide
//     and swizzled; 32-position tiles of [c_kv | k_rope] come through a
//     two-stage cp.async ring (zero past the visible range), 36 KB each.
//     Warp w computes the scores of positions 8w .. 8w+7 of the tile over
//     all 576 values (A = Q by ldmatrix, B = the tile's rows), the row
//     maxima of the 4 warps meet in shared memory, each warp writes its
//     exp2 probabilities to a 16 x 32 P tile in bf16 (the row sums take
//     the f32 values), and then warp w multiplies P by columns 128w ..
//     128w+127 of the same tile's latent part (ldmatrix.trans), so c_kv is
//     read once from memory for both products.  O (16 x 128 a warp) stays
//     in f32 registers.  P is rounded to bf16 for its product, as flash
//     does; the plain version keeps it in f32 (the reference rounds the
//     normalised alpha to bf16 instead).
//   * f32 (256 threads, FMAs on the CUDA cores, for the f32 checks and
//     oracles): the same blocks and tiles, staged in shared memory as f32
//     with padded rows; thread (row h, lane j of 16) computes two scores
//     and 32 output columns.
//   * Combine pass (n_split > 1): one block per (head, slot) merges the
//     chunks' f32 (m, l, acc): m* = max m_i, out = sum acc_i e^(m_i - m*)
//     / max(sum l_i e^(m_i - m*), 1e-30), empty chunks skipped.  With one
//     chunk the split pass writes the output itself.
//
// Both passes launch from mla_decode_launch; it allocates nothing (the
// wrapper passes the scratch) and returns cudaGetLastError().  All inputs
// must be contiguous and 16-byte aligned (the wrapper checks).
#include "mma.cuh"

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

// raise a kernel's dynamic shared memory limit once
cudaError_t allow_smem(const void* kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  done = err == cudaSuccess;
  return err;
}

}  // namespace

// Returns a cudaError_t: 0 when both passes were accepted.  kvr must be
// 512 and rd 64 (the only latent the kernel is built for), H a multiple
// of 16 up to 128; part is the f32 scratch of S x H x n_split x (kvr + 2)
// values when n_split > 1 (else unused); chunks are split_len positions
// (a multiple of 32), the last one taking the ragged tail.
extern "C" int mla_decode_launch(const void* q_c, const void* q_rope, const void* c_kv,
                                 const void* k_rope, const void* lens, void* out, void* part,
                                 int S, int C, int H, int kvr, int rd, float scale, int is_bf16,
                                 int n_split, int split_len, void* stream) {
  if (kvr != KVR || rd != RD || S < 1 || S > 65535 || C < 1 || H < HG || H > 128 ||
      H % HG != 0 || n_split < 1 || split_len < 1 ||
      (n_split > 1 && (part == nullptr || split_len % BK != 0 ||
                       static_cast<long long>(n_split - 1) * split_len >= C)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* scratch = n_split > 1 ? static_cast<float*>(part) : nullptr;
  const dim3 grid(n_split, H / HG, S);
  cudaError_t err;
  if (is_bf16) {
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
  if (is_bf16)
    mla_combine_kernel<bf16><<<dim3(H, S), KVR / 4, 0, st>>>(scratch, static_cast<bf16*>(out),
                                                             n_split);
  else
    mla_combine_kernel<float><<<dim3(H, S), KVR / 4, 0, st>>>(scratch, static_cast<float*>(out),
                                                              n_split);
  return static_cast<int>(cudaGetLastError());
}
