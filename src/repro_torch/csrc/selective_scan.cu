// Diagonal selective scan h_t = da_t * h_{t-1} + dbx_t, the recurrence of
// every Mamba-1 layer's prefill (channels C = d_inner * state) and every
// RG-LRU layer's (C = lru_width; da = a, dbx the gated input).
//
// Replaces: repro/kernels/selective_scan.py, selective_scan_pallas.
//
// da, dbx (B, S, C) in bf16 or f32, contiguous, widened to f32 on load;
// h0 (B, C) f32.  Writes h_all (B, S, C) and h_last (B, C) in f32.  Any S
// and C: the ragged edges are masked here, so the caller pads nothing.
//
// What bounds it: no products to speak of (2 flops per element), so the
// bytes: (2 * in_bytes + 4) * B * S * C + 8 * B * C.  At the Falcon-Mamba
// prefill (B 1, S 512, C 131,072, f32) that is 805 MB, ~0.24 ms at
// 3.35 TB/s; at the RG-LRU prefill (B 1, S 2,560, C 4,096) 126 MB, ~0.038 ms.
//
// Design.  The Pallas kernel walks a (B, C / bc, S / chunk) grid in order
// on one core, the state carried in VMEM from one chunk's grid step to the
// next.  Blocks of a GPU grid run in no order, so the wrapper's scan_plan
// picks one of two designs by how many columns B x C there are, and the
// launch refuses a plan that names neither:
//
//  - One pass (scan_kernel) when B x ceil(C / 256) >= ONE_PASS_BLOCKS = 264,
//    two blocks a SM at one column a thread, C is a multiple of 4 and every
//    pointer 16-byte aligned (Falcon-Mamba's prefill, C 131,072).  A thread
//    carries kPassCh = 4 adjacent columns through all S steps in registers:
//    one 16-byte load of f32 per input a step (8 bytes in bf16), a block
//    covering 1,024 channels, 4 KB of a row.  It keeps the next kAhead = 4
//    steps' loads in flight while it computes the current 4.  Bound by the
//    bytes, moved once.  What held one column a thread (4-byte
//    loads, 8 steps ahead) at ~83% of the bound was not the wave tail of its
//    512 blocks on 3 resident a SM: all 512 resident at once (a register
//    cap) ran no faster; 4 columns a thread with 4 steps ahead did, within
//    ~3% of torch.add's read-2-write-1 time over the same bytes.  With
//    C not a multiple of 4, or a pointer off 16 bytes, the plan takes the
//    chained design, which takes any C and any alignment.
//  - Chained (chained_kernel) otherwise: the RG-LRU's C 4,096 would give 16
//    one-pass blocks on 132 SMs, each thread walking 2,560 dependent steps.
//    S is cut into chunks of 8 x kSub = 128 steps; a block takes one chunk
//    of 32 channels, a lane a channel, warp w sub-chunk w with its da and
//    dbx held in registers (all 2 x kSub loads in flight at once): 2,560
//    blocks at S 2,560, 3 resident a SM.  (On the H100, 8-step sub-chunks
//    were no faster at B 1 and faster only at B 4; 24 or 32 steps, fewer
//    resident, no faster: PERF.md.)  Each warp composes its sub-chunk's
//    pair (A = prod da, b = its end state from 0); warp 0 waits for the
//    previous chunk's carry-out of its 32 columns, folds its 8 pairs in
//    order from it (carry = A * carry + b, each sub-chunk's carry-in into
//    shared memory), publishes the new carry-out, and every warp runs
//    h = da * h + dbx from its sub-chunk's carry-in and writes h_all (the
//    sub-chunk holding step S - 1 writes h_last).  Bytes move once.  The carry-out is one 64-bit
//    word, value and flag together, that only the next chunk of the same
//    columns reads: no block composes whatever happens to be published, so
//    the bits never depend on timing.  A block takes (chunk, b, tile) from
//    an atomic ticket, chunk-major, so it waits only on a block that took an
//    earlier ticket, which is running or done: no block spins on one that is
//    not resident.  The chain is S / (8 x kSub) hops deep (20 at S 2,560);
//    later chunks' loads are in flight while it resolves.  The wrapper
//    zeroes the links and the ticket on the stream (torch.zeros), so a CUDA
//    graph replays the call as it is.
//
// Every step rounds the product and the sum separately (no FMA), like the
// plain versions.  One pass is bit for bit the sequential
// ref.selective_scan_ref.  The chained design is bit for bit
// ref.selective_scan_chunked_ref at chunk kSub (its pairs, fold and rescans
// in the same order) and the sequential version only to a tolerance: its
// carry-ins are composed from pairs, ~1e-7 of max |h| apart at the hybrid's
// prompts.  No atomics touch the values: every launch gives the same bits.
#include <cstdint>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;              // chained: threads of a block
constexpr int kPassThreads = 256;          // one pass: threads of a block
constexpr int kPassCh = 4;                 // one pass: adjacent columns a thread
constexpr int kAhead = 4;                  // one pass: steps whose loads are in flight together
constexpr int kLanes = 32;                 // chained: channels of a block, one a lane
constexpr int kWarps = kThreads / kLanes;  // chained: sub-chunks of a block's chunk
constexpr int kSub = 16;                   // chained: steps of a sub-chunk

// kCh adjacent elements of T, loaded or stored as one access.
template <typename T, int kCh>
struct alignas(sizeof(T) * kCh) Vec {
  T v[kCh];
};

template <typename T>
__device__ __forceinline__ void load_steps(const T* __restrict__ da, const T* __restrict__ dbx,
                                           int t0, int len, size_t stride, Vec<T, kPassCh>* ra,
                                           Vec<T, kPassCh>* rb) {
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    if (t0 + j < len) {
      const size_t off = static_cast<size_t>(t0 + j) * stride;
      ra[j] = *reinterpret_cast<const Vec<T, kPassCh>*>(da + off);
      rb[j] = *reinterpret_cast<const Vec<T, kPassCh>*>(dbx + off);
    }
  }
}

// Links of the chained carry: a chunk's carry-out of one column, published
// as one 64-bit word (value in the low half, 1 in the high half), so the
// word itself is the flag.  The wrapper zeroes them before every call.
__device__ __forceinline__ unsigned long long ld_link(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_link(unsigned long long* p, float h) {
  const unsigned long long v = (1ull << 32) | __float_as_uint(h);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// One chunk of kWarps * kSub steps of a 32-channel tile (lane = channel),
// warp w holding sub-chunk w's da and dbx in registers.  Each warp composes
// its sub-chunk's pair (A = prod da, b = end state from 0); warp 0 waits for
// the previous chunk's carry-out of its columns, folds the kWarps pairs in
// order (each sub-chunk's carry-in into shared memory), publishes this
// chunk's carry-out, and every warp rescans its sub-chunk from its carry-in.
// A block takes its (chunk, b, tile) from a ticket, chunk-major, so it waits
// only on a block that took an earlier ticket and is running or done.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chained_kernel(const T* __restrict__ da, const T* __restrict__ dbx, const float* __restrict__ h0,
               float* __restrict__ h_all, float* __restrict__ h_last,
               unsigned long long* links, unsigned int* ticket, int B, int S, int C, int tiles,
               int n_chunks) {
  __shared__ int s_ticket;
  __shared__ float s_a[kWarps][kLanes], s_h[kWarps][kLanes];
  if (threadIdx.x == 0) s_ticket = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  const int v = s_ticket;
  const int k = v / (B * tiles);
  const int bi = (v / tiles) % B;
  const int lane = threadIdx.x % kLanes, w = threadIdx.x / kLanes;
  const int c = (v % tiles) * kLanes + lane;
  const int t0 = (k * kWarps + w) * kSub;
  const int len = c < C ? max(0, min(kSub, S - t0)) : 0;
  const size_t col = static_cast<size_t>(bi) * C + c;
  const size_t base = (static_cast<size_t>(bi) * S + max(0, min(t0, S - 1))) * C + c;

  T ra[kSub], rb[kSub];
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    if (j < len) {
      ra[j] = da[base + static_cast<size_t>(j) * C];
      rb[j] = dbx[base + static_cast<size_t>(j) * C];
    }
  }
  float A = 1.f, h = 0.f;
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    if (j < len) {
      const float x = to_f(ra[j]);
      h = __fadd_rn(__fmul_rn(x, h), to_f(rb[j]));
      A = __fmul_rn(x, A);
    }
  }
  s_a[w][lane] = A;
  s_h[w][lane] = h;
  __syncthreads();
  if (w == 0 && c < C) {
    float carry;
    if (k == 0) {
      carry = h0[col];
    } else {
      const unsigned long long* link = links + static_cast<size_t>(k - 1) * B * C + col;
      unsigned long long x;
      do {
        x = ld_link(link);
      } while ((x >> 32) == 0);
      carry = __uint_as_float(static_cast<unsigned>(x));
    }
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const float in = carry;
      carry = __fadd_rn(__fmul_rn(s_a[i][lane], carry), s_h[i][lane]);
      s_h[i][lane] = in;
    }
    if (k + 1 < n_chunks) st_link(links + static_cast<size_t>(k) * B * C + col, carry);
  }
  __syncthreads();
  if (len == 0) return;
  h = s_h[w][lane];
  float* out = h_all + base;
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    if (j < len) {
      h = __fadd_rn(__fmul_rn(to_f(ra[j]), h), to_f(rb[j]));
      out[static_cast<size_t>(j) * C] = h;
    }
  }
  if (t0 + len == S) h_last[col] = h;
}

// One pass: the recurrence over all S steps of kPassCh adjacent columns
// from h0, every step's h into h_all, the end state into h_last.  C is a
// multiple of kPassCh and every pointer 16-byte aligned (the launch checks).
template <typename T>
__global__ void __launch_bounds__(kPassThreads)
scan_kernel(const T* __restrict__ da, const T* __restrict__ dbx, const float* __restrict__ h0,
            float* __restrict__ h_all, float* __restrict__ h_last, int S, int C) {
  const int c = (blockIdx.x * kPassThreads + threadIdx.x) * kPassCh;
  if (c >= C) return;
  const size_t col = static_cast<size_t>(blockIdx.y) * C + c;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * C + c;
  const T* a = da + base;
  const T* b = dbx + base;
  float* out = h_all + base;

  Vec<float, kPassCh> h = *reinterpret_cast<const Vec<float, kPassCh>*>(h0 + col);
  Vec<T, kPassCh> ra[kAhead], rb[kAhead], na[kAhead], nb[kAhead];
  load_steps(a, b, 0, S, C, ra, rb);
  for (int t0 = 0; t0 < S; t0 += kAhead) {
    if (t0 + kAhead < S) load_steps(a, b, t0 + kAhead, S, C, na, nb);
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (t0 + j < S) {
#pragma unroll
        for (int i = 0; i < kPassCh; ++i) {
          h.v[i] = __fadd_rn(__fmul_rn(to_f(ra[j].v[i]), h.v[i]), to_f(rb[j].v[i]));
        }
        *reinterpret_cast<Vec<float, kPassCh>*>(out + static_cast<size_t>(t0 + j) * C) = h;
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      ra[j] = na[j];
      rb[j] = nb[j];
    }
  }
  *reinterpret_cast<Vec<float, kPassCh>*>(h_last + col) = h;
}

template <typename T>
int launch(const void* da, const void* dbx, const void* h0, void* h_all, void* h_last,
           void* links, int B, int S, int C, bool chained, cudaStream_t stream) {
  const T* a = static_cast<const T*>(da);
  const T* b = static_cast<const T*>(dbx);
  const float* h = static_cast<const float*>(h0);
  float* out = static_cast<float*>(h_all);
  float* last = static_cast<float*>(h_last);
  if (chained) {
    const int tiles = (C + kLanes - 1) / kLanes;
    const int n_chunks = (S + kWarps * kSub - 1) / (kWarps * kSub);
    unsigned long long* l = static_cast<unsigned long long*>(links);
    unsigned int* ticket =
        reinterpret_cast<unsigned int*>(l + static_cast<size_t>(n_chunks - 1) * B * C);
    chained_kernel<T><<<n_chunks * B * tiles, kThreads, 0, stream>>>(a, b, h, out, last, l, ticket,
                                                                   B, S, C, tiles, n_chunks);
  } else {
    const int per_block = kPassThreads * kPassCh;
    scan_kernel<T><<<dim3((C + per_block - 1) / per_block, B), kPassThreads, 0, stream>>>(
        a, b, h, out, last, S, C);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (tile, chunk, sub) is the wrapper's plan (scan_plan and fold_steps in
// kernels/selective_scan.py): channels of a block, steps of its chunk and
// steps each pair covers.  It must name one of the two designs built here
// -- chained (kLanes, kWarps * kSub, kSub) or one pass (kPassThreads *
// kPassCh, S, S) -- or the launch is refused, so the plan and the kernel
// cannot drift apart.  The chained design's `links` is a zeroed scratch of
// `n_links` 64-bit words, at least the links of every chunk but the last
// for each column and one word for the ticket; one pass ignores it (may be
// null) and needs C a multiple of kPassCh and every pointer 16-byte
// aligned.  Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int selective_scan_launch(const void* da, const void* dbx, const void* h0,
                                     void* h_all, void* h_last, void* links, long long n_links,
                                     int B, int S, int C, int tile, int chunk, int sub,
                                     int is_bf16, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || S < 1 || C < 1 || B > 65535) return invalid;
  const bool chained = tile == kLanes && chunk == kWarps * kSub && sub == kSub;
  if (chained) {
    const long long n_chunks = (S + kWarps * kSub - 1) / (kWarps * kSub);
    const long long blocks = n_chunks * B * ((C + kLanes - 1) / kLanes);
    if (links == nullptr || n_links < (n_chunks - 1) * B * C + 1 || blocks > 2147483647LL) {
      return invalid;
    }
  } else {
    auto at16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    if (tile != kPassThreads * kPassCh || chunk != S || sub != S || C % kPassCh != 0 ||
        !(at16(da) && at16(dbx) && at16(h0) && at16(h_all) && at16(h_last))) {
      return invalid;
    }
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(da, dbx, h0, h_all, h_last, links, B, S, C, chained, st);
  }
  return launch<float>(da, dbx, h0, h_all, h_last, links, B, S, C, chained, st);
}

// Blocks resident on a SM at once, as the occupancy calculator gives them:
// of the one-pass kernel (chained 0) or of the chained kernel (chained 1).
template <typename T>
int resident(bool chained) {
  int n = -1;
  const cudaError_t err =
      chained ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, chained_kernel<T>, kThreads, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, scan_kernel<T>,
                                                              kPassThreads, 0);
  return err == cudaSuccess ? n : -1;
}

extern "C" int selective_scan_resident(int chained, int is_bf16) {
  return is_bf16 ? resident<__nv_bfloat16>(chained != 0) : resident<float>(chained != 0);
}
