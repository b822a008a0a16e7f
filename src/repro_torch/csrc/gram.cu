// Pairwise cosine-similarity Gram matrices (paper Eq. 1), for a stack of K
// node batches.
//
// Replaces: repro/kernels/gram.py, cosine_gram_pallas (the JAX engine vmaps
// it over the node axis, core/engine.py:273-283).
//
// x (K, B, D) in bf16 or f32, contiguous; out (K, B, B) in f32:
// out[k, i, j] = <x_ki, x_kj> * rsqrt(max(|x_ki|^2, eps)) * rsqrt(max(|x_kj|^2, eps)),
// the Pallas kernel's row scaling.  The norms come from the same pass over
// D as the dot products, so x is read once per output tile and no
// normalised copy is ever written.
//
// What bounds it: at the round's shapes (B 32 anchors, D 768, one node in
// the loss, K 4 at the server) it moves ~53 KB per node and does ~1.6
// MFLOP: both bounds are well under a microsecond, so launch latency and
// the serial chunk loop set its time.  The design is the simple one that
// is right: one block of 16 x 16 threads per (16-row tile, 16-column tile,
// node), one output per thread; the block stages 64-wide chunks of its two
// row tiles in shared memory as f32 (rows padded by one word against bank
// conflicts), loads coalesced along D and zero-filled past B and D.  A
// thread issues all of a chunk's loads together into registers (raw,
// widened when stored to shared memory), and the next chunk's before it
// computes on the current one, so each chunk costs one memory round trip
// and that trip overlaps the arithmetic.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kTile = 16, kChunk = 64, kThreads = kTile * kTile;
constexpr int kLoads = kTile * kChunk / kThreads;    // per thread, per row tile, per chunk

// One chunk of the block's two row tiles, all loads in flight together,
// kept raw until they are stored to shared memory.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ xk, int i0, int j0, int d0,
                                           int B, int D, int tid, T* ri, T* rj) {
  const T zero = from_f<T>(0.f);
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const int e = tid + q * kThreads, r = e / kChunk, d = d0 + e % kChunk;
    const int a = i0 + r, b = j0 + r;
    ri[q] = (a < B && d < D) ? xk[static_cast<size_t>(a) * D + d] : zero;
    rj[q] = (b < B && d < D) ? xk[static_cast<size_t>(b) * D + d] : zero;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const T* __restrict__ x, float* __restrict__ out, int B, int D, float eps) {
  __shared__ float sI[kTile][kChunk + 1];
  __shared__ float sJ[kTile][kChunk + 1];
  const int j0 = blockIdx.x * kTile, i0 = blockIdx.y * kTile, k = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % kTile, ty = tid / kTile;
  const T* xk = x + static_cast<size_t>(k) * B * D;

  float dot = 0.f, ssi = 0.f, ssj = 0.f;
  T ri[kLoads], rj[kLoads];
  load_chunk(xk, i0, j0, 0, B, D, tid, ri, rj);
  for (int d0 = 0; d0 < D; d0 += kChunk) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int e = tid + q * kThreads;
      sI[e / kChunk][e % kChunk] = to_f(ri[q]);
      sJ[e / kChunk][e % kChunk] = to_f(rj[q]);
    }
    __syncthreads();
    if (d0 + kChunk < D) load_chunk(xk, i0, j0, d0 + kChunk, B, D, tid, ri, rj);
#pragma unroll 16
    for (int c = 0; c < kChunk; ++c) {
      const float a = sI[ty][c], b = sJ[tx][c];
      dot += a * b;
      ssi += a * a;
      ssj += b * b;
    }
    __syncthreads();                                  // chunk read before it is replaced
  }
  const int i = i0 + ty, j = j0 + tx;
  if (i < B && j < B)
    out[(static_cast<size_t>(k) * B + i) * B + j] =
        dot * rsqrtf(fmaxf(ssi, eps)) * rsqrtf(fmaxf(ssj, eps));
}

template <typename T>
int launch(const void* x, void* out, int K, int B, int D, float eps, cudaStream_t stream) {
  const dim3 grid((B + kTile - 1) / kTile, (B + kTile - 1) / kTile, K);
  gram_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                static_cast<float*>(out), B, D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int gram_launch(const void* x, void* out, int K, int B, int D, float eps,
                           int is_bf16, void* stream) {
  if (K < 1 || B < 1 || D < 1 || K > 65535 || (B + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(x, out, K, B, D, eps, st);
  return launch<float>(x, out, K, B, D, eps, st);
}
