// The fused GeoLoRA linear y = x @ W + (x @ A) @ B, forward and the input
// gradient of its backward.
//
// Replaces: repro/kernels/lora_matmul.py, lora_matmul_pallas (scale 1: no
// caller of the JAX linear passes another).
//
// x (M, K) contiguous; W (K, N), A (K, r) and B (r, N) each with its own
// element strides; y (M, N) contiguous, all in one dtype (bf16 or f32).
// Both products accumulate in f32 in one loop over K, and the rank-r product
// is added to the tile before its single store, as in the Pallas kernel.
// Because W, A and B are read through strides, the backward's input
// gradient dx = dy @ W^T + (dy @ B^T) @ A^T is this same function of
// (dy, W^T, B^T, A^T): the wrapper passes the transposes as swapped
// strides, never as copies.  When `xa` is not null, the f32 bottleneck
// x @ A (M, r) is written there too (by the blocks of the first column
// tile), so the backward's dB = (x @ A)^T @ dy needs no second pass over x.
//
// What bounds it: at the round's shapes (M 512 tokens, K 768, N 768 or
// 256, r 8, bf16) the function moves 1.4-2.8 MB and does 0.2-0.6 GFLOP:
// bytes bound it at ~0.4-0.8 us on the H100 (~140-220 flops per byte,
// under the ~295 of the bf16 ridge).  This first kernel runs the products
// as f32 FMAs on the CUDA cores (67 TFLOP/s, ~9 us at N 768), so
// arithmetic limits it well before either bound; wgmma with TMA-fed tiles
// is later work.
//
// Design: one block of 256 threads per 64 x 64 output tile.  Each step of
// the K loop stages a 64 x 32 tile of x, a 32 x 64 tile of W and a 32 x r
// tile of A in shared memory as f32 (rows padded by one word); each loader
// walks its tile in the order of its operand's unit stride, so the loads
// of a transposed operand stay coalesced.  A thread issues all of its
// loads of a step together into registers, as raw values widened only
// when they go to shared memory, and issues the next step's loads before
// it computes on the current tiles, so a step costs one memory round trip
// and that trip overlaps the arithmetic.  Each thread owns a 4 x 4
// micro-tile of the output (rows ty + 16 i, columns tx + 16 j) and up to 8
// of the tile's 64 x r bottleneck sums in registers (row tid / 4, ranks
// tid % 4 + 4 q), so no index inside the K loop divides by the runtime
// rank.  After the loop the bottleneck goes to shared memory, B's r x 64
// tile takes W's place, and each thread adds its rank-r product before the
// store.  Edges past M, N, K are zero-filled on load and masked on store.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int BM = 64, BN = 64, BK = 32, kThreads = 256;
constexpr int kMaxRank = 32;
constexpr int kXaPerThread = kMaxRank / 4;              // bottleneck sums a thread owns
static_assert(BM * 4 == kThreads, "four threads share each row of the bottleneck");
constexpr int kXLoads = BM * BK / kThreads;              // per thread per K step
constexpr int kWLoads = BK * BN / kThreads;
constexpr int kALoads = BK * kMaxRank / kThreads;

struct Strides {
  long long w0, w1, a0, a1, b0, b1;
};

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
// A's tile is walked as BK x kMaxRank, so no index needs a division by the
// runtime rank; the lanes past r load nothing and store zeros.
__device__ __forceinline__ void a_at(int e, const Strides& st, int& row, int& s) {
  if (st.a1 == 1) {
    row = e / kMaxRank;
    s = e % kMaxRank;
  } else {
    s = e / BK;
    row = e % BK;
  }
}

// One K step's loads, all in flight together.  They land in registers as
// raw T and are widened only when they are stored to shared memory, one
// step later: widening at the load would wait for each load in turn.
template <typename T>
__device__ __forceinline__ void load_step(const T* __restrict__ x, const T* __restrict__ w,
                                          const T* __restrict__ a, int m0, int n0, int k0,
                                          int M, int K, int N, int r, const Strides& st,
                                          int tid, T* xr, T* wr, T* ar) {
  const T zero = from_f<T>(0.f);
#pragma unroll
  for (int j = 0; j < kXLoads; ++j) {
    int row, col;
    x_at(tid + j * kThreads, row, col);
    const int m = m0 + row, k = k0 + col;
    xr[j] = (m < M && k < K) ? x[static_cast<size_t>(m) * K + k] : zero;
  }
#pragma unroll
  for (int j = 0; j < kWLoads; ++j) {
    int row, col;
    w_at(tid + j * kThreads, st, row, col);
    const int k = k0 + row, n = n0 + col;
    wr[j] = (k < K && n < N) ? w[k * st.w0 + n * st.w1] : zero;
  }
#pragma unroll
  for (int j = 0; j < kALoads; ++j) {
    int row, s;
    a_at(tid + j * kThreads, st, row, s);
    const int k = k0 + row;
    ar[j] = (s < r && k < K) ? a[k * st.a0 + s * st.a1] : zero;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lora_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ y,
                   float* __restrict__ xa_out, int M, int K, int N, int r, Strides st) {
  __shared__ float sX[BM][BK + 1];
  __shared__ float sW[BK][BN + 1];                  // after the K loop: B's r x BN tile
  __shared__ float sA[BK][kMaxRank + 1];
  __shared__ float sXA[BM][kMaxRank + 1];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
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

  T xr[kXLoads], wr[kWLoads], ar[kALoads];
  load_step(x, w, a, m0, n0, 0, M, K, N, r, st, tid, xr, wr, ar);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int j = 0; j < kXLoads; ++j) {
      int row, col;
      x_at(tid + j * kThreads, row, col);
      sX[row][col] = to_f(xr[j]);
    }
#pragma unroll
    for (int j = 0; j < kWLoads; ++j) {
      int row, col;
      w_at(tid + j * kThreads, st, row, col);
      sW[row][col] = to_f(wr[j]);
    }
#pragma unroll
    for (int j = 0; j < kALoads; ++j) {
      int row, s;
      a_at(tid + j * kThreads, st, row, s);
      sA[row][s] = to_f(ar[j]);
    }
    __syncthreads();
    if (k0 + BK < K)                      // the next step's loads overlap this step's math
      load_step(x, w, a, m0, n0, k0 + BK, M, K, N, r, st, tid, xr, wr, ar);

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
  for (int e = tid; e < r * BN; e += kThreads) {
    int s, col;
    if (st.b1 == 1) { s = e / BN; col = e % BN; } else { col = e / r; s = e % r; }
    const int n = n0 + col;
    sW[s][col] = n < N ? to_f(b[s * st.b0 + n * st.b1]) : 0.f;
  }
  __syncthreads();

  for (int s = 0; s < r; ++s) {
    float xv[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = sXA[ty + 16 * i][s];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = sW[s][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += xv[i] * bv[j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) y[static_cast<size_t>(m) * N + n] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* a, const void* b, void* y, void* xa,
           int M, int K, int N, int r, const Strides& st, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  lora_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<T*>(y), static_cast<float*>(xa), M, K, N, r,
      st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides are in elements.  Returns a cudaError_t: 0 when the launch was
// accepted.
extern "C" int lora_matmul_launch(const void* x, const void* w, const void* a,
                                  const void* b, void* y, void* xa, int M, int K, int N,
                                  int r, long long sw0, long long sw1, long long sa0,
                                  long long sa1, long long sb0, long long sb1,
                                  int is_bf16, void* stream) {
  if (M < 1 || K < 1 || N < 1 || r < 1 || r > kMaxRank || (M + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{sw0, sw1, sa0, sa1, sb0, sb1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(x, w, a, b, y, xa, M, K, N, r, st, s);
  return launch<float>(x, w, a, b, y, xa, M, K, N, r, st, s);
}
