// Diagonal selective scan h_t = da_t * h_{t-1} + dbx_t, the recurrence of
// every Mamba-1 layer's prefill (channels C = d_inner * state) and every
// RG-LRU layer's (C = lru_width; da = a, dbx the gated input).
//
// Replaces: repro/kernels/selective_scan.py, selective_scan_pallas.
//
// da, dbx (B, S, C) in bf16 or f32, contiguous, widened to f32 on load;
// h0 (B, C) f32.  Writes h_all (B, S, C) and h_last (B, C) in f32.  Any S
// and C: the ragged edge is masked here, so the caller pads nothing.
//
// What bounds it: no products to speak of (2 flops per element), so the
// bytes: (2 * in_bytes + 4) * B * S * C + 8 * B * C.  At the Falcon-Mamba
// prefill (B 1, S 512, C 131,072, f32) that is 805 MB, ~0.24 ms at
// 3.35 TB/s.
//
// Design: the Pallas kernel walks a (chunk x bc) grid with the state carried
// in VMEM from one sequential grid step to the next.  Blocks of a GPU grid
// run in no order, so the sequential axis becomes a loop inside one thread:
// one thread per (b, c) column carries h in a register through all S steps,
// and adjacent threads take adjacent channels, so every load and store of a
// step is one coalesced row segment.  At the prefill shape that is 512
// blocks of 256 threads on 132 SMs, all resident at once.  The RG-LRU's
// C 4,096 (B 1) fills only 16 blocks, so there the kernel runs at ~1/8 of
// its bound; a chunked scan for small C is queued.  A thread keeps
// the raw loads of the next kAhead steps in flight while it computes the
// current kAhead steps, and widens each value only just before it is used:
// widened at load time, each load's latency would stand in turn.  The
// update rounds the product and the sum separately (no FMA), so the kernel
// computes its plain PyTorch version's arithmetic step for step.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;
constexpr int kAhead = 8;                  // steps whose loads are in flight together

template <typename T>
__device__ __forceinline__ void load_steps(const T* __restrict__ da, const T* __restrict__ dbx,
                                           int t0, int S, size_t stride, T* ra, T* rb) {
  const T one = from_f<T>(1.f), zero = from_f<T>(0.f);
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    const bool live = t0 + j < S;
    const size_t off = static_cast<size_t>(t0 + j) * stride;
    ra[j] = live ? da[off] : one;
    rb[j] = live ? dbx[off] : zero;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ da, const T* __restrict__ dbx, const float* __restrict__ h0,
            float* __restrict__ h_all, float* __restrict__ h_last, int S, int C) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const size_t col = static_cast<size_t>(blockIdx.y) * C + c;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * C + c;
  const T* a = da + base;
  const T* b = dbx + base;
  float* out = h_all + base;

  float h = h0[col];
  T ra[kAhead], rb[kAhead], na[kAhead], nb[kAhead];
  load_steps(a, b, 0, S, C, ra, rb);
  for (int t0 = 0; t0 < S; t0 += kAhead) {
    if (t0 + kAhead < S) load_steps(a, b, t0 + kAhead, S, C, na, nb);
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (t0 + j < S) {
        h = __fadd_rn(__fmul_rn(to_f(ra[j]), h), to_f(rb[j]));
        out[static_cast<size_t>(t0 + j) * C] = h;
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      ra[j] = na[j];
      rb[j] = nb[j];
    }
  }
  h_last[col] = h;
}

template <typename T>
int launch(const void* da, const void* dbx, const void* h0, void* h_all, void* h_last, int B,
           int S, int C, cudaStream_t stream) {
  const dim3 grid((C + kThreads - 1) / kThreads, B);
  scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(da), static_cast<const T*>(dbx), static_cast<const float*>(h0),
      static_cast<float*>(h_all), static_cast<float*>(h_last), S, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int selective_scan_launch(const void* da, const void* dbx, const void* h0,
                                     void* h_all, void* h_last, int B, int S, int C,
                                     int is_bf16, void* stream) {
  if (B < 1 || S < 1 || C < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(da, dbx, h0, h_all, h_last, B, S, C, st);
  return launch<float>(da, dbx, h0, h_all, h_last, B, S, C, st);
}
