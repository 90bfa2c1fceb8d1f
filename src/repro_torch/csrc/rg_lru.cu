// RG-LRU linear recurrence over (B, S, D) float32, for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/rg_lru/rg_lru.py::_rg_lru_kernel
// (launched by rg_lru_scan):
//     h_t = a_t * h_{t-1} + b_t,  elementwise over lanes d < D,
// returning every h_t (B, S, D) and the final state h_S (B, D).
//
// What bounds it on the H100: a and b are read once and h written once
// (12 bytes per element) against 2 flops, so it is bound by memory.  One
// thread walking all S steps of a lane leaves the card nearly empty at one
// sequence (D threads), and the serial chain's latency bounds it instead.
// Design: a chunked scan over S.  The sequence is cut into chunks of L
// steps (L = kernel argument `chunk`, fixed by the wrapper for every S; the
// last chunk may be shorter), so the grid covers (lane tiles, chunks,
// batch) and fills the card:
//  1. rg_lru_summary_kernel, one thread per (lane, chunk) for every chunk
//     but the last: scans its chunk from h = 0, keeping the local state h
//     and the product P of its a's, and stores (P, h) (reads a and b).
//  2. rg_lru_scan_kernel, one thread per (lane, chunk): carries h0 across
//     the summaries of the chunks before its own, H = P_k * H + h_k in
//     chunk order, then runs the recurrence over its chunk from H and
//     writes every h_t (reads a and b again: 20 bytes an element in all);
//     the last chunk writes h_final.
// Every thread of a lane carries the same summaries in the same order, so
// a chunk's incoming state is the same bits whichever thread computes it.
// A sequence of at most L steps is one chunk: pass 1 does not run and
// pass 2 is the sequential loop itself.  block_lanes is the lanes-per-block
// launch parameter (a block of min(block_lanes, 512) threads covers
// block_lanes lanes); no lane's arithmetic depends on it or on the card,
// so every value gives bit-identical output.  Each step is
// __fadd_rn(__fmul_rn(a, h), b) and each product __fmul_rn: no fused
// multiply-add, so the result equals rg_lru_plain's chunked torch loop bit
// for bit.  Loads of kUnroll steps are issued before their arithmetic.

#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 16;
constexpr int kMaxThreads = 512;

// Pass 1: (P, h) of chunk blockIdx.y for each lane, from h = 0.
__global__ void rg_lru_summary_kernel(const float* __restrict__ a,
                                      const float* __restrict__ b,
                                      float2* __restrict__ sums, int S, int D,
                                      int L, int block_lanes) {
  const int batch = blockIdx.z, k = blockIdx.y, nsum = gridDim.y;
  const int first = blockIdx.x * block_lanes;
  const int last = min(first + block_lanes, D);
  for (int lane = first + threadIdx.x; lane < last; lane += blockDim.x) {
    const long long row = ((long long)batch * S + (long long)k * L) * D + lane;
    float h = 0.f, p = 1.f;
    int t = 0;
    for (; t + kUnroll <= L; t += kUnroll) {
      float av[kUnroll], bv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        av[u] = a[row + (long long)(t + u) * D];
        bv[u] = b[row + (long long)(t + u) * D];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
        p = __fmul_rn(p, av[u]);
      }
    }
    for (; t < L; ++t) {
      const float at = a[row + (long long)t * D];
      h = __fadd_rn(__fmul_rn(at, h), b[row + (long long)t * D]);
      p = __fmul_rn(p, at);
    }
    sums[((long long)batch * nsum + k) * D + lane] = make_float2(p, h);
  }
}

// Pass 2: chunk blockIdx.y's incoming state from h0 and the summaries of
// the chunks before it, then the recurrence over the chunk.
__global__ void rg_lru_scan_kernel(const float* __restrict__ a,
                                   const float* __restrict__ b,
                                   const float* __restrict__ h0,
                                   const float2* __restrict__ sums,
                                   float* __restrict__ hs,
                                   float* __restrict__ hn, int S, int D, int L,
                                   int block_lanes) {
  const int batch = blockIdx.z, k = blockIdx.y, nchunks = gridDim.y;
  const int first = blockIdx.x * block_lanes;
  const int last = min(first + block_lanes, D);
  const int t0 = k * L, len = min(L, S - t0);
  for (int lane = first + threadIdx.x; lane < last; lane += blockDim.x) {
    float h = h0[(long long)batch * D + lane];
    const float2* sum = sums + (long long)batch * (nchunks - 1) * D + lane;
    for (int j = 0; j < k; ++j) {
      const float2 ph = sum[(long long)j * D];
      h = __fadd_rn(__fmul_rn(ph.x, h), ph.y);
    }
    const long long row = ((long long)batch * S + t0) * D + lane;
    int t = 0;
    for (; t + kUnroll <= len; t += kUnroll) {
      float av[kUnroll], bv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        av[u] = a[row + (long long)(t + u) * D];
        bv[u] = b[row + (long long)(t + u) * D];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
        hs[row + (long long)(t + u) * D] = h;
      }
    }
    for (; t < len; ++t) {
      const long long i = row + (long long)t * D;
      h = __fadd_rn(__fmul_rn(a[i], h), b[i]);
      hs[i] = h;
    }
    if (k == nchunks - 1) hn[(long long)batch * D + lane] = h;
  }
}

}  // namespace

// a, b, hs: (B, S, D) float32; h0, hn: (B, D) float32; all contiguous,
// outputs distinct from inputs.  sums: workspace of (B, ceil(S/L) - 1, D)
// float2, 8-byte aligned (unused when S <= L).  Launches on `stream`;
// returns cudaGetLastError() (0 on success).
extern "C" int rimms_rg_lru_f32(const void* a, const void* b, const void* h0,
                                void* hs, void* hn, void* sums, int B, int S,
                                int D, int block_lanes, int L, void* stream) {
  if (B < 0 || S < 0 || D < 0 || block_lanes < 1 || L < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return 0;
  const int nchunks = S > 0 ? (S + L - 1) / L : 1;
  if (nchunks > 65535) return (int)cudaErrorInvalidValue;
  const int threads = block_lanes < kMaxThreads ? block_lanes : kMaxThreads;
  const unsigned tiles = (unsigned)((D + block_lanes - 1) / block_lanes);
  cudaStream_t st = (cudaStream_t)stream;
  if (nchunks > 1) {
    rg_lru_summary_kernel<<<dim3(tiles, nchunks - 1, B), threads, 0, st>>>(
        (const float*)a, (const float*)b, (float2*)sums, S, D, L, block_lanes);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  rg_lru_scan_kernel<<<dim3(tiles, nchunks, B), threads, 0, st>>>(
      (const float*)a, (const float*)b, (const float*)h0,
      (const float2*)sums, (float*)hs, (float*)hn, S, D, L, block_lanes);
  return (int)cudaGetLastError();
}
