// Backward of the RG-LRU linear recurrence over (B, S, D) float32, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package differentiates its plain XLA
// scan (src/repro/models/recurrent.py), so its gradient is autograd's
// through rg_lru_plain, which this kernel computes.  With g_t the
// gradient reaching h_t of h_t = a_t h_{t-1} + b_t (rg_lru.cu):
//     g_{S-1} = dh_{S-1} + dh_final,  g_t = dh_t + a_{t+1} g_{t+1},
//     da_t = g_t h_{t-1} (h_{-1} = h0),  db_t = g_t,  dh0 = a_0 g_0.
// Written with E_t = a_t g_t, the gradient step t hands step t - 1, a
// step from the end is g = dh_t + E, E = a_t g: the forward's affine
// recurrence run backwards in time, E entering the last step as dh_final.
//
// What bounds it on the H100: a, dh and h are read and da, db written (20
// bytes an element) against 3 flops, so it is bound by memory; the serial
// chain over S is what keeps the card empty, as in the forward.  Design:
// the forward's chunked scan run in reverse, over the same chunks of L
// steps (the last one may be shorter), so the grid covers (lane tiles,
// chunks, batch):
//  1. rg_lru_bwd_summary_kernel, one thread per (lane, chunk) for every
//     chunk but the first: scans its chunk from its last step back to its
//     first from E = 0, keeping the local E and the product P of its a's,
//     and stores (P, E) (reads a and dh).
//  2. rg_lru_bwd_scan_kernel, one thread per (lane, chunk): carries
//     dh_final back across the summaries of the chunks after its own,
//     E = P_k * E + E_k from the last chunk down, then runs the step over
//     its chunk from there, writing db_t = g and da_t = g h_{t-1} (reads
//     a, dh and h again: 28 bytes an element in all); the first chunk
//     writes dh0.
// Every thread of a lane carries the same summaries in the same order, so
// the bits do not depend on which thread computes a chunk, on
// block_lanes or on the card.  Each step is g = __fadd_rn(dh, E),
// E = __fmul_rn(a, g) and each product __fmul_rn: no fused multiply-add,
// so the result equals rg_lru_backward_plain's chunked torch loop bit for
// bit.  Loads of kUnroll steps are issued before their arithmetic.

#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 16;
constexpr int kMaxThreads = 512;

// Pass 1: (P, E) of chunk blockIdx.y + 1 for each lane, from E = 0.
__global__ void rg_lru_bwd_summary_kernel(const float* __restrict__ a,
                                          const float* __restrict__ dh,
                                          float2* __restrict__ sums, int S,
                                          int D, int L, int block_lanes) {
  const int batch = blockIdx.z, k = blockIdx.y + 1, nsum = gridDim.y;
  const int first = blockIdx.x * block_lanes;
  const int last = min(first + block_lanes, D);
  const int t0 = k * L, len = min(L, S - t0);
  for (int lane = first + threadIdx.x; lane < last; lane += blockDim.x) {
    const long long row = ((long long)batch * S + t0) * D + lane;
    float e = 0.f, p = 1.f;
    int t = len;
    for (; t >= kUnroll; t -= kUnroll) {
      float av[kUnroll], gv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        av[u] = a[row + (long long)(t - 1 - u) * D];
        gv[u] = dh[row + (long long)(t - 1 - u) * D];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        e = __fmul_rn(av[u], __fadd_rn(gv[u], e));
        p = __fmul_rn(p, av[u]);
      }
    }
    for (; t > 0; --t) {
      const float at = a[row + (long long)(t - 1) * D];
      e = __fmul_rn(at, __fadd_rn(dh[row + (long long)(t - 1) * D], e));
      p = __fmul_rn(p, at);
    }
    sums[((long long)batch * nsum + k - 1) * D + lane] = make_float2(p, e);
  }
}

// Pass 2: the carry entering chunk blockIdx.y at its end, from dh_final and
// the summaries of the chunks after it, then the step over the chunk.
__global__ void rg_lru_bwd_scan_kernel(
    const float* __restrict__ a, const float* __restrict__ hs,
    const float* __restrict__ h0, const float* __restrict__ dh,
    const float* __restrict__ dhn, const float2* __restrict__ sums,
    float* __restrict__ da, float* __restrict__ db, float* __restrict__ dh0,
    int S, int D, int L, int block_lanes) {
  const int batch = blockIdx.z, k = blockIdx.y, nchunks = gridDim.y;
  const int first = blockIdx.x * block_lanes;
  const int last = min(first + block_lanes, D);
  const int t0 = k * L, len = min(L, S - t0);
  for (int lane = first + threadIdx.x; lane < last; lane += blockDim.x) {
    float e = dhn[(long long)batch * D + lane];
    const float2* sum = sums + (long long)batch * (nchunks - 1) * D + lane;
    for (int j = nchunks - 1; j > k; --j) {
      const float2 pe = sum[(long long)(j - 1) * D];
      e = __fadd_rn(__fmul_rn(pe.x, e), pe.y);
    }
    const long long row = ((long long)batch * S + t0) * D + lane;
    int t = len;
    // steps t - 1 .. t - kUnroll, none of them the sequence's first
    for (; t > kUnroll || (t == kUnroll && k > 0); t -= kUnroll) {
      float av[kUnroll], gv[kUnroll], hv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = row + (long long)(t - 1 - u) * D;
        av[u] = a[i];
        gv[u] = dh[i];
        hv[u] = hs[i - D];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = row + (long long)(t - 1 - u) * D;
        const float g = __fadd_rn(gv[u], e);
        db[i] = g;
        da[i] = __fmul_rn(g, hv[u]);
        e = __fmul_rn(av[u], g);
      }
    }
    for (; t > 0; --t) {
      const long long i = row + (long long)(t - 1) * D;
      const float hp = (k == 0 && t == 1) ? h0[(long long)batch * D + lane]
                                          : hs[i - D];
      const float g = __fadd_rn(dh[i], e);
      db[i] = g;
      da[i] = __fmul_rn(g, hp);
      e = __fmul_rn(a[i], g);
    }
    if (k == 0) dh0[(long long)batch * D + lane] = e;
  }
}

}  // namespace

// a, hs, dh, da, db: (B, S, D) float32; h0, dhn, dh0: (B, D) float32; all
// contiguous, outputs distinct from inputs.  hs is the forward's h_seq
// for (a, h0), dh and dhn the gradients of h_seq and h_final.  sums:
// workspace of (B, ceil(S/L) - 1, D) float2, 8-byte aligned (unused when
// S <= L).  Launches on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int rimms_rg_lru_bwd_f32(const void* a, const void* hs,
                                    const void* h0, const void* dh,
                                    const void* dhn, void* da, void* db,
                                    void* dh0, void* sums, int B, int S,
                                    int D, int block_lanes, int L,
                                    void* stream) {
  if (B < 0 || S < 0 || D < 0 || block_lanes < 1 || L < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return 0;
  const int nchunks = S > 0 ? (S + L - 1) / L : 1;
  if (nchunks > 65535) return (int)cudaErrorInvalidValue;
  const int threads = block_lanes < kMaxThreads ? block_lanes : kMaxThreads;
  const unsigned tiles = (unsigned)((D + block_lanes - 1) / block_lanes);
  cudaStream_t st = (cudaStream_t)stream;
  if (nchunks > 1) {
    rg_lru_bwd_summary_kernel<<<dim3(tiles, nchunks - 1, B), threads, 0,
                                st>>>((const float*)a, (const float*)dh,
                                      (float2*)sums, S, D, L, block_lanes);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  rg_lru_bwd_scan_kernel<<<dim3(tiles, nchunks, B), threads, 0, st>>>(
      (const float*)a, (const float*)hs, (const float*)h0, (const float*)dh,
      (const float*)dhn, (const float2*)sums, (float*)da, (float*)db,
      (float*)dh0, S, D, L, block_lanes);
  return (int)cudaGetLastError();
}
