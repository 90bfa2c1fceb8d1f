// RG-LRU linear recurrence over (B, S, D) float32, for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/rg_lru/rg_lru.py::_rg_lru_kernel
// (launched by rg_lru_scan):
//     h_t = a_t * h_{t-1} + b_t,  elementwise over lanes d < D,
// returning every h_t (B, S, D) and the final state h_S (B, D).
//
// What bounds it on the H100: a and b are read once and h written once
// (12 bytes per element) against 2 flops, so it is bound by memory; at one
// sequence the lanes (D of them) are too few to fill the card, and then the
// latency of the sequential chain over S bounds it instead.
// Design: one thread per (batch, lane) walks t = 0..S-1, so neighbouring
// threads read neighbouring addresses of a row (coalesced) and the state
// stays in a register.  The loads of kUnroll steps are issued before their
// arithmetic, so the chain waits on device memory once per kUnroll steps
// rather than every step.  The Pallas kernel padded D to 128 lanes; this one
// masks the ragged last block instead, so no padded copy is made.
// block_lanes is kept as the lanes-per-block launch parameter (a block of
// min(block_lanes, 512) threads covers block_lanes lanes); each lane's
// arithmetic does not depend on it, so every value gives bit-identical
// output.  The step is __fadd_rn(__fmul_rn(a, h), b): no fused multiply-add,
// so the result equals the plain torch loop (a * h + b) bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 16;
constexpr int kMaxThreads = 512;

__global__ void rg_lru_kernel(const float* __restrict__ a,
                              const float* __restrict__ b,
                              const float* __restrict__ h0,
                              float* __restrict__ hs, float* __restrict__ hn,
                              int S, int D, int block_lanes) {
  const int batch = blockIdx.y;
  const int first = blockIdx.x * block_lanes;
  const int last = min(first + block_lanes, D);
  for (int lane = first + threadIdx.x; lane < last; lane += blockDim.x) {
    const long long row = (long long)batch * S * D + lane;
    float h = h0[(long long)batch * D + lane];
    int t = 0;
    for (; t + kUnroll <= S; t += kUnroll) {
      float av[kUnroll], bv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = row + (long long)(t + u) * D;
        av[u] = a[i];
        bv[u] = b[i];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
        hs[row + (long long)(t + u) * D] = h;
      }
    }
    for (; t < S; ++t) {
      const long long i = row + (long long)t * D;
      h = __fadd_rn(__fmul_rn(a[i], h), b[i]);
      hs[i] = h;
    }
    hn[(long long)batch * D + lane] = h;
  }
}

}  // namespace

// a, b, hs: (B, S, D) float32; h0, hn: (B, D) float32; all contiguous,
// outputs distinct from inputs.  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int rimms_rg_lru_f32(const void* a, const void* b, const void* h0,
                                void* hs, void* hn, int B, int S, int D,
                                int block_lanes, void* stream) {
  if (B < 0 || S < 0 || D < 0 || block_lanes < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return 0;
  const dim3 grid((unsigned)((D + block_lanes - 1) / block_lanes),
                  (unsigned)B);
  const int threads = block_lanes < kMaxThreads ? block_lanes : kMaxThreads;
  rg_lru_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)h0, (float*)hs,
      (float*)hn, S, D, block_lanes);
  return (int)cudaGetLastError();
}
