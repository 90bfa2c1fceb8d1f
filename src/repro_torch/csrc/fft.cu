// Batched radix-2 Stockham FFT over complex64 rows, for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/fft/fft.py::_fft_kernel
// (launched by fft_planes): the same Stockham autosort recurrence, so the
// result comes out in natural order with no bit reversal.  At the stage
// with sub-length m and L = N/m groups, for l < L and k < m/2:
//     a = x[l*m + k],  b = x[l*m + m/2 + k]
//     y[l*m/2 + k]       = a + b
//     y[(L + l)*m/2 + k] = (a - b) * exp(-+2*pi*i*k/m)
// The inverse is the same kernel with the twiddle sign flipped and a 1/N
// scale at the store, which equals conj(fft(conj x))/N.
//
// What bounds it on the H100: each row is read once and written once
// (16 N bytes) against 5 N log2 N flops, so every N this path takes
// (N <= 8192: at most 4.1 flops per byte, under the data sheet's FP32
// ridge of 67 TFLOP/s / 3.35 TB/s = 20) is bound by memory; at the main
// path's one-row launches the launch itself costs more than either.
// Design: one thread block owns a row at a time, so the log2 N stages run
// out of shared memory and never touch device memory in between.  The row
// lives in two float2 ping-pong buffers in dynamic shared memory (16 N
// bytes: 128 KB at N = 8192, which needs the >48 KB opt-in).  At most 512
// threads do the N/2 butterflies of a stage, with __syncthreads() between
// stages.  A block walks up to block_rows consecutive rows; rows are
// independent, so block_rows is a pure launch parameter and every value
// gives bit-identical output.  Twiddles come from sincospif on the exact
// fraction 2k/m (no --use_fast_math, no __sincosf: accuracy at N = 8192
// depends on it), and the butterfly arithmetic uses round-to-nearest
// intrinsics so that no fused multiply-add changes the result between
// builds.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxN = 8192;

__global__ void stockham_fft_kernel(const float2* __restrict__ in,
                                    float2* __restrict__ out,
                                    long long rows, int n, int log2n,
                                    float sign, float scale,
                                    int block_rows) {
  extern __shared__ float2 smem[];
  float2* buf[2] = {smem, smem + n};
  const int half = n >> 1;
  const long long first = (long long)blockIdx.x * block_rows;
  for (int i = 0; i < block_rows; ++i) {
    const long long r = first + i;
    if (r >= rows) break;
    const float2* src = in + r * n;
    for (int t = threadIdx.x; t < n; t += blockDim.x) buf[0][t] = src[t];
    __syncthreads();
    int cur = 0;
    int m = n;
    for (int s = 0; s < log2n; ++s) {
      const int m2 = m >> 1;
      const float2* x = buf[cur];
      float2* y = buf[cur ^ 1];
      for (int j = threadIdx.x; j < half; j += blockDim.x) {
        const int l = j / m2;
        const int k = j - l * m2;
        const float2 a = x[l * m + k];
        const float2 b = x[l * m + m2 + k];
        float wr, wi;
        // angle = sign * 2*pi*k/m; 2k/m is exact for power-of-two m
        sincospif(sign * (2.0f * (float)k / (float)m), &wi, &wr);
        const float dr = __fsub_rn(a.x, b.x);
        const float di = __fsub_rn(a.y, b.y);
        y[l * m2 + k] = make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
        y[(n / m + l) * m2 + k] =
            make_float2(__fsub_rn(__fmul_rn(dr, wr), __fmul_rn(di, wi)),
                        __fadd_rn(__fmul_rn(dr, wi), __fmul_rn(di, wr)));
      }
      __syncthreads();
      cur ^= 1;
      m = m2;
    }
    float2* dst = out + r * n;
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const float2 v = buf[cur][t];
      dst[t] = make_float2(__fmul_rn(v.x, scale), __fmul_rn(v.y, scale));
    }
    __syncthreads();  // the next row reuses both buffers
  }
}

}  // namespace

// in, out: rows x n complex64 (interleaved float2), contiguous, distinct.
// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int rimms_fft_c64(const void* in, void* out, long long rows,
                             int n, int inverse, int block_rows,
                             void* stream) {
  if (n < 2 || n > kMaxN || (n & (n - 1)) != 0 || rows < 0 ||
      block_rows < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  const int threads = (n / 2 < kMaxThreads) ? n / 2 : kMaxThreads;
  const long long blocks = (rows + block_rows - 1) / block_rows;
  const size_t smem = 2 * (size_t)n * sizeof(float2);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        stockham_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const float sign = inverse ? 1.0f : -1.0f;
  const float scale = inverse ? 1.0f / (float)n : 1.0f;
  stockham_fft_kernel<<<(unsigned)blocks, threads, smem,
                        (cudaStream_t)stream>>>(
      (const float2*)in, (float2*)out, rows, n, log2n, sign, scale,
      block_rows);
  return (int)cudaGetLastError();
}
