// ZIP: pointwise complex multiply over complex64, for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/zip/zip.py::_zip_kernel
// (launched by zip_mul_planes): out = (ar*br - ai*bi, ar*bi + ai*br).
//
// What bounds it on the H100: 24 bytes move per element (two float2 reads,
// one float2 write) against 6 flops, so it is bound by memory at any size;
// below a few hundred thousand elements the launch costs more than the
// bytes.  Design: the data stays interleaved (one 8-byte float2 load per
// operand, neighbouring threads on neighbouring addresses) and is not
// padded to 128 lanes -- that padding existed for the TPU's vector
// registers.  A grid-stride loop covers n elements with the tail masked.
// block_rows is kept as the elements-per-block launch parameter; the op is
// elementwise, so every value gives bit-identical output.  The products
// use round-to-nearest intrinsics so that no fused multiply-add changes
// the result between builds.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

__global__ void zip_kernel(const float2* __restrict__ a,
                           const float2* __restrict__ b,
                           float2* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float2 x = a[i];
    const float2 y = b[i];
    out[i] = make_float2(__fsub_rn(__fmul_rn(x.x, y.x), __fmul_rn(x.y, y.y)),
                         __fadd_rn(__fmul_rn(x.x, y.y), __fmul_rn(x.y, y.x)));
  }
}

}  // namespace

// a, b, out: n complex64 (interleaved float2), contiguous; out distinct.
// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int rimms_zip_c64(const void* a, const void* b, void* out,
                             long long n, int block_rows, void* stream) {
  if (n < 0 || block_rows < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  long long blocks = (n + block_rows - 1) / block_rows;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  zip_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)a, (const float2*)b, (float2*)out, n);
  return (int)cudaGetLastError();
}
