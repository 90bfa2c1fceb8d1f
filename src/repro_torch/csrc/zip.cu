// ZIP: pointwise complex multiply over complex64, for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/zip/zip.py::_zip_kernel
// (launched by zip_mul_planes): out = (ar*br - ai*bi, ar*bi + ai*br).
//
// What bounds it on the H100: 24 bytes move per element (two float2 reads,
// one float2 write) against 6 flops, so it is bound by memory at any size;
// at the radar path's sizes (128 to 131072 elements) the launch and one
// round trip to memory cost about as much as the bytes.
//
// Design: each thread moves two complex values with one 16-byte load per
// operand and one 16-byte store, neighbouring threads on neighbouring
// addresses, in a grid-stride loop over a grid capped at what fills the
// SMs (8 blocks of 256 threads an SM).  The data stays interleaved and is
// not padded to 128 lanes -- that padding existed for the TPU's vector
// registers.  Operands may be views at any element (fragments): the pairs
// follow the output's 16-byte boundary (an element before it, and one
// after the last pair, go to one thread), and an operand at the other
// 8-byte phase loads its pair as two 8-byte halves (a template flag, so
// the aligned case carries no test in its loop).  block_rows is kept as
// the elements a block covers per step of the loop (at least 512); the op
// is elementwise, so every value gives bit-identical output.  The products
// use round-to-nearest intrinsics so that no fused multiply-add changes
// the result between builds.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2048 / kThreads;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float2 cmul(float2 x, float2 y) {
  return make_float2(__fsub_rn(__fmul_rn(x.x, y.x), __fmul_rn(x.y, y.y)),
                     __fadd_rn(__fmul_rn(x.x, y.y), __fmul_rn(x.y, y.x)));
}

// elements i and i + 1 of p, 16-byte aligned there when ALIGNED
template <bool ALIGNED>
__device__ __forceinline__ float4 load_pair(const float2* __restrict__ p,
                                            long long i) {
  if constexpr (ALIGNED) {
    return __ldg(reinterpret_cast<const float4*>(p + i));
  } else {
    const float2 lo = __ldg(p + i), hi = __ldg(p + i + 1);
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
}

// out + head is 16-byte aligned; so are a + head when AA and b + head
// when BA.  Pair q covers elements head + 2q and head + 2q + 1.
template <bool AA, bool BA>
__global__ void __launch_bounds__(kThreads)
    zip_kernel(const float2* __restrict__ a, const float2* __restrict__ b,
               float2* __restrict__ out, long long n, int head) {
  const long long pairs = (n - head) >> 1;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
       q < pairs; q += stride) {
    const long long i = head + 2 * q;
    const float4 x = load_pair<AA>(a, i), y = load_pair<BA>(b, i);
    const float2 lo = cmul(make_float2(x.x, x.y), make_float2(y.x, y.y));
    const float2 hi = cmul(make_float2(x.z, x.w), make_float2(y.z, y.w));
    *reinterpret_cast<float4*>(out + i) = make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (head) out[0] = cmul(a[0], b[0]);
    if ((n - head) & 1) out[n - 1] = cmul(a[n - 1], b[n - 1]);
  }
}

// The SMs of the current device, read once per device.
int sm_count() {
  static std::atomic<int> sms[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 132;
  int n = sms[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0) {
      n = 132;
    }
    sms[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

}  // namespace

// a, b, out: n complex64 (interleaved float2), 8-byte aligned, at any
// element; out distinct from both.  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int rimms_zip_c64(const void* a, const void* b, void* out,
                             long long n, int block_rows, void* stream) {
  const auto pa = reinterpret_cast<uintptr_t>(a);
  const auto pb = reinterpret_cast<uintptr_t>(b);
  const auto po = reinterpret_cast<uintptr_t>(out);
  if (n < 0 || block_rows < 1 || ((pa | pb | po) & 7) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  const int head = (po & 15) ? 1 : 0;
  const bool aa = ((pa + 8 * head) & 15) == 0;
  const bool ba = ((pb + 8 * head) & 15) == 0;
  const long long per_block = block_rows > 2 * kThreads ? block_rows
                                                         : 2 * kThreads;
  long long blocks = (n + per_block - 1) / per_block;
  const long long cap = (long long)sm_count() * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  const auto* x = (const float2*)a;
  const auto* y = (const float2*)b;
  auto* z = (float2*)out;
  const auto st = (cudaStream_t)stream;
  const dim3 grid((unsigned)blocks);
  if (aa && ba) {
    zip_kernel<true, true><<<grid, kThreads, 0, st>>>(x, y, z, n, head);
  } else if (aa) {
    zip_kernel<true, false><<<grid, kThreads, 0, st>>>(x, y, z, n, head);
  } else if (ba) {
    zip_kernel<false, true><<<grid, kThreads, 0, st>>>(x, y, z, n, head);
  } else {
    zip_kernel<false, false><<<grid, kThreads, 0, st>>>(x, y, z, n, head);
  }
  return (int)cudaGetLastError();
}
