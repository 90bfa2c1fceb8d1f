// Split-TF32 tensor-core products and cp.async copies, shared by the
// chunkwise mLSTM's forward (mlstm.cu) and backward (mlstm_bwd.cu).
//
// Arithmetic: a float32 product runs as mma.sync.m16n8k8 on TF32
// operands in split form ("3xTF32": x = hi + lo with hi = x cut to TF32
// and lo = x - hi, and a b = hi_a hi_b + (lo_a hi_b + hi_a lo_b)), within
// 2^-18 of a float32 product, where plain TF32 (10-bit mantissa) is off
// by up to 2^-9.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// not volatile: independent products may be interleaved by the compiler
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// asynchronous copy of V floats (1, or 4 from 16-byte aligned addresses)
// into shared memory; zeros when !in
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(in ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Fragment element positions (mma.m16n8k8, TF32): lane = 4 g + t4;
// A: a0 (g, t4), a1 (g + 8, t4), a2 (g, t4 + 4), a3 (g + 8, t4 + 4);
// B: b0 (t4, g), b1 (t4 + 4, g); D: d0 (g, 2 t4), d1 (g, 2 t4 + 1),
// d2 (g + 8, 2 t4), d3 (g + 8, 2 t4 + 1).  Every product here feeds the
// k slots t4 and t4 + 4 with k = 2 t4 and 2 t4 + 1, in A and B alike (a
// sum over k does not depend on the order of its terms), so a lane's two
// k of a row are adjacent in memory.

// An operand fragment in split form, from its float values: hi is x cut
// to TF32's 10 mantissa bits, lo = x - hi (exact in float32); the tensor
// cores read a TF32 operand's top 19 bits, so they see hi exactly and lo
// to within 2^-20 of x, and hi hi + (lo hi + hi lo) is within 2^-18 of a b
// (tests/test_torch_recurrent_plan.py), where one TF32 product is off by
// up to 2^-9
template <int N>
struct Split {
  uint32_t hi[N], lo[N];
  __device__ __forceinline__ explicit Split(const float* x) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      hi[i] = __float_as_uint(x[i]) & 0xffffe000u;
      lo[i] = __float_as_uint(__fsub_rn(x[i], __uint_as_float(hi[i])));
    }
  }
};

// hi += a_hi b_hi, lo += a_lo b_hi + a_hi b_lo
__device__ __forceinline__ void mma3(float* hi, float* lo, const Split<4>& a,
                                     const Split<2>& b) {
  mma(lo, a.lo, b.hi);
  mma(lo, a.hi, b.lo);
  mma(hi, a.hi, b.hi);
}
__device__ __forceinline__ void mma3(float* hi, float* lo, const Split<4>& a,
                                     float b0, float b1) {
  const float bv[2] = {b0, b1};
  mma3(hi, lo, a, Split<2>(bv));
}

// A fragment values of a row-major tile p (row stride ld, both even)
// times `scale`
__device__ __forceinline__ void load_a(float* x, const float* p, int ld,
                                       int g, int t4, float scale = 1.f) {
  const float2 r0 = *(const float2*)(p + g * ld + 2 * t4);
  const float2 r1 = *(const float2*)(p + (g + 8) * ld + 2 * t4);
  x[0] = __fmul_rn(r0.x, scale);
  x[1] = __fmul_rn(r1.x, scale);
  x[2] = __fmul_rn(r0.y, scale);
  x[3] = __fmul_rn(r1.y, scale);
}

}  // namespace
