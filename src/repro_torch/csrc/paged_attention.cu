// Paged decode attention over RIMMS block tables, float32 or bfloat16, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel
// src/repro/kernels/paged_attention/paged_attention.py::_paged_kernel
// (launched by paged_attention).  One query token per sequence b attends
// over the K/V pool rows its block table names: position t of sequence b
// lies in page block_table[b, t / page] at slot t % page.  For each query
// head h (KV head h / (Hq / Hkv)), over the positions in order:
//     s = (q . k) / sqrt(d), -1e30 at t >= lengths[b]
//     m' = max(m, max s);  p = exp(s - m');  alpha = exp(m - m')
//     l = alpha l + sum p;  acc = alpha acc + p v;  m = m'
// and at the end out = acc / max(l, 1e-30), in q's type.
//
// What bounds it on the H100: each K/V byte is read once and used for
// 2 * Hq/Hkv flops, so the kernel is bound by bytes (at llama3-8b decode
// width, 8 sequences of 4096 tokens, 128 MiB of K+V: 0.040 ms at 3.35 TB/s).
// Design (simple first): one thread block per (KV head, sequence), so the
// group's Hq/Hkv query rows share every K/V row the block loads.  The block
// walks its positions in chunks of 64: 64 threads first resolve the chunk's
// rows through the block table, then every thread reads K and V rows in
// place (no gather copy exists) as 16-byte vectors, widened to float32 into
// shared memory; one thread per (query row, position) takes
// the dot product, one warp per query row does the chunk's online-softmax
// step, and each thread carries a fixed set of (query row, column) elements
// of the accumulator in registers.  Only B * Hkv blocks run, each walking
// its pages one chunk after another, so at small batch the card is far from
// its memory rate; splitting a sequence's pages across blocks (and TMA for
// the pages) is later work.
//
// Edge cases kept from the reference: a row with lengths[b] >= 1 stops at
// its length (positions past it would leave m, l and acc bit-unchanged:
// p = 0, alpha = 1).  A row with lengths[b] <= 0 visits every table
// position, all masked, so every p is exp(0) = 1 and the result is the
// uniform mean of V over the n_pages * page positions, as in the oracle;
// never NaN.  Table entries that repeat a page are legal; an entry outside
// [0, P) is clamped into it so the kernel never reads outside the pool.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;     // positions per shared-memory chunk
constexpr int kMaxD = 256;
constexpr int kMaxAcc = 16;    // accumulator elements per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16-byte vectors: 4 float32 or 8 bfloat16 elements
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ void unpack(const uint4& r, float* dst, float) {
  const float* f = reinterpret_cast<const float*>(&r);
#pragma unroll
  for (int u = 0; u < 4; ++u) dst[u] = f[u];
}
__device__ __forceinline__ void unpack(const uint4& r, float* dst,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 f = __bfloat1622float2(h[u]);
    dst[2 * u] = f.x;
    dst[2 * u + 1] = f.y;
  }
}

size_t smem_bytes(int G, int D) {
  return (size_t)kChunk * sizeof(long long) +
         ((size_t)kChunk * (D + 1) + (size_t)kChunk * D + (size_t)G * D +
          (size_t)G * kChunk + 3 * (size_t)G) *
             sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ block_table,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int P, int page, int Hkv, int G, int D, int n_pages,
                       float sqrt_d) {
  extern __shared__ float smem[];
  const int DP = D + 1;              // padded K row: conflict-free reads
  long long* row = reinterpret_cast<long long*>(smem);  // [kChunk] offsets
  float* ks = smem + 2 * kChunk;     // [kChunk][DP]
  float* vs = ks + kChunk * DP;      // [kChunk][D]
  float* qs = vs + kChunk * D;       // [G][D]
  float* ss = qs + G * D;            // [G][kChunk] scores, then p
  float* m_s = ss + G * kChunk;      // [G] running max
  float* l_s = m_s + G;              // [G] running sum
  float* a_s = l_s + G;              // [G] this chunk's rescale

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long qoff = ((long long)b * Hkv + hk) * G * D;  // G rows of D
  for (int e = tid; e < G * D; e += kThreads) qs[e] = widen(q[qoff + e]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) acc[k] = 0.f;

  const int len = lengths[b];
  const int total = n_pages * page;
  const int n_tok = len > 0 ? min(len, total) : total;
  const int* bt = block_table + (long long)b * n_pages;
  const long long tok_stride = (long long)Hkv * D;
  const long long head_off = (long long)hk * D;
  __syncthreads();

  for (int t0 = 0; t0 < n_tok; t0 += kChunk) {
    const int nt = min(kChunk, n_tok - t0);
    // where this chunk's rows lie: through the block table, once per row
    if (tid < nt) {
      const int t = t0 + tid;
      const int pid = min(max(bt[t / page], 0), P - 1);
      row[tid] = ((long long)pid * page + t % page) * tok_stride + head_off;
    }
    __syncthreads();
    // the rows' K and V, read in place as 16-byte vectors
    constexpr int N = Vec<T>::N;
    const int vpr = D / N;  // vectors per row
#pragma unroll 4
    for (int e = tid; e < kChunk * vpr; e += kThreads) {
      const int c = e / vpr, i = (e - c * vpr) * N;
      float kx[N], vx[N];
      if (c < nt) {
        const long long off = row[c] + i;
        unpack(*reinterpret_cast<const uint4*>(kp + off), kx, T());
        unpack(*reinterpret_cast<const uint4*>(vp + off), vx, T());
      } else {
#pragma unroll
        for (int u = 0; u < N; ++u) kx[u] = vx[u] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < N; ++u) {
        ks[c * DP + i + u] = kx[u];
        vs[c * D + i + u] = vx[u];
      }
    }
    __syncthreads();
    // scores: one thread per (query row, position)
    for (int e = tid; e < G * kChunk; e += kThreads) {
      const int g = e / kChunk, c = e - g * kChunk;
      float s = kNegInf;
      if (c < nt && t0 + c < len) {
        const float* qr = qs + g * D;
        const float* kr = ks + c * DP;
        float dot = 0.f;
        for (int x = 0; x < D; ++x) dot = fmaf(qr[x], kr[x], dot);
        s = __fdiv_rn(dot, sqrt_d);
      }
      ss[e] = s;
    }
    __syncthreads();
    // the online-softmax step: one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      float* sr = ss + g * kChunk;
      float mx = kNegInf;
      for (int c = lane; c < nt; c += 32) mx = fmaxf(mx, sr[c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < kChunk; c += 32) {
        // positions past the chunk's end are not in the table: p = 0
        const float p = c < nt ? expf(sr[c] - m_new) : 0.f;
        sr[c] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = __fadd_rn(__fmul_rn(alpha, l_s[g]), sum);
        a_s[g] = alpha;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc = alpha acc + p v, for this thread's (query row, column) elements
#pragma unroll
    for (int k = 0; k < kMaxAcc; ++k) {
      const int e = tid + k * kThreads;
      if (e < G * D) {
        const int g = e / D, j = e - g * D;
        const float* pr = ss + g * kChunk;
        float pv = 0.f;
        for (int c = 0; c < nt; ++c) pv = fmaf(pr[c], vs[c * D + j], pv);
        acc[k] = fmaf(acc[k], a_s[g], pv);
      }
    }
    __syncthreads();  // ks, vs, ss and a_s are refilled by the next chunk
  }

#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) {
    const int e = tid + k * kThreads;
    if (e < G * D) narrow(out + qoff + e, acc[k] / fmaxf(l_s[e / D], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* bt,
           const void* lengths, void* out, int B, int Hkv, int G, int D,
           int P, int page, int n_pages, float sqrt_d, cudaStream_t stream) {
  const size_t bytes = smem_bytes(G, D);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)Hkv, (unsigned)B);
  paged_attention_kernel<T><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (const int*)bt,
      (const int*)lengths, (T*)out, P, page, Hkv, G, D, n_pages, sqrt_d);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (B, Hq, D); k_pages, v_pages: (P, page, Hkv, D); block_table:
// (B, n_pages) int32; lengths: (B,) int32; all contiguous, q and the pages
// of one type (dtype 0: float32, 1: bfloat16), the pages 16-byte aligned.
// Hq a multiple of Hkv, D a multiple of 8 and <= 256, (Hq / Hkv) * D <=
// 4096, B <= 65535.  sqrt_d is sqrt(D) as a
// float.  Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int rimms_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* block_table,
                                     const void* lengths, void* out, int B,
                                     int Hq, int Hkv, int D, int P, int page,
                                     int n_pages, int dtype, float sqrt_d,
                                     void* stream) {
  if (B < 0 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || D < 8 || D % 8 != 0 ||
      D > kMaxD ||
      (Hq / Hkv) * D > kMaxAcc * kThreads || P < 1 || page < 1 ||
      n_pages < 0 || B > 65535 || ((size_t)k_pages | (size_t)v_pages) % 16)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int G = Hq / Hkv;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, block_table, lengths, out, B,
                         Hkv, G, D, P, page, n_pages, sqrt_d, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, block_table, lengths,
                                 out, B, Hkv, G, D, P, page, n_pages, sqrt_d,
                                 st);
  return (int)cudaErrorInvalidValue;
}
