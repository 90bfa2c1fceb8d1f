// Online-softmax ("flash") attention, causal or not, with grouped K/V heads,
// over float32 or bfloat16, for Hopper (sm_90a).
//
// Replaces the Pallas kernel
// src/repro/kernels/flash_attention/flash_attention.py::_flash_kernel
// (launched by flash_attention_bh, behind flash_attention/ops.py, which
// repeats K/V for GQA).  For each query row, over key tiles of block_k
// columns in order:
//     s = (q . k) * scale, masked to -1e30 above the diagonal when causal
//     m' = max(m, max s);  p = exp(s - m');  alpha = exp(m - m')
//     l = alpha l + sum p;  acc = alpha acc + p v;  m = m'
// and at the end out = acc / max(l, 1e-30), in the input type.
//
// What bounds it on the H100: 4 S^2 d flops per head (half of that when
// causal) against 4 S d elements moved, so at any sequence the kernel
// should be bound by operations; this first version runs them as float32
// fused multiply-adds on the CUDA cores (67 TFLOP/s peak), not on the
// tensor cores, so it cannot reach the bf16 or TF32 tensor-core bound.
// Design: one thread block per (batch*head, tile of block_q query rows),
// walking its tile in sub-tiles of 64 rows.  A sub-tile's queries, one
// 64-row chunk of K (then of V) and the sub-tile's scores for one key tile
// sit in shared memory, as float32 (bf16 is widened on load); each of the
// 128 threads holds a 4 x 8 block of scores and a 4 x d/8 block of the
// accumulator in registers.  The running max, sum and rescale factor per
// row stay in shared memory.  K/V rows are read at head h / (Hq / Hkv) in
// place: no repeated copy of K/V exists.  Key columns at or past S are
// never read or summed (the ragged last tile is narrower), and causal
// sub-tiles stop at the last key their rows can see.
// Bit identity across block_q: every query row sees the same key tiles of
// block_k columns, reduced in the same order by the same threads of a row,
// whatever block_q is; block_q only moves rows between blocks and
// sub-tiles.  A key tile past a row's diagonal that a sub-tile still visits
// leaves that row's m, l and acc bit-unchanged (p = 0, alpha = 1), since
// tile 0 always gives the row a real maximum first.  -1e30 (not -inf) and
// the 1e-30 floor are the reference's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 64;    // query rows per sub-tile
constexpr int kChunk = 64;   // key (or value) rows per shared-memory chunk
constexpr int kMaxBlockK = 512;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_floats_fixed() {
  return (size_t)(kRows + kChunk) * (D + 1) + 3 * kRows;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int Hq, int Hkv, int block_q, int block_k, int causal,
                       float scale) {
  constexpr int DP = D + 1;     // padded row: conflict-free column reads
  constexpr int DJ = D / 8;     // accumulator columns per thread
  extern __shared__ float smem[];
  const int bkp = block_k + 1;
  float* qs = smem;                    // [kRows][DP]
  float* kv = qs + kRows * DP;         // [kChunk][DP]   K, then V, chunk
  float* m_s = kv + kChunk * DP;       // [kRows] running max
  float* l_s = m_s + kRows;            // [kRows] running sum
  float* a_s = l_s + kRows;            // [kRows] this tile's rescale
  float* ss = a_s + kRows;             // [kRows][bkp] scores, then p

  const int tid = threadIdx.x;
  const int cg = tid % 8;   // column group: columns cg + 8 j
  const int rg = tid / 8;   // row group: rows rg + 16 i
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const long long q_pos = (long long)Hq * D;   // stride between positions
  const long long kv_pos = (long long)Hkv * D;
  const T* qb = q + (long long)b * S * q_pos + (long long)h * D;
  T* ob = out + (long long)b * S * q_pos + (long long)h * D;
  const T* kb = k + (long long)b * S * kv_pos + (long long)hk * D;
  const T* vb = v + (long long)b * S * kv_pos + (long long)hk * D;

  const int tile0 = blockIdx.x * block_q;
  const int tile1 = min(tile0 + block_q, S);
  for (int r0 = tile0; r0 < tile1; r0 += kRows) {
    const int nrows = min(kRows, tile1 - r0);
    for (int e = tid; e < kRows * D; e += kThreads) {
      const int r = e / D, i = e % D;
      qs[r * DP + i] =
          r < nrows ? widen(qb[(long long)(r0 + r) * q_pos + i]) : 0.f;
    }
    if (tid < kRows) {
      m_s[tid] = kNegInf;
      l_s[tid] = 0.f;
    }
    float acc[4][DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
    __syncthreads();

    // keys the sub-tile's rows can see: k <= r0 + nrows - 1 when causal
    const int k_end = causal ? min(S, r0 + nrows) : S;
    for (int k0 = 0; k0 < k_end; k0 += block_k) {
      const int ncols = min(block_k, S - k0);
      // scores of this key tile, chunk by chunk of K
      for (int c0 = 0; c0 < ncols; c0 += kChunk) {
        const int nc = min(kChunk, ncols - c0);
        for (int e = tid; e < kChunk * D; e += kThreads) {
          const int c = e / D, i = e % D;
          kv[c * DP + i] =
              c < nc ? widen(kb[(long long)(k0 + c0 + c) * kv_pos + i]) : 0.f;
        }
        __syncthreads();
        float sc[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
#pragma unroll 4
        for (int x = 0; x < D; ++x) {
          float qv[4], kx[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) qv[i] = qs[(rg + 16 * i) * DP + x];
#pragma unroll
          for (int j = 0; j < 8; ++j) kx[j] = kv[(cg + 8 * j) * DP + x];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(qv[i], kx[j], sc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rg + 16 * i;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = cg + 8 * j;
            if (c < nc) {
              float s = __fmul_rn(sc[i][j], scale);
              if (causal && k0 + c0 + c > r0 + r) s = kNegInf;
              ss[r * bkp + c0 + c] = s;
            }
          }
        }
        __syncthreads();
      }
      // online softmax: warp w owns rows w, w + 4, ...
      for (int r = warp; r < kRows; r += kThreads / 32) {
        float* row = ss + r * bkp;
        float mx = kNegInf;
        for (int c = lane; c < ncols; c += 32) mx = fmaxf(mx, row[c]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int c = lane; c < ncols; c += 32) {
          const float p = expf(__fsub_rn(row[c], m_new));
          row[c] = p;
          sum = __fadd_rn(sum, p);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
        if (lane == 0) {
          const float alpha = expf(__fsub_rn(m_prev, m_new));
          a_s[r] = alpha;
          l_s[r] = __fadd_rn(__fmul_rn(alpha, l_s[r]), sum);
          m_s[r] = m_new;
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float alpha = a_s[rg + 16 * i];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = __fmul_rn(acc[i][j], alpha);
      }
      // acc += p @ v, chunk by chunk of V
      for (int c0 = 0; c0 < ncols; c0 += kChunk) {
        const int nc = min(kChunk, ncols - c0);
        for (int e = tid; e < kChunk * D; e += kThreads) {
          const int c = e / D, i = e % D;
          kv[c * DP + i] =
              c < nc ? widen(vb[(long long)(k0 + c0 + c) * kv_pos + i]) : 0.f;
        }
        __syncthreads();
        for (int c = 0; c < nc; ++c) {
          float p[4], vx[DJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) p[i] = ss[(rg + 16 * i) * bkp + c0 + c];
#pragma unroll
          for (int j = 0; j < DJ; ++j) vx[j] = kv[c * DP + cg + 8 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], vx[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 16 * i;
      if (r < nrows) {
        const float l = fmaxf(l_s[r], 1e-30f);
        T* dst = ob + (long long)(r0 + r) * q_pos;
#pragma unroll
        for (int j = 0; j < DJ; ++j) narrow(dst + cg + 8 * j, acc[i][j] / l);
      }
    }
    __syncthreads();  // qs, m_s, l_s are refilled by the next sub-tile
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Hq, int Hkv, int causal, int block_q, int block_k,
           float scale, cudaStream_t stream) {
  const size_t bytes =
      (smem_floats_fixed<D>() + (size_t)kRows * (block_k + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + block_q - 1) / block_q),
                  (unsigned)(B * Hq));
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, Hq, Hkv, block_q,
      block_k, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (B, S, Hq, D); k, v: (B, S, Hkv, D); all contiguous, of one type
// (dtype 0: float32, 1: bfloat16); D 64 or 128; Hq a multiple of Hkv;
// 1 <= block_k <= 512 (block_k <= S).  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int rimms_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int S,
                                     int Hq, int Hkv, int D, int dtype,
                                     int causal, int block_q, int block_k,
                                     float scale, void* stream) {
  if (B < 0 || S < 0 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      block_q < 1 || block_k < 1 || block_k > kMaxBlockK ||
      (long long)B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, out, B, S, Hq, Hkv, causal, block_q,
                             block_k, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, out, B, S, Hq, Hkv, causal, block_q,
                              block_k, scale, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, B, S, Hq, Hkv, causal,
                                     block_q, block_k, scale, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, B, S, Hq, Hkv, causal,
                                      block_q, block_k, scale, st);
  return (int)cudaErrorInvalidValue;
}
