// Chunkwise mLSTM (the xLSTM matrix-memory recurrence) over float32, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/mlstm/mlstm.py::_mlstm_kernel
// (launched by mlstm_chunkwise_bh, behind mlstm/ops.py, which scales q by
// 1/sqrt(m)).  Per head, over chunks of c tokens in order, with
// cum = cumsum(log_f) over the chunk:
//     A[t,s]  = (q_t . k_s) exp(cum_t - cum_s) i_s   for s <= t, else 0
//     num[t]  = sum_s A[t,s] v_s + exp(cum_t) (q_t C)
//     den[t]  = sum_s A[t,s]     + exp(cum_t) (q_t . n)
//     h_t     = num[t] / max(|den[t]|, 1)
//     C       = exp(cum_last) C + sum_s (k_s w_s) v_s^T,  w_s = exp(cum_last - cum_s) i_s
//     n       = exp(cum_last) n + sum_s k_s w_s
//
// What bounds it on the H100: per chunk about 2 c^2 m + 4 c m^2 flops
// against 4 c m elements moved, so at xLSTM widths (m = 512) it is bound by
// operations; this first version runs them as float32 fused multiply-adds
// from shared memory on the CUDA cores, far from any tensor-core bound.
// Design: the Pallas kernel keeps the m x m state C (1 MiB at m = 512) in
// VMEM; a Hopper block has at most 227 KB.  C's columns e depend only on
// v's columns e, so each block owns 16 columns of C for one head (m x 16
// floats in shared memory, 32 KB at m = 512) and carries them chunk by chunk,
// in order, inside the one launch.  Every block of a head recomputes the
// chunk's c x c scores and the normalizer n (m floats), which all columns
// need; q and k stream through shared memory in slices of 32 of m, so a
// chunk never has to fit whole.  c is at most 128.  Chunk sizes change the
// order of accumulation, so different chunks are not bit-identical (as in
// the reference).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 16;    // columns of C per block
constexpr int kSlice = 32;   // slice of m streamed through shared memory
constexpr int kMaxChunk = 128;
constexpr int kMaxSmem = 232448;

size_t smem_floats(int m, int c) {
  return (size_t)m * kCols + m + 2 * (size_t)c * (kSlice + 1) +
         (size_t)c * (c + 1) + 2 * (size_t)c * kCols + 6 * (size_t)c;
}

__global__ void __launch_bounds__(kThreads)
mlstm_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ ig,
             const float* __restrict__ lf, float* __restrict__ out, int S,
             int H, int M, int c, float sqrt_m) {
  constexpr int SP = kSlice + 1;
  extern __shared__ float smem[];
  const int cp = c + 1;
  float* cs = smem;                  // [M][kCols]  this block's columns of C
  float* ns = cs + M * kCols;        // [M]         normalizer n
  float* qs = ns + M;                // [c][SP]     slice of q (scaled)
  float* ks = qs + c * SP;           // [c][SP]     slice of k (then k * w)
  float* sc = ks + c * SP;           // [c][cp]     scores, then A
  float* vs = sc + c * cp;           // [c][kCols]  v, this block's columns
  float* qc = vs + c * kCols;        // [c][kCols]  q @ C
  float* qn = qc + c * kCols;        // [c]         q . n
  float* den = qn + c;               // [c]
  float* cum = den + c;              // [c]         cumsum of log_f
  float* ecum = cum + c;             // [c]         exp(cum)
  float* ws = ecum + c;              // [c]         exp(cum_last - cum) i
  float* is = ws + c;                // [c]         input gate
  __shared__ float decay;            // exp(cum_last)

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int e0 = blockIdx.x * kCols;
  const int ne = min(kCols, M - e0);
  const long long pos = (long long)H * M;   // stride between positions
  const float* qb = q + (long long)b * S * pos + (long long)h * M;
  const float* kb = k + (long long)b * S * pos + (long long)h * M;
  const float* vb = v + (long long)b * S * pos + (long long)h * M + e0;
  float* ob = out + (long long)b * S * pos + (long long)h * M + e0;
  const float* igb = ig + (long long)b * S * H + h;
  const float* lfb = lf + (long long)b * S * H + h;

  for (int e = tid; e < M * kCols; e += kThreads) cs[e] = 0.f;
  for (int i = tid; i < M; i += kThreads) ns[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += c) {
    for (int t = tid; t < c; t += kThreads) {
      is[t] = igb[(long long)(t0 + t) * H];
      cum[t] = lfb[(long long)(t0 + t) * H];
    }
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int t = 0; t < c; ++t) {
        run = __fadd_rn(run, cum[t]);
        cum[t] = run;
      }
      decay = expf(run);
    }
    __syncthreads();
    for (int t = tid; t < c; t += kThreads) {
      ecum[t] = expf(cum[t]);
      ws[t] = __fmul_rn(expf(__fsub_rn(cum[c - 1], cum[t])), is[t]);
      qn[t] = 0.f;
    }
    for (int e = tid; e < c * cp; e += kThreads) sc[e] = 0.f;
    for (int e = tid; e < c * kCols; e += kThreads) qc[e] = 0.f;
    __syncthreads();

    // pass 1, slice by slice of m: scores, q @ C and q . n
    for (int i0 = 0; i0 < M; i0 += kSlice) {
      const int ni = min(kSlice, M - i0);
      for (int e = tid; e < c * kSlice; e += kThreads) {
        const int t = e / kSlice, i = e % kSlice;
        const long long g = (long long)(t0 + t) * pos + i0 + i;
        qs[t * SP + i] = i < ni ? __fdiv_rn(qb[g], sqrt_m) : 0.f;
        ks[t * SP + i] = i < ni ? kb[g] : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < c * c; e += kThreads) {
        const int t = e / c, s = e % c;
        if (s > t) continue;
        float acc = 0.f;
#pragma unroll 8
        for (int i = 0; i < kSlice; ++i)
          acc = fmaf(qs[t * SP + i], ks[s * SP + i], acc);
        sc[t * cp + s] = __fadd_rn(sc[t * cp + s], acc);
      }
      for (int e = tid; e < c * kCols; e += kThreads) {
        const int t = e / kCols, col = e % kCols;
        float acc = 0.f;
        for (int i = 0; i < ni; ++i)
          acc = fmaf(qs[t * SP + i], cs[(i0 + i) * kCols + col], acc);
        qc[e] = __fadd_rn(qc[e], acc);
      }
      for (int t = tid; t < c; t += kThreads) {
        float acc = 0.f;
        for (int i = 0; i < ni; ++i) acc = fmaf(qs[t * SP + i], ns[i0 + i], acc);
        qn[t] = __fadd_rn(qn[t], acc);
      }
      __syncthreads();
    }

    // A, and this block's columns of v
    for (int e = tid; e < c * c; e += kThreads) {
      const int t = e / c, s = e % c;
      float a = 0.f;
      if (s <= t)
        a = __fmul_rn(__fmul_rn(sc[t * cp + s],
                                expf(__fsub_rn(cum[t], cum[s]))),
                      is[s]);
      sc[t * cp + s] = a;
    }
    for (int e = tid; e < c * kCols; e += kThreads) {
      const int t = e / kCols, col = e % kCols;
      vs[e] = col < ne ? vb[(long long)(t0 + t) * pos + col] : 0.f;
    }
    __syncthreads();
    for (int t = tid; t < c; t += kThreads) {
      float rs = 0.f;
      for (int s = 0; s <= t; ++s) rs = __fadd_rn(rs, sc[t * cp + s]);
      den[t] = __fadd_rn(rs, __fmul_rn(ecum[t], qn[t]));
    }
    __syncthreads();
    for (int e = tid; e < c * kCols; e += kThreads) {
      const int t = e / kCols, col = e % kCols;
      if (col >= ne) continue;
      float acc = 0.f;
      for (int s = 0; s <= t; ++s)
        acc = fmaf(sc[t * cp + s], vs[s * kCols + col], acc);
      const float num = __fadd_rn(acc, __fmul_rn(ecum[t], qc[e]));
      ob[(long long)(t0 + t) * pos + col] = num / fmaxf(fabsf(den[t]), 1.f);
    }
    __syncthreads();

    // pass 2, slice by slice of m: carry C and n to the next chunk
    const float f = decay;
    for (int i0 = 0; i0 < M; i0 += kSlice) {
      const int ni = min(kSlice, M - i0);
      for (int e = tid; e < c * kSlice; e += kThreads) {
        const int t = e / kSlice, i = e % kSlice;
        ks[t * SP + i] =
            i < ni ? __fmul_rn(kb[(long long)(t0 + t) * pos + i0 + i], ws[t])
                   : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < ni * kCols; e += kThreads) {
        const int i = e / kCols, col = e % kCols;
        float acc = 0.f;
        for (int s = 0; s < c; ++s)
          acc = fmaf(ks[s * SP + i], vs[s * kCols + col], acc);
        float* cell = cs + (i0 + i) * kCols + col;
        *cell = __fadd_rn(__fmul_rn(f, *cell), acc);
      }
      for (int i = tid; i < ni; i += kThreads) {
        float acc = 0.f;
        for (int s = 0; s < c; ++s) acc = __fadd_rn(acc, ks[s * SP + i]);
        ns[i0 + i] = __fadd_rn(__fmul_rn(f, ns[i0 + i]), acc);
      }
      __syncthreads();
    }
  }
}

}  // namespace

// q, k, v, out: (B, S, H, M) float32, q unscaled; ig, lf: (B, S, H) float32;
// all contiguous, out distinct.  1 <= chunk <= 128 divides S.  Launches on
// `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes it does not take (M so large that 16
// columns of C and the chunk's buffers pass 227 KB of shared memory).
extern "C" int rimms_mlstm_f32(const void* q, const void* k, const void* v,
                               const void* ig, const void* lf, void* out,
                               int B, int S, int H, int M, int chunk,
                               float sqrt_m, void* stream) {
  if (B < 0 || S < 0 || H < 1 || M < 1 || chunk < 1 || chunk > kMaxChunk ||
      S % chunk != 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_floats(M, chunk) * sizeof(float);
  if (bytes > (size_t)kMaxSmem - 1024) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((M + kCols - 1) / kCols), (unsigned)(B * H));
  mlstm_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)ig,
      (const float*)lf, (float*)out, S, H, M, chunk, sqrt_m);
  return (int)cudaGetLastError();
}
