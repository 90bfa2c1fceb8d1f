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
// What bounds it on the H100: per chunk about 2 c^2 m + 4 c m^2 flops of
// matrix products against 4 c m elements moved, so at xLSTM widths
// (m = 512) it is bound by operations, and only the tensor cores bring
// that bound near the bytes'.  The recurrence over chunks is serial, so
// what is not serial is taken out of it.  Two launches:
//  1. mlstm_intra_kernel, one block per (head, chunk), all in parallel:
//     the chunk's c x c scores Q K^T (depth m), once per chunk; the gates'
//     cumulative sum by a warp scan; the mask, decay and input gate give A
//     (kept in shared memory); then A V (c x m) and A's row sums, written
//     to a workspace with exp(cum), w and exp(cum_last).
//  2. mlstm_inter_kernel, one block per (16 columns of C, head), walking
//     the chunks in order with its m x 16 columns of C (and its own copy
//     of n) in shared memory.  A step takes a 32-row slice of m: warps 4-7
//     accumulate q C[slice, cols] and q . n[slice] for the chunk's rows,
//     while warps 0-3 apply the previous step's slice of the update
//     C[slice, cols] = f C + k^T (w v)[:, cols] and n's (v's columns are
//     scaled by w once, as a chunk starts), so a step needs one barrier
//     and nothing waits on a slice it is not using (a chunk takes at least
//     two steps, so a slice's update lands before the next chunk reads
//     it).  At a chunk's first step warps 4-7 write the previous chunk's
//     h = (A V + exp(cum) q C) / max(|den + exp(cum) q.n|, 1).  C is kept
//     transposed.  q and k slices (and at a chunk's start its v columns
//     and gate vectors) stream in by cp.async one step ahead, into rings
//     of shared memory, 16 bytes a copy when rows are 16-byte aligned.
//     Only C's columns are split, so no block needs another's result.
//     Under grad (mlstm_bwd.cu), warps 4-7 also write each slice of the
//     state entering a chunk as they read it, and column tile 0 den.
//     When asked for the final state, the block applies the last chunk's
//     last slice of the update after the loop (h never needs it) and
//     writes its 16 columns of C, in the reference's orientation
//     C[a, e] = sum w k_a v_e, and column tile 0 writes n.
//     What holds it back on the H100 (PERF.md): each block copies the
//     head's whole q and k through shared memory, and issuing those
//     copies, not the products, sets the time of a step.
// Arithmetic: every matrix product (the scores, A V, q C and the C update)
// runs as mma.sync.m16n8k8 on TF32 operands in split form ("3xTF32": x =
// hi + lo with hi = x cut to TF32 and lo = x - hi, and a b = hi_a hi_b +
// (lo_a hi_b + hi_a lo_b), the two sums accumulated apart in float32),
// within 2^-18 of a float32 product: plain TF32 (10-bit mantissa) put
// errors of 1.1e-3 (the scores) and 1.4e-3 (A V) into h at xLSTM's
// width on the card (chip_smoke.py phase 3), more than half the 2e-3
// tolerance.  q is scaled by 1/sqrt(m) as an operand is formed.
// Everything else is float32 on the CUDA cores.  Chunk sizes change the
// order of accumulation, so different chunks are not bit-identical (as in
// the reference).  c is at most 128 (padded to a multiple of 16 with
// zeros), m at most 1024.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kSlice = 32;     // depth slice streamed through shared memory
constexpr int kCols = 16;      // columns of C per block of the inter pass
constexpr int kMaxChunk = 128;
constexpr int kMaxSmem = 232448;
// row strides (floats) chosen so fragment loads are free of bank
// conflicts: rows read two adjacent floats a lane (A, n-major B: == 8 mod
// 32), rows read one float a lane at k-rows 2 t4 and 2 t4 + 1 (transposed
// A, k-major B: == 4 mod 16)
constexpr int kQ = kSlice + 8;
constexpr int kK = kSlice + 4;
constexpr int kV = kCols + 4;
// a chunk's gate vectors in shared memory: exp(cum), w, den, decay
constexpr int kVecPad = 4 * kMaxChunk;

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

// Rows t < nrows, w floats each (a multiple of V), of a (c x valid)
// region at src (row stride pos) into dst (row stride ld); zeros outside.
template <int V>
__device__ __forceinline__ void copy_tile(float* dst, int ld, const float* src,
                                          long long pos, int nrows, int w,
                                          int c, int valid) {
  const int per_row = w / V;
  for (int e = threadIdx.x; e < nrows * per_row; e += kThreads) {
    const int t = e / per_row, i = (e % per_row) * V;
    const bool in = t < c && i < valid;
    cp_async<V>(dst + t * ld + i, in ? src + t * pos + i : src, in);
  }
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

size_t intra_smem_floats(int cp) {
  return 4 * (size_t)cp * kQ + (size_t)cp * (cp + 8) + 2 * kMaxChunk;
}

size_t inter_smem_floats(int mp, int cp) {
  return (size_t)kCols * (mp + 8) + mp + 2 * (size_t)cp * kQ +
         3 * (size_t)cp * kK + 2 * (size_t)cp * kV + 2 * kVecPad +
         2 * kMaxChunk;
}

// ---------------------------------------------------------------- pass 1
// Steps 0..nm-1 stream q and k slices (scores), steps nm..2nm-1 v slices
// (A V), each one step ahead through a two-stage ring.
template <int V>
__global__ void __launch_bounds__(kThreads)
mlstm_intra_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ ig,
                   const float* __restrict__ lf, float* __restrict__ ni,
                   float* __restrict__ vec, int S, int H, int M, int c,
                   float inv_sqrt_m) {
  extern __shared__ float smem[];
  const int cp = (c + 15) & ~15, ap = cp + 8;
  float* ring = smem;                  // [2 stages][2][cp][kQ] q|v, k
  float* as = ring + 4 * cp * kQ;      // [cp][ap]  A
  float* cum = as + cp * ap;           // [kMaxChunk] cumsum of log_f
  float* is = cum + kMaxChunk;         // [kMaxChunk] input gate
  __shared__ float wsum[kMaxChunk / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int j = blockIdx.x, nc = gridDim.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int nm = (M + kSlice - 1) / kSlice;
  const long long pos = (long long)H * M;
  const long long row0 = (long long)b * S + (long long)j * c;
  const long long base = row0 * pos + (long long)h * M;
  const float* igb = ig + row0 * H + h;
  const float* lfb = lf + row0 * H + h;

  auto issue = [&](int st) {
    float* dst = ring + (st & 1) * 2 * cp * kQ;
    if (st < nm) {  // q and k columns 32 st.., row stride kQ
      const int i0 = st * kSlice;
      copy_tile<V>(dst, kQ, q + base + i0, pos, cp, kSlice, c, M - i0);
      copy_tile<V>(dst + cp * kQ, kQ, k + base + i0, pos, cp, kSlice, c,
                   M - i0);
    } else {  // v columns 32 (st - nm).., row stride kK
      const int i0 = (st - nm) * kSlice;
      copy_tile<V>(dst, kK, v + base + i0, pos, cp, kSlice, c, M - i0);
    }
    cp_async_commit();
  };

  // the gates: an inclusive scan of log_f by warps, then warp offsets
  if (tid < kMaxChunk) {
    float x = tid < c ? lfb[(long long)tid * H] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x = __fadd_rn(x, y);
    }
    if (lane == 31) wsum[warp] = x;
    cum[tid] = x;
    is[tid] = tid < c ? igb[(long long)tid * H] : 0.f;
  }
  issue(0);
  __syncthreads();
  if (tid < kMaxChunk) {
    float off = 0.f;
    for (int w = 0; w < warp; ++w) off = __fadd_rn(off, wsum[w]);
    cum[tid] = __fadd_rn(cum[tid], off);
  }

  // warp w owns rows 16w..16w+15: for the scores, the column tiles of 8
  // that reach the diagonal
  const bool active = 16 * warp < cp;
  const int ntiles = min(2 * warp + 2, cp / 8);
  float acc[kMaxChunk / 8][4];
#pragma unroll
  for (int nt = 0; nt < kMaxChunk / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int st = 0; st < 2 * nm; ++st) {
    cp_async_wait_all();
    __syncthreads();
    if (st + 1 < 2 * nm) issue(st + 1);
    const float* qs = ring + (st & 1) * 2 * cp * kQ;
    const float* ks = qs + cp * kQ;
    if (st < nm) {
      if (active) {
#pragma unroll
        for (int kk = 0; kk < kSlice / 8; ++kk) {
          float x[4];
          load_a(x, qs + 16 * warp * kQ + 8 * kk, kQ, g, t4, inv_sqrt_m);
          const Split<4> a(x);
#pragma unroll
          for (int nt = 0; nt < kMaxChunk / 8; ++nt) {
            if (nt < ntiles) {
              const float2 kr =
                  *(const float2*)(ks + (8 * nt + g) * kQ + 8 * kk + 2 * t4);
              float* d = acc[nt];
              mma3(d, d, a, kr.x, kr.y);
            }
          }
        }
      }
      continue;
    }
    if (st == nm) {
      // A = mask(scores exp(cum_t - cum_s) i_s) into shared memory, its
      // row sums and the gate vectors into the workspace
      float* vb = vec + ((long long)bh * nc + j) * (3 * c + 1);
      if (active) {
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int nt = 0; nt < kMaxChunk / 8; ++nt) {
          if (nt < cp / 8) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int t = 16 * warp + g + (e >> 1) * 8;
              const int s = 8 * nt + 2 * t4 + (e & 1);
              float val = 0.f;
              if (nt < ntiles && s <= t && t < c)
                val = __fmul_rn(
                    __fmul_rn(acc[nt][e], expf(__fsub_rn(cum[t], cum[s]))),
                    is[s]);
              as[t * ap + s] = val;
              rs[e >> 1] = __fadd_rn(rs[e >> 1], val);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rs[r] = __fadd_rn(rs[r], __shfl_xor_sync(0xffffffffu, rs[r], 1));
          rs[r] = __fadd_rn(rs[r], __shfl_xor_sync(0xffffffffu, rs[r], 2));
          const int t = 16 * warp + g + 8 * r;
          if (t4 == 0 && t < c) vb[2 * c + t] = rs[r];
        }
      }
      if (tid < c) {
        vb[tid] = expf(cum[tid]);
        vb[c + tid] = __fmul_rn(expf(__fsub_rn(cum[c - 1], cum[tid])), is[tid]);
      }
      if (tid == 0) vb[3 * c] = expf(cum[c - 1]);
      __syncthreads();
    }
    // A V for columns 32 (st - nm).. of v
    if (active) {
      const int i0 = (st - nm) * kSlice;
      float vm[kSlice / 8][4], vc[kSlice / 8][4];
#pragma unroll
      for (int nt = 0; nt < kSlice / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) vm[nt][e] = vc[nt][e] = 0.f;
      for (int kk = 0; kk < ntiles; ++kk) {  // s <= t: up to the diagonal
        float x[4];
        load_a(x, as + 16 * warp * ap + 8 * kk, ap, g, t4);
        const Split<4> a(x);
        const float* vr = qs + (8 * kk + 2 * t4) * kK + g;
#pragma unroll
        for (int nt = 0; nt < kSlice / 8; ++nt)
          mma3(vm[nt], vc[nt], a, vr[8 * nt], vr[kK + 8 * nt]);
      }
#pragma unroll
      for (int nt = 0; nt < kSlice / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 16 * warp + g + (e >> 1) * 8;
          const int i = i0 + 8 * nt + 2 * t4 + (e & 1);
          if (t < c && i < M)
            ni[base + (long long)t * pos + i] =
                __fadd_rn(vm[nt][e], vc[nt][e]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- pass 2
template <int V>
__global__ void __launch_bounds__(kThreads)
mlstm_inter_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ ni,
                   const float* __restrict__ vec, float* __restrict__ out,
                   float* __restrict__ c_out, float* __restrict__ n_out,
                   float* __restrict__ c_in, float* __restrict__ n_in,
                   float* __restrict__ den_out, int S, int H, int M, int c,
                   float inv_sqrt_m) {
  extern __shared__ float smem[];
  const int cp = (c + 15) & ~15;
  const int nm = (M + kSlice - 1) / kSlice;  // slices of m
  const int nz = max(nm, 2);                 // steps a chunk
  const int mp = nm * kSlice;
  const int ldc = mp + 8;
  float* ct = smem;                 // [kCols][ldc]   this block's columns of C,
                                    //                transposed
  float* ns = ct + kCols * ldc;     // [mp]           normalizer n
  float* qst = ns + mp;             // [2][cp][kQ]    ring of q slices
  float* kst = qst + 2 * cp * kQ;   // [3][cp][kK]    ring of k slices
  float* vst = kst + 3 * cp * kK;   // [2][cp][kV]    w v columns, by chunk
  float* vecs = vst + 2 * cp * kV;  // [2][kVecPad]   exp(cum), w, den, decay
  float* qn = vecs + 2 * kVecPad;   // [2][kMaxChunk] q . n, by chunk

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int e0 = blockIdx.x * kCols;
  const int nc = S / c, nsteps = nc * nz;
  const long long pos = (long long)H * M;
  const long long head = (long long)b * S * pos + (long long)h * M;

  auto issue = [&](int st) {
    const int j = st / nz, z = st % nz;
    const long long rows = head + (long long)j * c * pos;
    if (z < nm) {
      const int i0 = z * kSlice;
      copy_tile<V>(qst + (st & 1) * cp * kQ, kQ, q + rows + i0, pos, cp,
                   kSlice, c, M - i0);
      copy_tile<V>(kst + (st % 3) * cp * kK, kK, k + rows + i0, pos, cp,
                   kSlice, c, M - i0);
    }
    if (z == 0) {
      copy_tile<V>(vst + (j & 1) * cp * kV, kV, v + rows + e0, pos, cp,
                   kCols, c, M - e0);
      const float* vb = vec + ((long long)bh * nc + j) * (3 * c + 1);
      for (int e = tid; e < kVecPad; e += kThreads) {
        const int part = e / kMaxChunk, t = e % kMaxChunk;
        const bool in = part < 3 ? t < c : t == 0;
        cp_async<1>(vecs + (j & 1) * kVecPad + e,
                    vb + (in ? part * c + t : 0), in);
      }
    }
    cp_async_commit();
  };

  for (int e = tid; e < kCols * ldc; e += kThreads) ct[e] = 0.f;
  for (int e = tid; e < mp; e += kThreads) ns[e] = 0.f;
  for (int e = tid; e < 2 * kMaxChunk; e += kThreads) qn[e] = 0.f;
  issue(0);

  // warps 4-7: row tiles w, w + 4 of the c x 16 outputs with both column
  // tiles (task u: row tile w + 4 (u / 2), column tile u % 2), q C in
  // split sums, and the A V values of their outputs (from pass 1)
  const int w4 = warp - 4, nrt = cp / 16;
  float pm[4][4], pc[4][4], av[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) pm[u][e] = pc[u][e] = av[u][e] = 0.f;

  // h of chunk j from the accumulators (warps 4-7)
  auto emit = [&](int j) {
    const float* vd = vecs + (j & 1) * kVecPad;
    const float* qnj = qn + (j & 1) * kMaxChunk;
    const long long rows = head + (long long)j * c * pos;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int rt = w4 + 4 * (u >> 1), nt = u & 1;
      if (rt >= nrt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 16 * rt + g + (e >> 1) * 8;
        const int col = 8 * nt + 2 * t4 + (e & 1);
        if (t < c && e0 + col < M) {
          const float ec = vd[t];
          const float qc = __fadd_rn(pm[u][e], pc[u][e]);
          const float num = __fadd_rn(av[u][e], __fmul_rn(ec, qc));
          const float den = __fadd_rn(vd[2 * kMaxChunk + t],
                                      __fmul_rn(ec, qnj[t]));
          if (den_out != nullptr && blockIdx.x == 0 && col == 0)
            den_out[(long long)bh * S + (long long)j * c + t] = den;
          out[rows + (long long)t * pos + e0 + col] =
              __fdiv_rn(num, fmaxf(fabsf(den), 1.f));
        }
        pm[u][e] = pc[u][e] = 0.f;
      }
    }
  };

  // warps 0-3: step sp's slice of the C and n updates
  auto update = [&](int sp) {
    const int jp = sp / nz, zp = sp % nz;
    const float* ks = kst + (sp % 3) * cp * kK;
    const float* vs = vst + (jp & 1) * cp * kV;
    const float* vd = vecs + (jp & 1) * kVecPad;
    const float* w = vd + kMaxChunk;
    const float f = vd[3 * kMaxChunk];
    const int rt = warp >> 1, nt = warp & 1, i0 = 16 * rt;
    // k^T (w v) over the chunk in 8-row steps, even and odd steps in
    // separate sums
    float um[2][4] = {}, uc[2][4] = {};
    for (int s0 = 0; s0 < cp; s0 += 16) {
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        const int s1 = s0 + 8 * par;
        const float* k0 = ks + (s1 + 2 * t4) * kK + i0 + g;
        const float x[4] = {k0[0], k0[8], k0[kK], k0[kK + 8]};
        const Split<4> a(x);
        const float* vr = vs + (s1 + 2 * t4) * kV + 8 * nt + g;
        mma3(um[par], uc[par], a, vr[0], vr[kV]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = zp * kSlice + i0 + g + (e >> 1) * 8;
      const int col = 8 * nt + 2 * t4 + (e & 1);
      const float upd = __fadd_rn(__fadd_rn(um[0][e], um[1][e]),
                                  __fadd_rn(uc[0][e], uc[1][e]));
      float* cell = ct + col * ldc + row;
      *cell = __fadd_rn(__fmul_rn(f, *cell), upd);
    }
    // n[slice]: eight columns a warp; lane p of a column takes rows
    // 2p, 2p + 1 of every 8
    const int col = 8 * warp + (lane & 7), p = lane >> 3;
    float ps[2] = {0.f, 0.f};
    for (int s0 = 2 * p; s0 < cp; s0 += 8) {
      ps[0] = __fadd_rn(ps[0], __fmul_rn(ks[s0 * kK + col], w[s0]));
      ps[1] = __fadd_rn(ps[1], __fmul_rn(ks[(s0 + 1) * kK + col],
                                         w[s0 + 1]));
    }
    float sum = __fadd_rn(ps[0], ps[1]);
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 8));
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 16));
    if (p == 0) {
      float* cell = ns + zp * kSlice + col;
      *cell = __fadd_rn(__fmul_rn(f, *cell), sum);
    }
  };

  for (int st = 0; st < nsteps; ++st) {
    const int j = st / nz, z = st % nz;
    cp_async_wait_all();
    __syncthreads();
    if (st + 1 < nsteps) issue(st + 1);
    if (warp >= 4) {
      if (z == 0) {
        if (j > 0) emit(j - 1);
        // this chunk's A V values, held until its h is written
        const long long rows = head + (long long)j * c * pos;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int rt = w4 + 4 * (u >> 1), nt = u & 1;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = 16 * rt + g + (e >> 1) * 8;
            const int col = 8 * nt + 2 * t4 + (e & 1);
            av[u][e] = rt < nrt && t < c && e0 + col < M
                           ? ni[rows + (long long)t * pos + e0 + col]
                           : 0.f;
          }
        }
      }
      if (z == 1)  // the buffer of chunk j + 1: emit(j - 1) has read it
        for (int t = tid - 128; t < kMaxChunk; t += 128)
          qn[((j + 1) & 1) * kMaxChunk + t] = 0.f;
      if (z < nm && c_in != nullptr) {
        // what the backward reads: slice z of the state entering chunk j
        // (its last update landed at an earlier step), C[a, e] = ct[e][a]
        float* cb = c_in + ((long long)bh * nc + j) * M * M;
        for (int e = tid - 128; e < kSlice * kCols; e += 128) {
          const int a = z * kSlice + e / kCols, col = e % kCols;
          if (a < M && e0 + col < M)
            cb[(long long)a * M + e0 + col] = ct[col * ldc + a];
        }
        if (blockIdx.x == 0 && tid - 128 < kSlice &&
            z * kSlice + tid - 128 < M)
          n_in[((long long)bh * nc + j) * M + z * kSlice + tid - 128] =
              ns[z * kSlice + tid - 128];
      }
      if (z < nm) {
        const float* qs = qst + (st & 1) * cp * kQ;
#pragma unroll
        for (int kk = 0; kk < kSlice / 8; ++kk) {
          // B[i][n] = C[i][n] = ct[n][i], column tiles n = g and g + 8
          const float* cr = ct + g * ldc + z * kSlice + 8 * kk + 2 * t4;
          const float2 r0 = *(const float2*)cr;
          const float2 r1 = *(const float2*)(cr + 8 * ldc);
          const float b0[2] = {r0.x, r0.y}, b1[2] = {r1.x, r1.y};
          const Split<2> c0(b0), c1(b1);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int rt = w4 + 4 * r;
            if (rt >= nrt) continue;
            float x[4];
            load_a(x, qs + 16 * rt * kQ + 8 * kk, kQ, g, t4, inv_sqrt_m);
            const Split<4> a(x);
            mma3(pm[2 * r], pc[2 * r], a, c0);
            mma3(pm[2 * r + 1], pc[2 * r + 1], a, c1);
          }
        }
        // q . n[slice], one row a thread in four sums, four columns a
        // load, each lane starting at its own quad (no bank conflicts)
        const int t = tid - 128;
        if (t < cp) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int r = 0; r < kSlice / 4; ++r) {
            const int i = 4 * ((r + t) & (kSlice / 4 - 1));
            const float4 qv = *(const float4*)(qs + t * kQ + i);
            const float4 nv = *(const float4*)(ns + z * kSlice + i);
            part[0] = fmaf(__fmul_rn(qv.x, inv_sqrt_m), nv.x, part[0]);
            part[1] = fmaf(__fmul_rn(qv.y, inv_sqrt_m), nv.y, part[1]);
            part[2] = fmaf(__fmul_rn(qv.z, inv_sqrt_m), nv.z, part[2]);
            part[3] = fmaf(__fmul_rn(qv.w, inv_sqrt_m), nv.w, part[3]);
          }
          float* cell = qn + (j & 1) * kMaxChunk + t;
          *cell = __fadd_rn(*cell, __fadd_rn(__fadd_rn(part[0], part[1]),
                                             __fadd_rn(part[2], part[3])));
        }
      }
    } else {
      if (st > 0 && (st - 1) % nz < nm) update(st - 1);
      if (z == 0) {
        // this chunk's v columns, arrived with this step: scaled by w once
        float* vs = vst + (j & 1) * cp * kV;
        const float* w = vecs + (j & 1) * kVecPad + kMaxChunk;
        for (int e = tid; e < cp * kCols; e += 128) {
          const int t = e / kCols, col = e % kCols;
          vs[t * kV + col] = __fmul_rn(w[t], vs[t * kV + col]);
        }
      }
    }
  }
  __syncthreads();
  if (warp >= 4) emit(nc - 1);
  if (c_out == nullptr) return;
  // the final state: the last step's slice of the update (if it had
  // one), then C's 16 columns and (column tile 0) n
  if (warp < 4 && (nsteps - 1) % nz < nm) update(nsteps - 1);
  __syncthreads();
  float* cb = c_out + (long long)bh * M * M;
  for (int e = tid; e < kCols * M; e += kThreads) {
    const int a = e / kCols, col = e % kCols;
    if (e0 + col < M) cb[(long long)a * M + e0 + col] = ct[col * ldc + a];
  }
  if (blockIdx.x == 0)
    for (int i = tid; i < M; i += kThreads)
      n_out[(long long)bh * M + i] = ns[i];
}

}  // namespace

// q, k, v, out: (B, S, H, M) float32, q unscaled; ig, lf: (B, S, H) float32;
// all contiguous, out distinct.  c_out (B, H, M, M) and n_out (B, H, M)
// float32: the state after the last token, C[a, e] = sum w k_a v_e; both
// null (not written) or neither.  c_in (B, H, S / chunk, M, M), n_in
// (B, H, S / chunk, M) and den (B, H, S) float32: what the backward
// (mlstm_bwd.cu) reads, each chunk's entering state and den before its
// clamp; all three null or none (out is the same bits either way).  work: a float32 workspace of
// B S H M + B H (S / chunk) (3 chunk + 1) elements (A V, then the gate
// vectors).  1 <= chunk <= 128 divides S; 1 <= M <= 1024.  Launches both
// passes on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes it does not take.
extern "C" int rimms_mlstm_f32(const void* q, const void* k, const void* v,
                               const void* ig, const void* lf, void* out,
                               void* c_out, void* n_out, void* c_in,
                               void* n_in, void* den, void* work, int B,
                               int S, int H, int M, int chunk,
                               float inv_sqrt_m, void* stream) {
  if (B < 0 || S < 0 || H < 1 || M < 1 || M > 1024 || chunk < 1 ||
      chunk > kMaxChunk || S % chunk != 0 || (long long)B * H > 65535 ||
      (c_out == nullptr) != (n_out == nullptr) ||
      (c_in == nullptr) != (n_in == nullptr) ||
      (c_in == nullptr) != (den == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const int cp = (chunk + 15) & ~15;
  const int nm = (M + kSlice - 1) / kSlice;
  const size_t intra = intra_smem_floats(cp) * sizeof(float);
  const size_t inter = inter_smem_floats(nm * kSlice, cp) * sizeof(float);
  if (inter > (size_t)kMaxSmem - 1024 || intra > (size_t)kMaxSmem - 1024)
    return (int)cudaErrorInvalidValue;
  const int nc = S / chunk;
  float* ni = (float*)work;
  float* vec = ni + (size_t)B * S * H * M;
  // 16-byte copies when every row of q, k and v starts 16-byte aligned
  const bool vec4 = M % 4 == 0 && ((uintptr_t)q | (uintptr_t)k |
                                   (uintptr_t)v) % 16 == 0;
  auto run = [&](auto intra_kernel, auto inter_kernel) {
    cudaError_t err = cudaSuccess;
    if (intra > 48 * 1024)
      err = cudaFuncSetAttribute(intra_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)intra);
    if (err == cudaSuccess && inter > 48 * 1024)
      err = cudaFuncSetAttribute(inter_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)inter);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = (cudaStream_t)stream;
    intra_kernel<<<dim3(nc, B * H), kThreads, intra, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)ig,
        (const float*)lf, ni, vec, S, H, M, chunk, inv_sqrt_m);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    inter_kernel<<<dim3((M + kCols - 1) / kCols, B * H), kThreads, inter,
                   st>>>((const float*)q, (const float*)k, (const float*)v,
                         ni, vec, (float*)out, (float*)c_out,
                         (float*)n_out, (float*)c_in, (float*)n_in,
                         (float*)den, S, H, M, chunk, inv_sqrt_m);
    return (int)cudaGetLastError();
  };
  return vec4 ? run(mlstm_intra_kernel<4>, mlstm_inter_kernel<4>)
              : run(mlstm_intra_kernel<1>, mlstm_inter_kernel<1>);
}
