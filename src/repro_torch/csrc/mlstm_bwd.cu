// Backward of the chunkwise mLSTM (mlstm.cu) over float32, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package differentiates its plain XLA
// recurrence (src/repro/models/recurrent.py), so the gradient to match is
// autograd's through mlstm_plain; mlstm_backward_plain (kernels/mlstm/
// mlstm.py) is the same algorithm in torch ops and the arbiter.  Per head
// and chunk of c tokens, with q~ = q / sqrt(m), cum the chunk's cumulative
// log_f, D_ts = exp(cum_t - cum_s) for s <= t, A_ts = (q~_t . k_s) D_ts i_s,
// ecum_t = exp(cum_t), w_s = exp(cum_last - cum_s) i_s, decay =
// exp(cum_last), and (C_in, n_in) the state entering the chunk, the
// forward computed
//     num_t = sum_s A_ts v_s + ecum_t C_in^T q~_t,  den_t = sum_s A_ts +
//     ecum_t q~_t . n_in,  h_t = num_t / max(|den_t|, 1),
//     C_out = decay C_in + sum_s w_s k_s v_s^T,  n_out = decay n_in +
//     sum_s w_s k_s.
// Given dh (and the seeds dC, dn of the final state), with D_t =
// max(|den_t|, 1): dnum_t = dh_t / D_t, dden_t = -sgn(den_t) [|den_t| >= 1]
// (dh_t . h_t) / D_t, and per chunk, with (dC, dn) the gradient reaching
// C_out, n_out:
//     dA_ts = dnum_t . v_s + dden_t,  dS_ts = dA_ts D_ts i_s   (s <= t)
//     Z_t = C_in dnum_t + dden_t n_in,  Y_s = dC v_s + dn
//     dq~_t = sum_s dS_ts k_s + ecum_t Z_t
//     dk_s = sum_t dS_ts q~_t + w_s Y_s,  dv_s = sum_t A_ts dnum_t +
//     w_s dC^T k_s
//     di_s = sum_t dA_ts (q~_t . k_s) D_ts + (k_s . Y_s) exp(cum_last - cum_s)
//     dcum_t = sum_s dA_ts A_ts - sum_t' dA_t't A_t't + ecum_t q~_t . Z_t -
//     w_t k_t . Y_t, and dcum_last += sum_s w_s k_s . Y_s + decay (dC : C_in
//     + dn . n_in); dlog_f is dcum's reverse cumulative sum,
// and the gradient reaching the previous chunk's end state is
//     dC <- decay dC + sum_t ecum_t q~_t dnum_t^T,  dn <- decay dn +
//     sum_t ecum_t dden_t q~_t.
// The forward (mlstm.cu) writes C_in, n_in and den under grad.
//
// What bounds it on the H100: per chunk and head about 10 c^2 m + 8 c m^2
// flops (twice the forward's) against the inputs, h, dh, the saved states
// and the gradients moved once, so at xLSTM widths (m = 512) it is bound
// by operations.  This first design is simple and right, all float32 on
// the CUDA cores (no TF32: in the forward plain TF32 put 1.4e-3 into h),
// its products register-tiled through shared memory, in six launches:
//  1. mlstm_bwd_prep_kernel, one block per (chunk, head): cum by a serial
//     sum, and per token 1 / D_t and dden_t (dh . h by a warp each).
//  2. mlstm_bwd_update_kernel, one block per (128 x 32 tile of the m x m
//     state, chunk, head), all chunks at once: each chunk's own update
//     sum_t ecum_t q~_t dnum_t^T (and dn's), the only m x m x c products
//     the chunk walk needs.
//  3. mlstm_bwd_carry_kernel, one thread per element of the state and
//     head: the walk from the last chunk, G <- decay G + update, an
//     elementwise scan in place, the counterpart of the forward's second
//     pass (nothing else is serial).
//  4. mlstm_bwd_scores_kernel, one block per (chunk, head, 32 x 32 tile
//     of the c x c scores): q~ k^T and dnum v^T over m-slices of 32,
//     giving A, dS and dA S D (zeros above the diagonal) in a workspace.
//  5. mlstm_bwd_grads_kernel, one block per (chunk, head, 32 columns of
//     m): dq, dk, dv for its columns from those matrices (depth c) and
//     from C_in and dC (depth m), and its columns' shares of q~ . Z,
//     k . Y and dC : C_in.
//  6. mlstm_bwd_gates_kernel, one block per (chunk, head): sums the
//     shares, di and dcum, and dlog_f.
// Nothing is summed by atomics, so the bits do not change from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;  // tiles of rows, columns and depth
constexpr int kMaxChunk = 128;

struct Head {
  long long base, pos;  // q/k/v/h offset of (head, token 0), token stride
  long long gate;       // ig/lf offset of (head, token 0), token stride H
  int H;
  __device__ Head(int bh, int S, int H_, int M) : H(H_) {
    const int b = bh / H_, h = bh % H_;
    pos = (long long)H_ * M;
    base = (long long)b * S * pos + (long long)h * M;
    gate = (long long)b * S * H_ + h;
  }
  __device__ long long row(long long t) const { return base + t * pos; }
  __device__ long long g(long long t) const { return gate + t * H; }
};

// ---------------------------------------------------------------- 1. prep
// vec: [3][BH][S] = cum, 1 / D, dden
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_prep_kernel(const float* __restrict__ lf,
                      const float* __restrict__ den,
                      const float* __restrict__ h,
                      const float* __restrict__ dh, float* __restrict__ vec,
                      int S, int H, int M, int c) {
  const int j = blockIdx.x, bh = blockIdx.y;
  const Head hd(bh, S, H, M);
  const long long bhs = (long long)gridDim.y * S;
  const long long t0 = (long long)j * c, at = (long long)bh * S + t0;
  if (threadIdx.x == 0) {
    float x = 0.f;
    for (int t = 0; t < c; ++t) {
      x += lf[hd.g(t0 + t)];
      vec[at + t] = x;
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < c; t += kThreads / 32) {
    const long long row = hd.row(t0 + t);
    float s = 0.f;
    for (int a = lane; a < M; a += 32) s += dh[row + a] * h[row + a];
#pragma unroll
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      const float d = den[at + t], ad = fabsf(d), big = fmaxf(ad, 1.f);
      vec[bhs + at + t] = 1.f / big;
      vec[2 * bhs + at + t] = ad >= 1.f ? (d > 0.f ? -s : s) / big : 0.f;
    }
  }
}

// ------------------------------------------------------- register tiles
// A block's product C (rows x 32) += A (rows x K) B (K x 32) runs through
// shared memory 32 deep at a time: A's tile as [row][33], B's as [k][36]
// (16-byte rows for float4 reads).  Thread (rg = tid / 8, cg = tid % 8)
// holds rows rg + 32 u (u < U, so U = 4 covers 128 rows) and columns
// 4 cg .. 4 cg + 3: a step reads U floats of A and one float4 of B for
// 4 U multiply-adds, where one column a thread read two floats for one.
constexpr int kAs = kTile + 1;
constexpr int kBs = kTile + 4;

template <int U>
__device__ __forceinline__ void tile_fma(float (&acc)[U][4],
                                         const float* As, const float* Bs,
                                         int rg, int cg) {
#pragma unroll 8
  for (int kk = 0; kk < kTile; ++kk) {
    const float4 b = *(const float4*)(Bs + kk * kBs + 4 * cg);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float a = As[(rg + 32 * u) * kAs + kk];
      acc[u][0] += a * b.x;
      acc[u][1] += a * b.y;
      acc[u][2] += a * b.z;
      acc[u][3] += a * b.w;
    }
  }
}

template <int U>
__device__ __forceinline__ void tile_zero(float (&acc)[U][4]) {
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[u][x] = 0.f;
}

// the sum of v over the 8 threads that share a row (lanes differing in
// their low three bits)
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}

// ----------------------------------------------------------- 2. update
// U_j = sum_t (ecum_t q~_t) dnum_t^T (m x m) and u_j = sum_t ecum_t dden_t
// q~_t for chunks j >= 1, into the slot of chunk j - 1 of dc_out, dn_out
// (the carry pass turns them into the gradient reaching each chunk's end
// state).  One block per (128 rows a x 32 columns e, chunk, head).
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_update_kernel(const float* __restrict__ q,
                        const float* __restrict__ dh,
                        const float* __restrict__ vec,
                        float* __restrict__ dc_out, float* __restrict__ dn_out,
                        int S, int H, int M, int c, float inv_sqrt_m) {
  __shared__ __align__(16) float As[kMaxChunk * kAs];
  __shared__ __align__(16) float Bs[kTile * kBs];
  const int nsl = (M + kTile - 1) / kTile;
  const int a0 = (blockIdx.x / nsl) * kMaxChunk, e0 = (blockIdx.x % nsl) * kTile;
  const int j = blockIdx.y + 1, nc = S / c, bh = blockIdx.z;
  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;
  const Head hd(bh, S, H, M);
  const long long bhs = (long long)gridDim.z * S;
  const long long t0 = (long long)j * c, at = (long long)bh * S + t0;
  const float* cum = vec + at;
  const float* rinv = vec + bhs + at;
  const float* dden = vec + 2 * bhs + at;
  float acc[4][4];
  tile_zero(acc);
  float un = 0.f;  // thread tid < 128: u_j[a0 + tid]
  for (int k0 = 0; k0 < c; k0 += kTile) {
    __syncthreads();
    for (int e = tid; e < kTile * kMaxChunk; e += kThreads) {
      const int kk = e / kMaxChunk, r = e % kMaxChunk;  // along a
      const int t = k0 + kk;
      As[r * kAs + kk] = t < c && a0 + r < M
          ? expf(cum[t]) * q[hd.row(t0 + t) + a0 + r] * inv_sqrt_m
          : 0.f;
    }
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int kk = e / kTile, col = e % kTile, t = k0 + kk;
      Bs[kk * kBs + col] = t < c && e0 + col < M
          ? rinv[t] * dh[hd.row(t0 + t) + e0 + col]
          : 0.f;
    }
    __syncthreads();
    tile_fma(acc, As, Bs, rg, cg);
    if (e0 == 0 && tid < kMaxChunk)
      for (int kk = 0; kk < kTile && k0 + kk < c; ++kk)
        un += As[tid * kAs + kk] * dden[k0 + kk];
  }
  const long long slot = (long long)bh * nc + j - 1;
  float* dco = dc_out + slot * M * M;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int a = a0 + rg + 32 * u;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int col = e0 + 4 * cg + x;
      if (a < M && col < M) dco[(long long)a * M + col] = acc[u][x];
    }
  }
  if (e0 == 0 && tid < kMaxChunk && a0 + tid < M)
    dn_out[slot * M + a0 + tid] = un;
}

// ------------------------------------------------------------ 3. carry
// In place over dc_out, dn_out (one thread per element of the m x m + m
// state and head): the gradient reaching chunk j's end state,
// G_{nc-1} = seed, G_j = exp(cum_last of chunk j + 1) G_{j+1} + U_{j+1},
// where slot j held U_{j+1}.
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_carry_kernel(const float* __restrict__ vec,
                       const float* __restrict__ dc_seed,
                       const float* __restrict__ dn_seed,
                       float* __restrict__ dc_out, float* __restrict__ dn_out,
                       int S, int M, int c) {
  const int bh = blockIdx.y, nc = S / c;
  const long long mm = (long long)M * M;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= mm + M) return;
  const bool is_c = idx < mm;
  const float* seed = is_c ? dc_seed : dn_seed;
  float* buf = is_c ? dc_out + (long long)bh * nc * mm + idx
                    : dn_out + (long long)bh * nc * M + (idx - mm);
  const long long stride = is_c ? mm : M;
  const float* cum = vec + (long long)bh * S;
  float g = seed != nullptr ? seed[is_c ? bh * mm + idx
                                        : (long long)bh * M + idx - mm]
                            : 0.f;
  for (int j = nc - 1; j >= 0; --j) {
    float* cell = buf + j * stride;
    if (j < nc - 1)
      g = expf(cum[(long long)(j + 2) * c - 1]) * g + *cell;
    *cell = g;
  }
}

// -------------------------------------------------------------- 4. scores
// mats: [3][BH * nc][c][c] = A, dS, dA S D (the scores' S), zero for s > t
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_scores_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ ig,
                        const float* __restrict__ dh,
                        const float* __restrict__ vec,
                        float* __restrict__ mats, int S, int H, int M, int c,
                        float inv_sqrt_m) {
  __shared__ float qs[kTile][kTile + 1], gs[kTile][kTile + 1];
  __shared__ float ks[kTile][kTile + 1], vs[kTile][kTile + 1];
  __shared__ float cums[kMaxChunk], is[kMaxChunk], rs[kMaxChunk],
      dds[kMaxChunk];
  const int j = blockIdx.x, nc = gridDim.x, bh = blockIdx.y;
  const int tid = threadIdx.x;
  const Head hd(bh, S, H, M);
  const long long bhs = (long long)gridDim.y * S;
  const long long t0 = (long long)j * c, at = (long long)bh * S + t0;
  for (int t = tid; t < c; t += kThreads) {
    cums[t] = vec[at + t];
    rs[t] = vec[bhs + at + t];
    dds[t] = vec[2 * bhs + at + t];
    is[t] = ig[hd.g(t0 + t)];
  }
  const long long cc = (long long)c * c;
  const long long plane = (long long)gridDim.y * nc * cc;
  float* am = mats + ((long long)bh * nc + j) * cc;
  const int row = tid >> 3, cb = (tid & 7) * 4;
  const int nt = (c + kTile - 1) / kTile;
  const int ti = blockIdx.z / nt, si = blockIdx.z % nt;
  float sacc[4] = {0.f, 0.f, 0.f, 0.f}, dacc[4] = {0.f, 0.f, 0.f, 0.f};
  if (si <= ti) {
    for (int a0 = 0; a0 < M; a0 += kTile) {
      __syncthreads();
      for (int e = tid; e < kTile * kTile; e += kThreads) {
        const int r = e / kTile, i = e % kTile;
        const int tq = ti * kTile + r, ts = si * kTile + r;
        const bool in = a0 + i < M;
        const bool inq = in && tq < c, ins = in && ts < c;
        const long long rq = hd.row(t0 + tq) + a0 + i;
        const long long rk = hd.row(t0 + ts) + a0 + i;
        qs[r][i] = inq ? q[rq] * inv_sqrt_m : 0.f;
        gs[r][i] = inq ? dh[rq] * rs[tq] : 0.f;
        ks[r][i] = ins ? k[rk] : 0.f;
        vs[r][i] = ins ? v[rk] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int i = 0; i < kTile; ++i) {
        const float qv = qs[row][i], gvv = gs[row][i];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          sacc[u] += qv * ks[cb + u][i];
          dacc[u] += gvv * vs[cb + u][i];
        }
      }
    }
  }
  const int t = ti * kTile + row;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int s = si * kTile + cb + u;
    if (t < c && s < c) {
      float av = 0.f, dsv = 0.f, qv = 0.f;
      if (s <= t) {
        const float dm = expf(cums[t] - cums[s]);
        const float da = dacc[u] + dds[t];
        av = sacc[u] * dm * is[s];
        dsv = da * dm * is[s];
        qv = da * sacc[u] * dm;
      }
      am[(long long)t * c + s] = av;
      am[plane + (long long)t * c + s] = dsv;
      am[2 * plane + (long long)t * c + s] = qv;
    }
  }
}

// --------------------------------------------------------------- 5. grads
// parts: [BH * nc][nsl][2 c + 1] = shares of q~ . Z (c), k . Y (c) and
// dC : C_in + dn . n_in (1) over this block's 32 columns.  One block per
// (chunk, head, 32 columns of m); every product a register-tiled
// rows x 32 one (rows: the chunk's tokens, U 32-row groups).
template <int U>
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_grads_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ ig,
                       const float* __restrict__ dh,
                       const float* __restrict__ vec,
                       const float* __restrict__ mats,
                       const float* __restrict__ c_in,
                       const float* __restrict__ n_in,
                       const float* __restrict__ dc_out,
                       const float* __restrict__ dn_out,
                       float* __restrict__ dq, float* __restrict__ dk,
                       float* __restrict__ dv, float* __restrict__ parts,
                       int S, int H, int M, int c, float inv_sqrt_m) {
  __shared__ __align__(16) float As[kMaxChunk * kAs];
  __shared__ __align__(16) float Bs[kTile * kBs];
  __shared__ float cums[kMaxChunk], is[kMaxChunk], rs[kMaxChunk],
      dds[kMaxChunk];
  __shared__ float red[kThreads / 32];
  const int j = blockIdx.x, nc = gridDim.x, bh = blockIdx.y;
  const int sl = blockIdx.z, nsl = gridDim.z, a0 = sl * kTile;
  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;
  const Head hd(bh, S, H, M);
  const long long bhs = (long long)gridDim.y * S;
  const long long t0 = (long long)j * c, at = (long long)bh * S + t0;
  const long long cc = (long long)c * c, mm = (long long)M * M;
  const long long plane = (long long)gridDim.y * nc * cc;
  const long long chunk_id = (long long)bh * nc + j;
  const float* am = mats + chunk_id * cc;
  const float* dsm = am + plane;
  const float* cin = c_in + chunk_id * mm;
  const float* dco = dc_out + chunk_id * mm;
  const float* nin = n_in + chunk_id * M;
  const float* dno = dn_out + chunk_id * M;
  float* part = parts + (chunk_id * nsl + sl) * (2 * c + 1);
  for (int t = tid; t < c; t += kThreads) {
    cums[t] = vec[at + t];
    rs[t] = vec[bhs + at + t];
    dds[t] = vec[2 * bhs + at + t];
    is[t] = ig[hd.g(t0 + t)];
  }
  const float clast = vec[at + c - 1];
  const int rows = 32 * U;

  // A tiles (rows x 32 of K), rows past c zero:
  // a token-major tensor's features k0.. (times rs[t] when scale)
  auto a_tokens = [&](const float* x, int k0, bool scale) {
    for (int e = tid; e < rows * kTile; e += kThreads) {
      const int r = e / kTile, kk = e % kTile;
      As[r * kAs + kk] = r < c && k0 + kk < M
          ? x[hd.row(t0 + r) + k0 + kk] * (scale ? rs[r] : 1.f)
          : 0.f;
    }
  };
  // a c x c matrix's columns k0.. (rows t), or transposed, its rows k0..
  auto a_mat = [&](const float* mat, int k0, bool transposed) {
    for (int e = tid; e < rows * kTile; e += kThreads) {
      if (transposed) {  // As[s][kk] = mat[k0 + kk][s], read along s
        const int kk = e / rows, r = e % rows;
        As[r * kAs + kk] = r < c && k0 + kk < c
            ? mat[(long long)(k0 + kk) * c + r] : 0.f;
      } else {
        const int r = e / kTile, kk = e % kTile;
        As[r * kAs + kk] = r < c && k0 + kk < c
            ? mat[(long long)r * c + k0 + kk] : 0.f;
      }
    }
  };
  // B tiles (32 of K x 32 columns):
  // a token-major tensor's rows k0.. at columns a0.. (times rs, q~ scale)
  auto b_tokens = [&](const float* x, int k0, float scale, bool by_rs) {
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int kk = e / kTile, col = e % kTile, t = k0 + kk;
      Bs[kk * kBs + col] = t < c && a0 + col < M
          ? x[hd.row(t0 + t) + a0 + col] * scale * (by_rs ? rs[t] : 1.f)
          : 0.f;
    }
  };
  // an m x m matrix: Bs[kk][col] = mat[a0 + col][k0 + kk] (transposed,
  // read along k), or mat[k0 + kk][a0 + col]
  auto b_state = [&](const float* mat, int k0, bool transposed) {
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int x = e / kTile, y = e % kTile;
      const int kk = transposed ? y : x, col = transposed ? x : y;
      Bs[kk * kBs + col] = k0 + kk < M && a0 + col < M
          ? (transposed ? mat[(long long)(a0 + col) * M + k0 + kk]
                        : mat[(long long)(k0 + kk) * M + a0 + col])
          : 0.f;
    }
  };

  float acc[U][4], st[U][4];
  // (a) dq: intra sum_s dS_ts k_s, then Z_t = C_in dnum_t + dden_t n_in
  tile_zero(acc);
  for (int k0 = 0; k0 < c; k0 += kTile) {
    __syncthreads();
    a_mat(dsm, k0, false);
    b_tokens(k, k0, 1.f, false);
    __syncthreads();
    tile_fma(acc, As, Bs, rg, cg);
  }
  tile_zero(st);
  for (int k0 = 0; k0 < M; k0 += kTile) {
    __syncthreads();
    a_tokens(dh, k0, true);
    b_state(cin, k0, true);
    __syncthreads();
    tile_fma(st, As, Bs, rg, cg);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = rg + 32 * u;
    float share = 0.f;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int col = a0 + 4 * cg + x;
      if (t < c && col < M) {
        const long long i = hd.row(t0 + t) + col;
        const float z = st[u][x] + dds[t] * nin[col];
        dq[i] = (acc[u][x] + expf(cums[t]) * z) * inv_sqrt_m;
        share += q[i] * inv_sqrt_m * z;
      }
    }
    share = row_sum(share);
    if (cg == 0 && t < c) part[t] = share;
  }

  // (b) dk: intra sum_t dS_ts q~_t, then Y_s = dC v_s + dn
  tile_zero(acc);
  for (int k0 = 0; k0 < c; k0 += kTile) {
    __syncthreads();
    a_mat(dsm, k0, true);
    b_tokens(q, k0, inv_sqrt_m, false);
    __syncthreads();
    tile_fma(acc, As, Bs, rg, cg);
  }
  tile_zero(st);
  for (int k0 = 0; k0 < M; k0 += kTile) {
    __syncthreads();
    a_tokens(v, k0, false);
    b_state(dco, k0, true);
    __syncthreads();
    tile_fma(st, As, Bs, rg, cg);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int s = rg + 32 * u;
    float share = 0.f;
    if (s < c) {
      const float w = expf(clast - cums[s]) * is[s];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int col = a0 + 4 * cg + x;
        if (col < M) {
          const long long i = hd.row(t0 + s) + col;
          const float y = st[u][x] + dno[col];
          dk[i] = acc[u][x] + w * y;
          share += k[i] * y;
        }
      }
    }
    share = row_sum(share);
    if (cg == 0 && s < c) part[c + s] = share;
  }

  // (c) dv for columns a0.. of v: intra sum_t A_ts dnum_t, then dC^T k_s
  tile_zero(acc);
  for (int k0 = 0; k0 < c; k0 += kTile) {
    __syncthreads();
    a_mat(am, k0, true);
    b_tokens(dh, k0, 1.f, true);
    __syncthreads();
    tile_fma(acc, As, Bs, rg, cg);
  }
  tile_zero(st);
  for (int k0 = 0; k0 < M; k0 += kTile) {
    __syncthreads();
    a_tokens(k, k0, false);
    b_state(dco, k0, false);
    __syncthreads();
    tile_fma(st, As, Bs, rg, cg);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int s = rg + 32 * u;
    if (s < c) {
      const float w = expf(clast - cums[s]) * is[s];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int col = a0 + 4 * cg + x;
        if (col < M) dv[hd.row(t0 + s) + col] = acc[u][x] + w * st[u][x];
      }
    }
  }

  // (d) this block's rows of dC : C_in, and of dn . n_in
  float pd = 0.f;
  for (int e = tid; e < kTile * M; e += kThreads) {
    const int a = a0 + e / M, i = e % M;
    if (a < M) pd += dco[(long long)a * M + i] * cin[(long long)a * M + i];
  }
  if (tid < kTile && a0 + tid < M) pd += dno[a0 + tid] * nin[a0 + tid];
#pragma unroll
  for (int o = 16; o; o >>= 1) pd += __shfl_xor_sync(0xffffffffu, pd, o);
  if ((tid & 31) == 0) red[tid >> 5] = pd;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
    part[2 * c] = s;
  }
}

// --------------------------------------------------------------- 6. gates
__global__ void __launch_bounds__(kMaxChunk)
mlstm_bwd_gates_kernel(const float* __restrict__ ig,
                       const float* __restrict__ vec,
                       const float* __restrict__ mats,
                       const float* __restrict__ parts,
                       float* __restrict__ di, float* __restrict__ dlf,
                       int S, int H, int M, int c, int nsl) {
  __shared__ float is[kMaxChunk], dcum[kMaxChunk], extra[kMaxChunk];
  const int j = blockIdx.x, nc = gridDim.x, bh = blockIdx.y;
  const int t = threadIdx.x;
  const Head hd(bh, S, H, M);
  const long long t0 = (long long)j * c, at = (long long)bh * S + t0;
  const long long cc = (long long)c * c;
  const long long chunk_id = (long long)bh * nc + j;
  const float* qm = mats + 2 * (long long)gridDim.y * nc * cc + chunk_id * cc;
  const float* part = parts + chunk_id * nsl * (2 * c + 1);
  if (t < c) is[t] = ig[hd.g(t0 + t)];
  __syncthreads();
  const float clast = vec[at + c - 1];
  float pd = 0.f;
  for (int s = 0; s < nsl; ++s) pd += part[s * (2 * c + 1) + 2 * c];
  if (t < c) {
    float pe = 0.f, pw = 0.f;
    for (int s = 0; s < nsl; ++s) {
      pe += part[s * (2 * c + 1) + t];
      pw += part[s * (2 * c + 1) + c + t];
    }
    float row = 0.f, colq = 0.f;
    for (int s = 0; s <= t; ++s) row += qm[(long long)t * c + s] * is[s];
    for (int u = t; u < c; ++u) colq += qm[(long long)u * c + t];
    const float cum = vec[at + t];
    const float el = expf(clast - cum), w = el * is[t];
    di[hd.g(t0 + t)] = colq + pw * el;
    dcum[t] = row - colq * is[t] + pe * expf(cum) - pw * w;
    extra[t] = pw * w;
  }
  __syncthreads();
  if (t == 0) {
    float s = pd * expf(clast);
    for (int u = 0; u < c; ++u) s += extra[u];
    dcum[c - 1] += s;
  }
  __syncthreads();
  if (t < c) {
    float s = 0.f;
    for (int u = c - 1; u >= t; --u) s += dcum[u];
    dlf[hd.g(t0 + t)] = s;
  }
}

}  // namespace

// q, k, v, h, dh, dq, dk, dv: (B, S, H, M) float32, q unscaled; ig, lf,
// di, dlf: (B, S, H); c_in (B, H, S / chunk, M, M), n_in (B, H, S / chunk,
// M), den (B, H, S): what the forward wrote under grad; dc_seed (B, H, M,
// M) and dn_seed (B, H, M): the gradients of the final state, each null
// for zeros.  All contiguous float32, outputs distinct.  work: a float32
// workspace of 3 B H S + B H nc (M M + M) + 3 B H nc chunk^2 +
// B H nc ceil(M / 32) (2 chunk + 1) elements, nc = S / chunk.
// 1 <= chunk <= 128 divides S; 1 <= M <= 1024.  Launches six kernels on
// `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes it does not take.
extern "C" int rimms_mlstm_bwd_f32(
    const void* q, const void* k, const void* v, const void* ig,
    const void* lf, const void* h, const void* c_in, const void* n_in,
    const void* den, const void* dh, const void* dc_seed,
    const void* dn_seed, void* dq, void* dk, void* dv, void* di, void* dlf,
    void* work, int B, int S, int H, int M, int chunk, float inv_sqrt_m,
    void* stream) {
  if (B < 0 || S < 0 || H < 1 || M < 1 || M > 1024 || chunk < 1 ||
      chunk > kMaxChunk || S % chunk != 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const int nc = S / chunk, nsl = (M + kTile - 1) / kTile;
  const long long bh = (long long)B * H;
  const unsigned nbh = (unsigned)bh;
  float* vec = (float*)work;
  float* dco = vec + 3 * bh * S;
  float* dno = dco + bh * nc * (long long)M * M;
  float* mats = dno + bh * nc * M;
  float* parts = mats + 3 * bh * nc * (long long)chunk * chunk;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  const float *fq = (const float*)q, *fk = (const float*)k,
              *fv = (const float*)v, *fig = (const float*)ig,
              *fdh = (const float*)dh;
  mlstm_bwd_prep_kernel<<<dim3(nc, nbh), kThreads, 0, st>>>(
      (const float*)lf, (const float*)den, (const float*)h, fdh, vec, S, H, M,
      chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (nc > 1) {
    const unsigned tiles = (unsigned)((M + kMaxChunk - 1) / kMaxChunk * nsl);
    mlstm_bwd_update_kernel<<<dim3(tiles, nc - 1, nbh), kThreads, 0, st>>>(
        fq, fdh, vec, dco, dno, S, H, M, chunk, inv_sqrt_m);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const long long cells = (long long)M * M + M;
  mlstm_bwd_carry_kernel<<<dim3((unsigned)((cells + kThreads - 1) / kThreads),
                                nbh),
                           kThreads, 0, st>>>(
      vec, (const float*)dc_seed, (const float*)dn_seed, dco, dno, S, M,
      chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const unsigned pairs = (unsigned)((chunk + kTile - 1) / kTile *
                                    ((chunk + kTile - 1) / kTile));
  mlstm_bwd_scores_kernel<<<dim3(nc, nbh, pairs), kThreads, 0, st>>>(
      fq, fk, fv, fig, fdh, vec, mats, S, H, M, chunk, inv_sqrt_m);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  auto grads = [&](auto kernel) {
    kernel<<<dim3(nc, nbh, nsl), kThreads, 0, st>>>(
        fq, fk, fv, fig, fdh, vec, mats, (const float*)c_in,
        (const float*)n_in, dco, dno, (float*)dq, (float*)dk, (float*)dv,
        parts, S, H, M, chunk, inv_sqrt_m);
  };
  // 32-row groups enough for the chunk's tokens
  switch ((chunk + 31) / 32) {
    case 1: grads(mlstm_bwd_grads_kernel<1>); break;
    case 2: grads(mlstm_bwd_grads_kernel<2>); break;
    case 3: grads(mlstm_bwd_grads_kernel<3>); break;
    default: grads(mlstm_bwd_grads_kernel<4>); break;
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mlstm_bwd_gates_kernel<<<dim3(nc, nbh), kMaxChunk, 0, st>>>(
      fig, vec, mats, parts, (float*)di, (float*)dlf, S, H, M, chunk, nsl);
  return (int)cudaGetLastError();
}
