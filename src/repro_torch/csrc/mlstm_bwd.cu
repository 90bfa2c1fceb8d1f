// Backward of the chunkwise mLSTM (mlstm.cu) over float32, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package differentiates its plain XLA
// recurrence (src/repro/models/recurrent.py), so the gradient to match is
// JAX's through that recurrence; mlstm_backward_plain (kernels/mlstm/
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
// max(|den_t|, 1): dnum_t = dh_t / D_t, dden_t = -sgn(den_t) W_t
// (dh_t . h_t) / D_t with W_t = 1 where |den_t| > 1, 1/2 where |den_t| = 1
// (JAX's gradient of maximum at a tie, as the reference's
// jnp.maximum(jnp.abs(den), 1.0) takes it) and 0 below, and per chunk,
// with (dC, dn) the gradient reaching C_out, n_out:
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
// by operations, and only the tensor cores bring it near that bound.  So
// every matrix product runs on them in split TF32 (mlstm_tf32.cuh, the
// forward's scheme: plain TF32 put 1.4e-3 into the forward's h, and the
// backward is held to 1e-3 of max|g|), its operand tiles streamed through
// rings of shared memory by cp.async, the next step's tiles in flight
// while this step's products run.  Five launches:
//  1. mlstm_bwd_prep_kernel, one block per (chunk, head, 32 tokens): cum
//     by a warp scan (the forward's), exp(cum), and per token 1 / D_t and
//     dden_t (dh . h by a warp each).
//  2. mlstm_bwd_state_kernel, one block per (64 x 64 tile of the m x m
//     state, head), walking the chunks from the last with its tile of the
//     gradient reaching a chunk's end state in registers: decay it, add
//     the chunk's own update sum_t ecum_t q~_t dnum_t^T (depth c, in
//     32-token slices through a three-stage ring), write it for the chunk
//     before (staged through shared memory, so a warp writes whole rows).
//     The walk is the only serial part; it runs in parallel over tiles
//     and heads, and the per-chunk gradients are written once.
//  3. mlstm_bwd_scores_kernel, one block per (chunk, head, 64 x 64 tile
//     of the c x c scores): q~ k^T and dnum v^T over m in 16-deep slices,
//     the tiles above the diagonal zero without products, giving A^T, dS,
//     dS^T and dA S D, each padded to cp x cp (cp: c rounded up to 16),
//     so the next pass reads every one of them row by row.
//  4. mlstm_bwd_grads_kernel, one block per (chunk, head, 64 columns of
//     m), a chunk's blocks next to each other in the grid so they share
//     its token rows and states in the L2 cache: first the state terms Z,
//     Y (C_in and dC by rows) and dC^T k (dC by columns) over m, one ring
//     stage holding a step's tiles of all three (the two dC tiles are
//     transposes of each other's place, dC[P, slice] and dC[slice, P]),
//     and the block's share of dC : C_in from the same tiles; then the
//     gates' shares q~ . Z and k . Y of its columns; then onto the same
//     accumulators the intra-chunk products dS k, dS^T q~ and A^T dnum
//     over the chunk (the triangle: steps past the diagonal are
//     skipped).  A warp owns 16 token rows and 8 NT columns of all three
//     outputs.  The chunk's token rows are read once per 64 columns, 8
//     times per (chunk, head) at m = 512.  A chunk above 128 is taken in
//     row blocks of 128 token rows, one block each (the A slots hold the
//     block's rows of dS, dS^T and A^T, the B slots the whole chunk's
//     token slices): a block's tiles at c 256 are those of a chunk of 128
//     (four stages, 227,360 bytes of shared memory), where the whole
//     chunk's rows would take twice that.
//  5. mlstm_bwd_gates_kernel, one block per (chunk, head): sums the
//     shares in a fixed order, di and dcum, and dlog_f.
// Nothing is summed by atomics, so the bits do not change from run to run.
// What holds it back (PERF.md; NVIDIA H100 80GB HBM3 at 700 W, m 512,
// chunk 64): the grads pass is bound by staging the chunk's token rows
// and the C_in and dC tiles, not by its products; the state walk by
// writing each chunk's m x m gradient (268 MB).  mma.sync m16n8k8 on
// TF32 alone peaks near 316 TFLOP/s on that card.
// c is at most 256, m at most 1024.  At c 256 the other passes keep their
// tiles (64 x 64 of the scores, 32-token slices of the state walk, the
// prep's 32 tokens a block); the per-token vectors they stage are 256
// long, and the gates pass runs a thread a token.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mlstm_tf32.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxChunk = 256;
constexpr int kRowBlock = 128;  // token rows a grads block owns
constexpr int kMaxSmem = 232448;
constexpr int kCols = 64;   // columns of m a grads block owns; side of a
                            // state tile and of a scores tile
constexpr int kDepth = 16;  // depth slice of the scores and grads rings
constexpr int kTok = 32;    // token slice of the state ring
// row strides (floats) chosen so fragment loads are free of bank
// conflicts: rows read two adjacent floats a lane (A, n-major B: == 8 mod
// 16), rows read one float a lane at k-rows 2 t4 and 2 t4 + 1 (transposed
// A, k-major B: == 4 mod 16)
constexpr int kLdA = kDepth + 8;
constexpr int kLdK = kCols + 4;
// one B slot of the grads ring: 64 rows of a depth slice, or a depth
// slice's rows of 64 columns
constexpr int kBSlot = kCols * kLdA > kDepth * kLdK ? kCols * kLdA
                                                     : kDepth * kLdK;
constexpr int kStateStages = 3;
constexpr int kScoreStages = 3;
// the state ring's stage: q and dh tiles, then ecum, 1 / D, dden, and
// the chunk's decay (padded to 16 bytes)
constexpr int kStateStage = 2 * kTok * kLdK + 3 * kTok + 4;
constexpr int kScoreStage = 4 * kCols * kLdA;
// the grads kernel's gate vectors (1 / D, dden, ecum, w) and reductions
constexpr int kGradsExtra = 4 * kMaxChunk + 2 * kMaxChunk + kThreads / 32;
// a grads step's dC : C_in share is one float4 of each tile a thread
static_assert(kCols * kDepth == 4 * kThreads, "share tiling");

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

// Rows r < nrows, W floats each (a multiple of V), of the region at src
// (row stride `stride`) into dst (row stride ld): element (r, i) copied
// when r < rows and i < cols, zeros elsewhere (src is a valid address
// whatever rows and cols are).  A thread copies the same V floats of
// every kThreads / (W / V)-th row, so its addresses advance by a fixed
// step.
template <int V, int W>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* src, long long stride,
                                           int nrows, int rows, int cols) {
  constexpr int per_row = W / V, pass = kThreads / per_row;
  static_assert(kThreads % per_row == 0, "rows a pass");
  const int r0 = threadIdx.x / per_row, i = (threadIdx.x % per_row) * V;
  const bool col_in = i < cols;
  const float* s = src + r0 * stride + i;
  float* d = dst + r0 * ld + i;
  for (int r = r0; r < nrows; r += pass, s += pass * stride, d += pass * ld) {
    const bool in = col_in && r < rows;
    cp_async<V>(d, in ? s : src, in);
  }
}

// (x, y) at p and p + 1; one 8-byte store when `pair` (p even-aligned),
// else each where it is in range
__device__ __forceinline__ void store2(float* p, float x, float y, bool pair,
                                       bool in1) {
  if (pair)
    *(float2*)p = make_float2(x, y);
  else {
    p[0] = x;
    if (in1) p[1] = y;
  }
}

// ---------------------------------------------------------------- 1. prep
// vec: [4][BH][S] = cum, 1 / D, dden, exp(cum).  One block per (chunk,
// head, 32 tokens): each block scans its chunk's gates (the same bits in
// every block of the chunk) and writes its own tokens.
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_prep_kernel(const float* __restrict__ lf,
                      const float* __restrict__ den,
                      const float* __restrict__ h,
                      const float* __restrict__ dh, float* __restrict__ vec,
                      int S, int H, int M, int c) {
  __shared__ float wsum[kMaxChunk / 32];
  const int j = blockIdx.x, bh = blockIdx.y, tz = blockIdx.z * kTok;
  const int tend = min(c, tz + kTok);
  const Head hd(bh, S, H, M);
  const long long bhs = (long long)gridDim.y * S;
  const long long t0 = (long long)j * c, at = (long long)bh * S + t0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the gates: an inclusive scan of log_f by warps, then warp offsets
  float x = 0.f;
  if (tid < kMaxChunk) {
    x = tid < c ? lf[hd.g(t0 + tid)] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x = __fadd_rn(x, y);
    }
    if (lane == 31) wsum[warp] = x;
  }
  __syncthreads();
  if (tid >= tz && tid < tend) {
    float off = 0.f;
    for (int w = 0; w < warp; ++w) off = __fadd_rn(off, wsum[w]);
    const float cum = __fadd_rn(x, off);
    vec[at + tid] = cum;
    vec[3 * bhs + at + tid] = expf(cum);
  }
  for (int t = tz + warp; t < tend; t += kThreads / 32) {
    const long long row = hd.row(t0 + t);
    float s = 0.f;
    for (int a = lane; a < M; a += 32) s += dh[row + a] * h[row + a];
#pragma unroll
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      const float d = den[at + t], ad = fabsf(d), big = fmaxf(ad, 1.f);
      const float wt = ad > 1.f ? 1.f : (ad == 1.f ? 0.5f : 0.f);
      vec[bhs + at + t] = 1.f / big;
      vec[2 * bhs + at + t] = wt * (d > 0.f ? -s : s) / big;
    }
  }
}

// ---------------------------------------------------------------- 2. state
// dc_out, dn_out: [BH][nc] slots, slot j the gradient reaching chunk j's
// end state: slot nc - 1 the seed (or zeros), slot j - 1 = decay_j slot j
// + sum over chunk j of ecum_t q~_t dnum_t^T (and its dn).  One block per
// (64 x 64 tile (a, e) of the state, head); warp w owns rows 16 (w / 2)
// of the tile's a and columns 32 (w % 2) of its e, in registers across
// the walk.  A step takes 32 tokens of a chunk: q[t][a] and dh[t][e]
// tiles (token-major, read at k-rows 2 t4 and 2 t4 + 1) and their gate
// vectors, two steps ahead through a three-stage ring; the tile goes out
// through shared memory (tb) so that a warp's stores are whole rows.
template <int V>
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_state_kernel(const float* __restrict__ q,
                       const float* __restrict__ dh,
                       const float* __restrict__ vec,
                       const float* __restrict__ dc_seed,
                       const float* __restrict__ dn_seed,
                       float* __restrict__ dc_out, float* __restrict__ dn_out,
                       int S, int H, int M, int c, float inv_sqrt_m) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int nt_side = (M + kCols - 1) / kCols;
  const int a0 = (blockIdx.x / nt_side) * kCols;
  const int e0 = (blockIdx.x % nt_side) * kCols;
  const bool has_n = e0 == 0;  // the first column tile also walks dn
  const int bh = blockIdx.y, nc = S / c;
  const Head hd(bh, S, H, M);
  const long long bhs = (long long)gridDim.y * S;
  const long long mm = (long long)M * M;
  const int nsc = (c + kTok - 1) / kTok;  // steps a chunk
  const int nst = (nc - 1) * nsc;          // chunks nc - 1 .. 1
  const float* ecum = vec + 3 * bhs + (long long)bh * S;
  const float* rinv = vec + bhs + (long long)bh * S;
  const float* ddn = vec + 2 * bhs + (long long)bh * S;

  // the next step to issue: chunk ij, slice iz, into stage ib
  int ij = nc - 1, iz = 0, ib = 0, issued = 0;
  auto issue = [&]() {
    if (issued < nst) {
      const int j = ij, tz = iz * kTok;
      float* s0 = smem + ib * kStateStage;
      const long long row = hd.row((long long)j * c + tz);
      stage_rows<V, kCols>(s0, kLdK, q + row + a0, hd.pos, kTok, c - tz,
                           M - a0);
      stage_rows<V, kCols>(s0 + kTok * kLdK, kLdK, dh + row + e0, hd.pos, kTok,
                           c - tz, M - e0);
      float* vs = s0 + 2 * kTok * kLdK;
      const long long t0 = (long long)j * c;
      if (tid < kTok) {
        const bool in = tz + tid < c;
        const long long t = t0 + (in ? tz + tid : 0);
        cp_async<1>(vs + tid, ecum + t, in);
        cp_async<1>(vs + kTok + tid, rinv + t, in);
        cp_async<1>(vs + 2 * kTok + tid, ddn + t, in);
      } else if (tid == kTok) {
        cp_async<1>(vs + 3 * kTok, ecum + t0 + c - 1, true);
      }
      ++issued;
      if (++iz == nsc) iz = 0, --ij;
      if (++ib == kStateStages) ib = 0;
    }
    cp_async_commit();
  };

  const int rt = warp >> 1, cg = warp & 1;
  float acc[4][4];
  // has_n: dn at row a0 + na, the same in the four threads of a quad
  // (each sums a quarter of a step's tokens)
  const int na = tid >> 2, nq = tid & 3;
  float gn = 0.f;
  const long long slot0 = (long long)bh * nc;
  // the tile into slot j: through shared memory, so that a warp's
  // stores are whole rows
  float* tb = smem + kStateStages * kStateStage;
  auto write = [&](int j) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *(float2*)(tb + (16 * rt + g + 8 * h) * kLdK + 32 * cg + 8 * nt +
                   2 * t4) = make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
    __syncthreads();
    float* dco = dc_out + (slot0 + j) * mm;
    constexpr int per_row = kCols / V;
#pragma unroll
    for (int u = 0; u < kCols * per_row / kThreads; ++u) {
      const int e = tid + u * kThreads;
      const int r = e / per_row, col = (e % per_row) * V;
      if (a0 + r < M && e0 + col < M) {
        float* dst = dco + (long long)(a0 + r) * M + e0 + col;
        if constexpr (V == 4)
          *(float4*)dst = *(const float4*)(tb + r * kLdK + col);
        else
          *dst = tb[r * kLdK + col];
      }
    }
    if (has_n && nq == 0 && a0 + na < M)
      dn_out[(slot0 + j) * M + a0 + na] = gn;
  };
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int a = a0 + 16 * rt + g + 8 * (e >> 1);
      const int col = e0 + 32 * cg + 8 * nt + 2 * t4 + (e & 1);
      acc[nt][e] = dc_seed != nullptr && a < M && col < M
                       ? dc_seed[(long long)bh * mm + (long long)a * M + col]
                       : 0.f;
    }
  if (has_n && a0 + na < M && dn_seed != nullptr)
    gn = dn_seed[(long long)bh * M + a0 + na];
  write(nc - 1);

  for (int s = 0; s < kStateStages - 1; ++s) issue();
  // this step: chunk j, slice z, from stage rb
  int j = nc - 1, z = 0, rb = 0;
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<kStateStages - 2>();
    __syncthreads();
    issue();
    const float* qs = smem + rb * kStateStage;
    const float* ds = qs + kTok * kLdK;
    // ecum, then 1 / D, then dden of the step's tokens, then the decay
    const float* es = ds + kTok * kLdK;
    if (z == 0) {  // a chunk starts: decay what reaches its end state
      const float f = es[3 * kTok];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = __fmul_rn(f, acc[nt][e]);
      gn = __fmul_rn(f, gn);
    }
#pragma unroll
    for (int kk = 0; kk < kTok / 8; ++kk) {
      const int k0 = 8 * kk + 2 * t4;
      const float s0 = __fmul_rn(es[k0], inv_sqrt_m);
      const float s1 = __fmul_rn(es[k0 + 1], inv_sqrt_m);
      const float* qr = qs + k0 * kLdK + 16 * rt + g;
      const float x[4] = {__fmul_rn(qr[0], s0), __fmul_rn(qr[8], s0),
                          __fmul_rn(qr[kLdK], s1),
                          __fmul_rn(qr[kLdK + 8], s1)};
      const Split<4> a(x);
      const float r0 = es[kTok + k0], r1 = es[kTok + k0 + 1];
      const float* dr = ds + k0 * kLdK + 32 * cg + g;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma3(acc[nt], acc[nt], a, __fmul_rn(dr[8 * nt], r0),
             __fmul_rn(dr[kLdK + 8 * nt], r1));
    }
    if (has_n) {  // sum_t ecum_t dden_t q~_t, tokens nq, nq + 4, ...
      float u = 0.f;
#pragma unroll
      for (int r = nq; r < kTok; r += 4)
        u = fmaf(__fmul_rn(__fmul_rn(qs[r * kLdK + na], es[r]), inv_sqrt_m),
                 es[2 * kTok + r], u);
      u += __shfl_xor_sync(0xffffffffu, u, 1);
      u += __shfl_xor_sync(0xffffffffu, u, 2);
      gn += u;
    }
    if (z == nsc - 1) write(j - 1);
    if (++z == nsc) z = 0, --j;
    if (++rb == kStateStages) rb = 0;
  }
}

// -------------------------------------------------------------- 3. scores
// mats: [4][BH * nc][cp][cp] = A^T, dS, dS^T, dA S D (the scores' S),
// zero for s > t and past c.  One block per (chunk, head, tile (ti, si)
// of 64 x 64); warp w owns rows 16 (w / 2) of the tile's t and columns 32
// (w % 2) of its s; a step takes 16 of m: q and dh rows of t, k and v
// rows of s, through a three-stage ring.
template <int V>
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_scores_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ ig,
                        const float* __restrict__ dh,
                        const float* __restrict__ vec,
                        float* __restrict__ mats, int S, int H, int M, int c,
                        float inv_sqrt_m) {
  extern __shared__ __align__(16) float smem[];
  const int cp = (c + 15) & ~15, ntile = (cp + kCols - 1) / kCols;
  const int pair = blockIdx.x % (ntile * ntile), nc = S / c;
  const int j = blockIdx.x / (ntile * ntile), bh = blockIdx.y;
  const int ti = pair / ntile, si = pair % ntile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const Head hd(bh, S, H, M);
  const long long bhs = (long long)gridDim.y * S;
  const long long t0 = (long long)j * c, at = (long long)bh * S + t0;
  const long long cc = (long long)cp * cp;
  const long long plane = (long long)gridDim.y * nc * cc;
  float* mat = mats + ((long long)bh * nc + j) * cc;
  const int tb = ti * kCols, sb = si * kCols;
  if (si > ti) {  // above the diagonal: zeros
    for (int e = tid; e < kCols * kCols; e += kThreads) {
      const int t = tb + e / kCols, s = sb + e % kCols;
      if (t < cp && s < cp) {
        mat[(long long)s * cp + t] = 0.f;
        mat[plane + (long long)t * cp + s] = 0.f;
        mat[2 * plane + (long long)s * cp + t] = 0.f;
        mat[3 * plane + (long long)t * cp + s] = 0.f;
      }
    }
    return;
  }
  float* cums = smem + kScoreStages * kScoreStage;
  float* rs = cums + kMaxChunk;
  float* dds = rs + kMaxChunk;
  float* is = dds + kMaxChunk;
  for (int t = tid; t < kMaxChunk; t += kThreads) {
    const bool in = t < c;
    cums[t] = in ? vec[at + t] : 0.f;
    rs[t] = in ? vec[bhs + at + t] : 0.f;
    dds[t] = in ? vec[2 * bhs + at + t] : 0.f;
    is[t] = in ? ig[hd.g(t0 + t)] : 0.f;
  }
  const int nst = (M + kDepth - 1) / kDepth;
  // rows of t and of s past the chunk clamp to its last (zero-filled)
  const long long rowt = hd.row(t0 + min(tb, c - 1));
  const long long rows_ = hd.row(t0 + min(sb, c - 1));
  auto issue = [&](int st) {
    if (st < nst) {
      const int i0 = st * kDepth;
      float* s0 = smem + (st % kScoreStages) * kScoreStage;
      const int st_rows = c - tb, ss_rows = c - sb;
      stage_rows<V, kDepth>(s0, kLdA, q + rowt + i0, hd.pos, kCols, st_rows,
                            M - i0);
      stage_rows<V, kDepth>(s0 + kCols * kLdA, kLdA, dh + rowt + i0, hd.pos,
                            kCols, st_rows, M - i0);
      stage_rows<V, kDepth>(s0 + 2 * kCols * kLdA, kLdA, k + rows_ + i0, hd.pos,
                            kCols, ss_rows, M - i0);
      stage_rows<V, kDepth>(s0 + 3 * kCols * kLdA, kLdA, v + rows_ + i0, hd.pos,
                            kCols, ss_rows, M - i0);
    }
    cp_async_commit();
  };

  const int rt = warp >> 1, cg = warp & 1;
  const int r0 = tb + 16 * rt;  // the warp's first row of t
  const bool active = r0 < cp;
  // column tiles of 8 that reach the diagonal (all off it)
  const int ntl = ti == si ? max(0, min(4, 2 * rt + 2 - 4 * cg)) : 4;
  float sa[4][4], pa[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sa[nt][e] = pa[nt][e] = 0.f;

  for (int s = 0; s < kScoreStages - 1; ++s) issue(s);
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<kScoreStages - 2>();
    __syncthreads();
    issue(st + kScoreStages - 1);
    if (!active || ntl == 0) continue;
    const float* qs = smem + (st % kScoreStages) * kScoreStage;
    const float* gs = qs + kCols * kLdA;
    const float* ks = gs + kCols * kLdA;
    const float* vs = ks + kCols * kLdA;
    const float rg0 = rs[r0 + g], rg1 = rs[r0 + g + 8];
#pragma unroll
    for (int kk = 0; kk < kDepth / 8; ++kk) {
      float x[4];
      load_a(x, qs + 16 * rt * kLdA + 8 * kk, kLdA, g, t4, inv_sqrt_m);
      const Split<4> aq(x);
      load_a(x, gs + 16 * rt * kLdA + 8 * kk, kLdA, g, t4);
      x[0] = __fmul_rn(x[0], rg0);
      x[2] = __fmul_rn(x[2], rg0);
      x[1] = __fmul_rn(x[1], rg1);
      x[3] = __fmul_rn(x[3], rg1);
      const Split<4> ag(x);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt < ntl) {
          const int off = (32 * cg + 8 * nt + g) * kLdA + 8 * kk + 2 * t4;
          const float2 kr = *(const float2*)(ks + off);
          const float2 vr = *(const float2*)(vs + off);
          mma3(sa[nt], sa[nt], aq, kr.x, kr.y);
          mma3(pa[nt], pa[nt], ag, vr.x, vr.y);
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = r0 + g + 8 * (e >> 1);
      const int s = sb + 32 * cg + 8 * nt + 2 * t4 + (e & 1);
      if (t < cp && s < cp) {
        float av = 0.f, dsv = 0.f, qv = 0.f;
        if (s <= t && t < c) {
          const float dm = expf(cums[t] - cums[s]);
          const float da = pa[nt][e] + dds[t];
          av = sa[nt][e] * dm * is[s];
          dsv = da * dm * is[s];
          qv = da * sa[nt][e] * dm;
        }
        mat[(long long)s * cp + t] = av;
        mat[plane + (long long)t * cp + s] = dsv;
        mat[2 * plane + (long long)s * cp + t] = dsv;
        mat[3 * plane + (long long)t * cp + s] = qv;
      }
    }
  }
}

// --------------------------------------------------------------- 4. grads
// parts: [BH * nc][nP][2 c + 1] = shares of q~ . Z (c), k . Y (c) and
// dC : C_in + dn . n_in (1) over this block's 64 columns.  One block per
// (chunk, row block of up to 128 token rows, head, 64 columns P of m): a
// chunk of 128 or less is one row block; above, each block writes its
// rows' shares, and row block 0 the dC : C_in one.  The row tiles below
// are the block's.  Warp w < tasks owns row tile w / ngr
// (16 token rows) and column group w % ngr (NT tiles of 8 columns), with
// ngr = 8 / NT, of dq, dk and dv at once.  Steps 0..nms-1 take 16 of m
// (A slots: dh, v, k rows of the chunk; B slots: C_in[P, slice] and
// dC[P, slice] by rows, dC[slice, P] by columns), then steps of 16 of the
// chunk (A slots: dS, dS^T, A^T columns; B slots: k, q, dh rows at P),
// through a ring of 2 (NT <= 4, two blocks an SM) or 4 stages.
template <int NT>
struct GradsCfg {
  static constexpr int stages = NT <= 4 ? 2 : 4;
  static constexpr int min_blocks = NT <= 4 ? 2 : 1;
};

template <int V, int NT, bool RB>
__global__ void __launch_bounds__(kThreads, GradsCfg<NT>::min_blocks)
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
  constexpr int kStages = GradsCfg<NT>::stages;
  constexpr int ngr = 8 / NT;
  extern __shared__ __align__(16) float smem[];
  const int cp = (c + 15) & ~15;
  // RB: row blocks of kRowBlock (chunks above it); else the chunk's rows
  const int rcap = RB ? kRowBlock : cp;
  const int nrb = RB ? (cp + kRowBlock - 1) / kRowBlock : 1;
  const int stage = 3 * rcap * kLdA + 3 * kBSlot;
  const int np = (M + kCols - 1) / kCols, nc = S / c;
  const int pt = blockIdx.x % np, bh = blockIdx.y;
  const int rb = RB ? (blockIdx.x / np) % nrb : 0, j = blockIdx.x / np / nrb;
  const int rb0 = rb * kRowBlock;                 // the block's first row
  const int nrt = min(cp - rb0, rcap) / 16;       // its row tiles
  const int a0 = pt * kCols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const Head hd(bh, S, H, M);
  const long long bhs = (long long)gridDim.y * S;
  const long long t0 = (long long)j * c, at = (long long)bh * S + t0;
  const long long cc = (long long)cp * cp, mm = (long long)M * M;
  const long long plane = (long long)gridDim.y * nc * cc;
  const long long chunk_id = (long long)bh * nc + j;
  const float* at_m = mats + chunk_id * cc;   // A^T
  const float* ds_m = at_m + plane;            // dS
  const float* dst_m = at_m + 2 * plane;       // dS^T
  const float* cin = c_in + chunk_id * mm;
  const float* dco = dc_out + chunk_id * mm;
  const float* nin = n_in + chunk_id * M;
  const float* dno = dn_out + chunk_id * M;
  float* part = parts + (chunk_id * np + pt) * (2 * c + 1);
  float* rs = smem + kStages * stage;  // 1 / D
  float* dds = rs + kMaxChunk;         // dden
  float* ecs = dds + kMaxChunk;        // exp(cum)
  float* ws = ecs + kMaxChunk;         // w = exp(cum_last - cum) i
  float* red = ws + kMaxChunk;         // [2][ngr][rcap] row shares
  float* red8 = red + 2 * kMaxChunk;   // [8] warp sums of dC : C_in
  const float clast = vec[at + c - 1];
  for (int t = tid; t < kMaxChunk; t += kThreads) {
    const bool in = t < c;
    rs[t] = in ? vec[bhs + at + t] : 0.f;
    dds[t] = in ? vec[2 * bhs + at + t] : 0.f;
    ecs[t] = in ? vec[3 * bhs + at + t] : 0.f;
    ws[t] = in ? expf(clast - vec[at + t]) * ig[hd.g(t0 + t)] : 0.f;
  }
  const int nms = (M + kDepth - 1) / kDepth;
  const int nsteps = nms + cp / kDepth;
  const long long row0 = hd.row(t0);
  const long long rowb = hd.row(t0 + rb0);  // the block's first token row

  auto issue = [&](int st) {
    if (st < nsteps) {
      float* as = smem + (st % kStages) * stage;
      float* bs = as + 3 * rcap * kLdA;
      if (st < nms) {
        const int i0 = st * kDepth;
        stage_rows<V, kDepth>(as, kLdA, dh + rowb + i0, hd.pos, rcap, c - rb0,
                              M - i0);
        stage_rows<V, kDepth>(as + rcap * kLdA, kLdA, v + rowb + i0, hd.pos,
                              rcap, c - rb0, M - i0);
        stage_rows<V, kDepth>(as + 2 * rcap * kLdA, kLdA, k + rowb + i0,
                              hd.pos, rcap, c - rb0, M - i0);
        stage_rows<V, kDepth>(bs, kLdA, cin + (long long)a0 * M + i0, M, kCols,
                              M - a0, M - i0);
        stage_rows<V, kDepth>(bs + kBSlot, kLdA, dco + (long long)a0 * M + i0,
                              M, kCols, M - a0, M - i0);
        stage_rows<V, kCols>(bs + 2 * kBSlot, kLdK,
                             dco + (long long)i0 * M + a0, M, kDepth, M - i0,
                             M - a0);
      } else {
        const int k0 = (st - nms) * kDepth;
        const long long mo = (long long)rb0 * cp + k0;  // the block's rows
        stage_rows<4, kDepth>(as, kLdA, ds_m + mo, cp, rcap, cp - rb0,
                              kDepth);
        stage_rows<4, kDepth>(as + rcap * kLdA, kLdA, dst_m + mo, cp, rcap,
                              cp - rb0, kDepth);
        stage_rows<4, kDepth>(as + 2 * rcap * kLdA, kLdA, at_m + mo, cp, rcap,
                              cp - rb0, kDepth);
        // rows past the chunk clamp to its last (zero-filled)
        const long long rk = hd.row(t0 + min(k0, c - 1)) + a0;
        stage_rows<V, kCols>(bs, kLdK, k + rk, hd.pos, kDepth, c - k0, M - a0);
        stage_rows<V, kCols>(bs + kBSlot, kLdK, q + rk, hd.pos, kDepth, c - k0,
                             M - a0);
        stage_rows<V, kCols>(bs + 2 * kBSlot, kLdK, dh + rk, hd.pos, kDepth,
                             c - k0, M - a0);
      }
    }
    cp_async_commit();
  };

  const int tasks = nrt * ngr;
  const bool active = warp < tasks;
  const int rt = warp / ngr, cgp = warp % ngr;
  const int r0 = 16 * rt;         // the warp's first row in the block
  const int tr0 = rb0 + r0;       // ... and in the chunk
  const int n0 = 8 * NT * cgp;    // its first column within P
  // Z -> dq~, Y -> dk, X -> dv: the state terms, then (scaled) the
  // outputs' accumulators
  float za[NT][4], ya[NT][4], xa[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) za[nt][e] = ya[nt][e] = xa[nt][e] = 0.f;
  float pd = 0.f;  // this thread's share of dC : C_in

  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int st = 0; st < nsteps; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(st + kStages - 1);
    const float* as = smem + (st % kStages) * stage;
    const float* bs = as + 3 * rcap * kLdA;
    if (st < nms) {
      {  // dC : C_in over this block's rows and the slice, 4 a thread
        const int off = (tid >> 2) * kLdA + 4 * (tid & 3);
        const float4 x = *(const float4*)(bs + kBSlot + off);
        const float4 y = *(const float4*)(bs + off);
        pd = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, fmaf(x.w, y.w, pd))));
      }
      if (active) {
        const float rg0 = rs[tr0 + g], rg1 = rs[tr0 + g + 8];
#pragma unroll
        for (int kk = 0; kk < kDepth / 8; ++kk) {
          float x[4];
          load_a(x, as + r0 * kLdA + 8 * kk, kLdA, g, t4);
          x[0] = __fmul_rn(x[0], rg0);
          x[2] = __fmul_rn(x[2], rg0);
          x[1] = __fmul_rn(x[1], rg1);
          x[3] = __fmul_rn(x[3], rg1);
          const Split<4> an(x);  // dnum
          load_a(x, as + (rcap + r0) * kLdA + 8 * kk, kLdA, g, t4);
          const Split<4> av(x);  // v
          load_a(x, as + (2 * rcap + r0) * kLdA + 8 * kk, kLdA, g, t4);
          const Split<4> ak(x);  // k
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int col = n0 + 8 * nt + g;
            const int off = col * kLdA + 8 * kk + 2 * t4;
            const float2 cr = *(const float2*)(bs + off);
            const float2 dr = *(const float2*)(bs + kBSlot + off);
            const float* dt = bs + 2 * kBSlot + (8 * kk + 2 * t4) * kLdK + col;
            mma3(za[nt], za[nt], an, cr.x, cr.y);
            mma3(ya[nt], ya[nt], av, dr.x, dr.y);
            mma3(xa[nt], xa[nt], ak, dt[0], dt[kLdK]);
          }
        }
      }
      if (st == nms - 1) {
        // the gates' shares of this block's columns, then the state terms
        // scaled into the outputs' accumulators
        float sq[2] = {0.f, 0.f}, sk[2] = {0.f, 0.f};
        if (active) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int t = tr0 + g + 8 * (e >> 1);
              const int a = a0 + n0 + 8 * nt + 2 * t4 + (e & 1);
              const bool in = t < c && a < M;
              const float z = in ? fmaf(dds[t], nin[a], za[nt][e]) : 0.f;
              const float y = in ? ya[nt][e] + dno[a] : 0.f;
              if (in) {
                const long long i = row0 + (long long)t * hd.pos + a;
                sq[e >> 1] = fmaf(__fmul_rn(q[i], inv_sqrt_m), z, sq[e >> 1]);
                sk[e >> 1] = fmaf(k[i], y, sk[e >> 1]);
              }
              za[nt][e] = __fmul_rn(ecs[t], z);
              ya[nt][e] = __fmul_rn(ws[t], y);
              xa[nt][e] = __fmul_rn(ws[t], xa[nt][e]);
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 1);
            sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 2);
            sk[h] += __shfl_xor_sync(0xffffffffu, sk[h], 1);
            sk[h] += __shfl_xor_sync(0xffffffffu, sk[h], 2);
            if (t4 == 0) {
              red[cgp * rcap + r0 + g + 8 * h] = sq[h];
              red[(ngr + cgp) * rcap + r0 + g + 8 * h] = sk[h];
            }
          }
        }
        __syncthreads();
        if (tid < rcap && rb0 + tid < c) {
          float pq = 0.f, pk = 0.f;
          for (int x = 0; x < ngr; ++x) {
            pq += red[x * rcap + tid];
            pk += red[(ngr + x) * rcap + tid];
          }
          part[rb0 + tid] = pq;
          part[c + rb0 + tid] = pk;
        }
      }
      continue;
    }
    // the intra-chunk products over k-slice k0.. (8-wide steps kg)
    if (!active) continue;
    const int k0 = (st - nms) * kDepth;
#pragma unroll
    for (int kk = 0; kk < kDepth / 8; ++kk) {
      const int kg = k0 + 8 * kk;
      const bool lower = kg <= tr0 + 15;  // dS[t][s]: s <= t
      const bool upper = kg + 7 >= tr0;   // dS^T[s][t], A^T[s][t]: t >= s
      const int kr = 8 * kk + 2 * t4;
      const float* bk = bs + kr * kLdK + n0 + g;
      const float* bq = bk + kBSlot;
      const float* bg = bk + 2 * kBSlot;
      const float sg0 = rs[kg + 2 * t4], sg1 = rs[kg + 2 * t4 + 1];
      float x[4];
      if (lower) {
        load_a(x, as + r0 * kLdA + 8 * kk, kLdA, g, t4);
        const Split<4> a(x);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma3(za[nt], za[nt], a, bk[8 * nt], bk[kLdK + 8 * nt]);
      }
      if (upper) {
        load_a(x, as + (rcap + r0) * kLdA + 8 * kk, kLdA, g, t4);
        const Split<4> a(x);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma3(ya[nt], ya[nt], a, __fmul_rn(bq[8 * nt], inv_sqrt_m),
               __fmul_rn(bq[kLdK + 8 * nt], inv_sqrt_m));
        load_a(x, as + (2 * rcap + r0) * kLdA + 8 * kk, kLdA, g, t4);
        const Split<4> b(x);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma3(xa[nt], xa[nt], b, __fmul_rn(bg[8 * nt], sg0),
               __fmul_rn(bg[kLdK + 8 * nt], sg1));
      }
    }
  }

  if (active) {
    const bool pair = (M & 1) == 0;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = tr0 + g + 8 * h;
        const int a = a0 + n0 + 8 * nt + 2 * t4;
        if (t < c && a < M) {
          const long long i = row0 + (long long)t * hd.pos + a;
          store2(dq + i, __fmul_rn(za[nt][2 * h], inv_sqrt_m),
                 __fmul_rn(za[nt][2 * h + 1], inv_sqrt_m), pair, a + 1 < M);
          store2(dk + i, ya[nt][2 * h], ya[nt][2 * h + 1], pair, a + 1 < M);
          store2(dv + i, xa[nt][2 * h], xa[nt][2 * h + 1], pair, a + 1 < M);
        }
      }
    }
  }
  // this block's rows of dC : C_in, and of dn . n_in
  if (tid < kCols && a0 + tid < M) pd = fmaf(dno[a0 + tid], nin[a0 + tid], pd);
#pragma unroll
  for (int o = 16; o; o >>= 1) pd += __shfl_xor_sync(0xffffffffu, pd, o);
  if (lane == 0) red8[warp] = pd;
  __syncthreads();
  if (tid == 0 && rb == 0) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += red8[w];
    part[2 * c] = s;
  }
}

// --------------------------------------------------------------- 5. gates
__global__ void __launch_bounds__(kMaxChunk)
mlstm_bwd_gates_kernel(const float* __restrict__ ig,
                       const float* __restrict__ vec,
                       const float* __restrict__ mats,
                       const float* __restrict__ parts,
                       float* __restrict__ di, float* __restrict__ dlf,
                       int S, int H, int M, int c, int np) {
  __shared__ float is[kMaxChunk], dcum[kMaxChunk], extra[kMaxChunk];
  const int j = blockIdx.x, nc = gridDim.x, bh = blockIdx.y;
  const int t = threadIdx.x, cp = (c + 15) & ~15;
  const Head hd(bh, S, H, M);
  const long long t0 = (long long)j * c, at = (long long)bh * S + t0;
  const long long cc = (long long)cp * cp;
  const long long chunk_id = (long long)bh * nc + j;
  const float* qm = mats + 3 * (long long)gridDim.y * nc * cc + chunk_id * cc;
  const float* part = parts + chunk_id * np * (2 * c + 1);
  if (t < c) is[t] = ig[hd.g(t0 + t)];
  __syncthreads();
  const float clast = vec[at + c - 1];
  float pd = 0.f;
  for (int s = 0; s < np; ++s) pd += part[s * (2 * c + 1) + 2 * c];
  if (t < c) {
    float pe = 0.f, pw = 0.f;
    for (int s = 0; s < np; ++s) {
      pe += part[s * (2 * c + 1) + t];
      pw += part[s * (2 * c + 1) + c + t];
    }
    float row = 0.f, colq = 0.f;
    for (int s = 0; s <= t; ++s) row += qm[(long long)t * cp + s] * is[s];
    for (int u = t; u < c; ++u) colq += qm[(long long)u * cp + t];
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

long long up4(long long n) { return (n + 3) & ~3LL; }

}  // namespace

// q, k, v, h, dh, dq, dk, dv: (B, S, H, M) float32, q unscaled; ig, lf,
// di, dlf: (B, S, H); c_in (B, H, S / chunk, M, M), n_in (B, H, S / chunk,
// M), den (B, H, S): what the forward wrote under grad; dc_seed (B, H, M,
// M) and dn_seed (B, H, M): the gradients of the final state, each null
// for zeros.  All contiguous float32, outputs distinct.  work: a float32
// workspace, 16-byte aligned, of the elements backward_work
// (kernels/mlstm/mlstm.py) counts: 4 B H S (cum, 1 / D, dden, exp(cum)),
// then B H nc (M M) (the gradient reaching each chunk's end state), B H
// nc M (its dn), 4 B H nc cp^2 (A^T, dS, dS^T, dA S D) and B H nc
// ceil(M / 64) (2 chunk + 1) (the shares), each part's start rounded up
// to 4 elements; nc = S / chunk, cp = chunk rounded up to 16.  1 <= chunk
// <= 256 divides S; 1 <= M <= 1024.  Launches five kernels on `stream`;
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// shapes it does not take.
extern "C" int rimms_mlstm_bwd_f32(
    const void* q, const void* k, const void* v, const void* ig,
    const void* lf, const void* h, const void* c_in, const void* n_in,
    const void* den, const void* dh, const void* dc_seed,
    const void* dn_seed, void* dq, void* dk, void* dv, void* di, void* dlf,
    void* work, int B, int S, int H, int M, int chunk, float inv_sqrt_m,
    void* stream) {
  if (B < 0 || S < 0 || H < 1 || M < 1 || M > 1024 || chunk < 1 ||
      chunk > kMaxChunk || S % chunk != 0 || (long long)B * H > 65535 ||
      (uintptr_t)work % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const int nc = S / chunk, cp = (chunk + 15) & ~15;
  const int np = (M + kCols - 1) / kCols;
  // a grads block's rows: the chunk's, or a row block of 128 of them
  const int rcap = cp < kRowBlock ? cp : kRowBlock;
  const int nrb = (cp + kRowBlock - 1) / kRowBlock, nrt = rcap / 16;
  const int ntile = (cp + kCols - 1) / kCols;
  const long long bh = (long long)B * H;
  const unsigned nbh = (unsigned)bh;
  float* vec = (float*)work;
  float* dco = vec + up4(4 * bh * S);
  float* dno = dco + up4(bh * nc * (long long)M * M);
  float* mats = dno + up4(bh * nc * M);
  float* parts = mats + up4(4 * bh * nc * (long long)cp * cp);
  cudaStream_t st = (cudaStream_t)stream;
  const float *fq = (const float*)q, *fk = (const float*)k,
              *fv = (const float*)v, *fig = (const float*)ig,
              *fdh = (const float*)dh, *fcin = (const float*)c_in;
  // 16-byte copies when every row of q, k, v, dh, c_in (and of the
  // workspace's per-chunk gradients) starts 16-byte aligned
  const bool vec4 = M % 4 == 0 &&
                    ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                     (uintptr_t)dh | (uintptr_t)c_in) % 16 == 0;
  const size_t state_smem =
      ((size_t)kStateStages * kStateStage + kCols * kLdK) * sizeof(float);
  const size_t score_smem =
      ((size_t)kScoreStages * kScoreStage + 4 * kMaxChunk) * sizeof(float);
  const int gstages = nrt <= 4 ? 2 : 4;
  const size_t grads_smem =
      ((size_t)gstages * (3 * rcap * kLdA + 3 * kBSlot) + kGradsExtra) *
      sizeof(float);
  if (grads_smem > (size_t)kMaxSmem - 1024) return (int)cudaErrorInvalidValue;

  auto attr = [](auto kernel, size_t bytes) {
    return bytes > 48 * 1024
               ? cudaFuncSetAttribute(
                     kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                     (int)bytes)
               : cudaSuccess;
  };
  auto run = [&](auto state_kernel, auto scores_kernel, auto grads_kernel) {
    cudaError_t e = attr(state_kernel, state_smem);
    if (e == cudaSuccess) e = attr(scores_kernel, score_smem);
    if (e == cudaSuccess) e = attr(grads_kernel, grads_smem);
    if (e != cudaSuccess) return (int)e;
    mlstm_bwd_prep_kernel<<<dim3(nc, nbh, (chunk + kTok - 1) / kTok),
                            kThreads, 0, st>>>(
        (const float*)lf, (const float*)den, (const float*)h, fdh, vec, S, H,
        M, chunk);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    state_kernel<<<dim3(np * np, nbh), kThreads, state_smem, st>>>(
        fq, fdh, vec, (const float*)dc_seed, (const float*)dn_seed, dco, dno,
        S, H, M, chunk, inv_sqrt_m);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    scores_kernel<<<dim3(nc * ntile * ntile, nbh), kThreads, score_smem,
                    st>>>(
        fq, fk, fv, fig, fdh, vec, mats, S, H, M, chunk, inv_sqrt_m);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    grads_kernel<<<dim3(nc * nrb * np, nbh), kThreads, grads_smem, st>>>(
        fq, fk, fv, fig, fdh, vec, mats, fcin, (const float*)n_in, dco, dno,
        (float*)dq, (float*)dk, (float*)dv, parts, S, H, M, chunk,
        inv_sqrt_m);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    mlstm_bwd_gates_kernel<<<dim3(nc, nbh), kMaxChunk, 0, st>>>(
        fig, vec, mats, parts, (float*)di, (float*)dlf, S, H, M, chunk, np);
    return (int)cudaGetLastError();
  };
  // column tiles of 8 a warp owns: 8 / (row tiles) rounded to a power of
  // two, so row tiles x column groups <= 8 warps
  // (a chunk above kRowBlock: its own instance, in row blocks)
  auto pick = [&](auto state_kernel, auto scores_kernel, auto g1, auto g2,
                  auto g4, auto g8, auto gb) {
    return nrb > 1    ? run(state_kernel, scores_kernel, gb)
           : nrt == 1 ? run(state_kernel, scores_kernel, g1)
           : nrt == 2 ? run(state_kernel, scores_kernel, g2)
           : nrt <= 4 ? run(state_kernel, scores_kernel, g4)
                      : run(state_kernel, scores_kernel, g8);
  };
  return vec4
             ? pick(mlstm_bwd_state_kernel<4>, mlstm_bwd_scores_kernel<4>,
                    mlstm_bwd_grads_kernel<4, 1, false>,
                    mlstm_bwd_grads_kernel<4, 2, false>,
                    mlstm_bwd_grads_kernel<4, 4, false>,
                    mlstm_bwd_grads_kernel<4, 8, false>,
                    mlstm_bwd_grads_kernel<4, 8, true>)
             : pick(mlstm_bwd_state_kernel<1>, mlstm_bwd_scores_kernel<1>,
                    mlstm_bwd_grads_kernel<1, 1, false>,
                    mlstm_bwd_grads_kernel<1, 2, false>,
                    mlstm_bwd_grads_kernel<1, 4, false>,
                    mlstm_bwd_grads_kernel<1, 8, false>,
                    mlstm_bwd_grads_kernel<1, 8, true>);
}
