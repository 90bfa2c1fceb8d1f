// Paged decode attention over RIMMS block tables, float32 or bfloat16, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel
// src/repro/kernels/paged_attention/paged_attention.py::_paged_kernel
// (launched by paged_attention).  One query token per sequence b attends
// over the K/V pool rows its block table names: position t of sequence b
// lies in page block_table[b, t / page] at slot t % page.  For each query
// head h (KV head h / (Hq / Hkv)):
//     s = (q . k) / sqrt(d), -1e30 at t >= lengths[b]
//     out = sum_t softmax(s)_t v_t, accumulated in float32, in q's type.
//
// What bounds it on the H100: each K/V byte is read once and feeds
// 2 * Hq/Hkv flops, so it is bound by bytes (llama3-8b decode width, 8
// sequences of 4096 tokens: 128 MiB of K+V, 0.040 ms at 3.35 TB/s).  All it
// has to do is keep enough bytes in flight on every SM.
//
// Design (flash-decoding).  A call runs one kernel, paged_attention_split,
// with one block per (KV head, sequence, split).  A split is a fixed run of
// pages_per_split whole pages; the wrapper derives it from the table width
// and the page size alone (kernels/paged_attention/paged_attention.py::
// split_plan), never from B, the pool, another row's length or the dtype.
//  * The block walks its positions in chunks of 64 (32 for rows wider than
//    512 bytes).  The row's length, q and the first table entries are
//    loaded together; later table entries are read an iteration before
//    their rows are needed, so that latency hides behind a chunk's
//    arithmetic; each chunk's K and V rows come with 16-byte cp.async into
//    a 2-stage ring, so one chunk's copy overlaps the previous chunk's
//    arithmetic.  256 threads and at most 80 registers a thread put three
//    blocks on an SM.  The group's Hq/Hkv query rows share every row
//    loaded.
//  * Scores: 8 lanes per position, each summing an eighth of the dot
//    product, reduced by shuffles; a lane takes two positions, so each q
//    load (conflict-free float4s) feeds both.  Then one warp per query row
//    takes the chunk's online-softmax step.  The accumulator is cut into
//    items of two 8-column slices: the same 8 columns of two query rows
//    (one 16-byte V load feeds 16 FMAs), and when the group is odd, 16
//    columns of its last row.  That makes G * D / 16 items, rounded up,
//    so G * D <= 16 * kThreads gives every item a thread.  When there are
//    fewer items than threads, groups of threads take every n-th position
//    of a chunk for the same item and their sums are added in group order
//    at the end.
//  * The block writes its float32 partials (m, l, acc) to a workspace the
//    wrapper allocates; a split that starts at or past the row's length
//    writes m = -1e30, l = 0, acc = 0.  Then it counts itself in on the
//    row's arrival counter, and the row's last block merges the splits in
//    split order (a fixed order: the result never depends on which block
//    finished first): M = max m_s, w_s = exp(m_s - M), out = sum w_s acc_s
//    / max(sum w_s l_s, 1e-30), and sets the counter back to 0.  The
//    wrapper keeps the workspace and the counters (zeroed once) per
//    stream, so a call allocates nothing and needs no memset.
//
// Rows of length 0 keep the oracle's answer, the uniform mean of V over
// all n_pages * page positions, exactly: their scores are -1e30 without
// reading K (a masked score is -1e30 whatever K holds), so every p is
// exp(0) = 1, and every split of the row has m = -1e30, so the splits merge
// with weight exp(0) = 1.  A row of length >= 1 stops at its length.
// Table entries that repeat a page are legal; an entry outside [0, P) is
// clamped into it so the kernel never reads outside the pool.
//
// Engine bit identity: a row's output is computed only from its own q,
// table row and length (its blocks, its merge), with a split layout that
// depends only on n_pages and page; so a row gives the same bits whatever
// the other rows of the batch hold.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;
constexpr int kMaxAcc = 16;  // accumulator elements per thread: 2 rows x 8
constexpr int kStages = 2;   // K/V ring depth: one chunk in flight
constexpr int kMaxSplits = 16;  // splits of one table (split_plan's limit)
constexpr int kMaxDevices = 64;
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most kStages - 2 copy groups are in flight
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

int chunk_for(int D, int esize) { return D * esize <= 512 ? 64 : 32; }

// the K/V ring; after the last chunk it holds the position groups' sums
__host__ __device__ inline size_t ring_bytes(int D, int esize, int chunk) {
  const size_t ring = (size_t)2 * kStages * chunk * D * esize;
  const size_t sums = (size_t)kThreads * 16 * sizeof(float);
  return ring > sums ? ring : sums;
}

size_t split_smem_bytes(int G, int D, int esize, int chunk) {
  return (size_t)kStages * chunk * sizeof(long long) +  // row offsets
         ring_bytes(D, esize, chunk) +
         ((size_t)G * D + (size_t)G * chunk + 3 * (size_t)G) *
             sizeof(float);                             // q, p, m/l/alpha
}

// Called by every block of a split pass once its partials are written: the
// last of a row's n_splits blocks to get here merges them in split order
// (M = max m_s, w_s = exp(m_s - M), out = sum w_s acc_s / max(sum w_s l_s,
// 1e-30)) into out.  `sm` is the block's dynamic shared memory, free by
// now.
template <typename T>
__device__ void merge_if_last(const float* __restrict__ row_ws,
                              int* __restrict__ counter, T* __restrict__ o,
                              int G, int D, int n_splits, float* sm) {
  __shared__ int is_last;
  const int tid = threadIdx.x;
  __threadfence();  // this block's partials before its arrival
  __syncthreads();
  if (tid == 0) {
    is_last = atomicAdd(counter, 1) == n_splits - 1;
    // every split has arrived: ready for the next call on this stream
    if (is_last) *counter = 0;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const long long stride = (long long)G * (D + 2);
  float* w = sm;                    // [G][n_splits] m_s, then the weights
  float* l = w + G * n_splits;      // [G][n_splits] l_s
  float* lf = l + G * n_splits;     // [G] max(sum w_s l_s, 1e-30)
  for (int e = tid; e < G * n_splits; e += kThreads) {  // all at once
    const int g = e / n_splits, sp = e - g * n_splits;
    w[e] = __ldcg(row_ws + sp * stride + G * D + g);
    l[e] = __ldcg(row_ws + sp * stride + G * D + G + g);
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float* wg = w + g * n_splits;
    float M = kNegInf;
    for (int sp = 0; sp < n_splits; ++sp) M = fmaxf(M, wg[sp]);
    float L = 0.f;
    for (int sp = 0; sp < n_splits; ++sp) {
      wg[sp] = expf(wg[sp] - M);
      L = fmaf(wg[sp], l[g * n_splits + sp], L);
    }
    lf[g] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += kThreads) {
    const float* wg = w + (e / D) * n_splits;
    float acc = 0.f;
    for (int s0 = 0; s0 < n_splits; s0 += 8) {  // 8 loads in flight
      float a[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        a[u] = s0 + u < n_splits ? __ldcg(row_ws + (s0 + u) * stride + e)
                                 : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (s0 + u < n_splits) acc = fmaf(wg[s0 + u], a[u], acc);
    }
    narrow(o + e, acc / lf[e / D]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
paged_attention_split(const T* __restrict__ q, const T* __restrict__ kp,
                      const T* __restrict__ vp,
                      const int* __restrict__ block_table,
                      const int* __restrict__ lengths, T* __restrict__ out,
                      float* __restrict__ ws, int* __restrict__ counters,
                      int P, int page, int Hkv, int G, int D, int n_pages,
                      int pages_per_split, int chunk, float sqrt_d) {
  constexpr int N = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  long long* rows = reinterpret_cast<long long*>(smem);  // [kStages][chunk]
  // [stage][K, V][chunk][D]
  T* kv = reinterpret_cast<T*>(rows + kStages * chunk);
  float* red = reinterpret_cast<float*>(kv);  // [16][kThreads], after the ring
  float* qs = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(kv) +
      ring_bytes(D, (int)sizeof(T), chunk));  // [G][D]
  float* ss = qs + G * D;            // [G][chunk] scores, then p
  float* m_s = ss + G * chunk;       // [G] running max
  float* l_s = m_s + G;              // [G] running sum
  float* a_s = l_s + G;              // [G] this chunk's rescale

  const int hk = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long row = (long long)b * Hkv + hk;  // (sequence, KV head)
  const float* row_ws = ws + row * gridDim.z * G * (D + 2);
  float* part = ws + (row * gridDim.z + sp) * (long long)G * (D + 2);
  T* o = out + row * G * D;
  const int t_begin = sp * pages_per_split * page;
  const int t_stop = min(t_begin + pages_per_split * page, n_pages * page);
  const int* bt = block_table + (long long)b * n_pages;
  // the loads that do not wait for the row's length go first: its length,
  // q and the table entries of the first chunks are in flight together
  const int len = lengths[b];
  auto table_entry = [&](int j) {  // thread c's row of chunk j
    const int t = t_begin + j * chunk + tid;
    return tid < chunk && t < t_stop ? bt[t / page] : 0;
  };
  int entry[kStages + 1];
#pragma unroll
  for (int j = 0; j <= kStages; ++j) entry[j] = table_entry(j);
  const int nv = D / N;  // 16-byte vectors per K/V row
  // q as float4s laid out [G][N / 4][nv]: the 8 lanes of a position read
  // 8 neighbouring float4s (no bank conflict)
  const long long qoff = row * G * D;  // G rows of D
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D, r = e - g * D, v = r / N, u = r - v * N;
    qs[((g * (N / 4) + u / 4) * nv + v) * 4 + u % 4] = widen(q[qoff + e]);
  }
  const bool zero_len = len <= 0;
  const int t_end = zero_len ? t_stop : min(t_stop, len);
  if (t_begin >= t_end) {  // nothing of this row lies in this split
    for (int e = tid; e < G * D; e += kThreads) part[e] = 0.f;
    for (int g = tid; g < G; g += kThreads) {
      part[G * D + g] = kNegInf;
      part[G * D + G + g] = 0.f;
    }
    merge_if_last(row_ws, counters + row, o, G, D, gridDim.z,
                  reinterpret_cast<float*>(smem));
    return;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  // the accumulator as items of two 8-column slices, (g_lo, c_lo) and
  // (g_hi, c_hi): the same columns of rows 2i and 2i + 1, then, for an odd
  // G, columns 16j..16j+7 and 16j+8..16j+15 of row G - 1 (the second slice
  // absent past D).  (G - 1) / 2 * D / 8 + ceil(D / 16) <= (G D / 8 + 1) / 2
  // items, at most kThreads since G * D <= 16 kThreads.  With fewer items
  // than threads, n_pg groups of threads take every n_pg-th position of a
  // chunk and their sums are added in group order at the end
  const int n_vec = D / 8, n_paired = G / 2 * n_vec;
  const int n_items = n_paired + (G % 2 ? (n_vec + 1) / 2 : 0);
  const int n_pg = kThreads / n_items;
  const int my_pg = tid / n_items, item = tid % n_items;
  const bool paired = item < n_paired;
  const int g_lo = paired ? 2 * (item / n_vec) : G - 1;
  const int g_hi = paired ? g_lo + 1 : G - 1;
  const int c_lo = paired ? (item % n_vec) * 8 : (item - n_paired) * 16;
  const int c_hi = paired ? c_lo : c_lo + 8;
  const bool has_hi = c_hi < D;
  float acc[2][8];  // slices (g_lo, c_lo) and (g_hi, c_hi)
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[k][u] = 0.f;

  const long long head_off = (long long)hk * D;
  const int n_chunks = (t_end - t_begin + chunk - 1) / chunk;

  // where chunk j's rows lie: thread c < chunk reads the table entry of
  // row c (table_entry) an iteration before it stores the row's offset in
  // rows[j % kStages][c] (store_row), so the table read's latency hides
  // behind a chunk's arithmetic
  auto store_row = [&](int j, int entry) {
    if (tid < chunk) {
      const int t = t_begin + j * chunk + tid;
      const int pid = min(max(entry, 0), P - 1);
      rows[(j % kStages) * chunk + tid] =
          t < t_end ? ((long long)pid * page + t % page) * Hkv * D + head_off
                    : 0;
    }
  };
  // chunk j's K (unless the row has length 0) and V rows into its stage
  auto fetch = [&](int j) {
    const int nt = min(chunk, t_end - t_begin - j * chunk);
    const long long* rj = rows + (j % kStages) * chunk;
    T* ks = kv + (j % kStages) * 2 * chunk * D;
    T* vs = ks + chunk * D;
    for (int e = tid; e < nt * nv; e += kThreads) {
      const int r = e / nv, i = (e - r * nv) * N;
      if (!zero_len) cp_async16(ks + r * D + i, kp + rj[r] + i);
      cp_async16(vs + r * D + i, vp + rj[r] + i);
    }
  };

#pragma unroll
  for (int j = 0; j < kStages; ++j)
    if (j < n_chunks) store_row(j, entry[j]);
  int next_entry = entry[kStages];  // chunk kStages, stored at j = 0
  __syncthreads();
  for (int j = 0; j < kStages - 1; ++j) {  // one group each, maybe empty
    if (j < n_chunks) fetch(j);
    cp_async_commit();
  }

  const int pg = lane / 8, sub = lane % 8;  // 8 lanes per position
  for (int j = 0; j < n_chunks; ++j) {
    const int nt = min(chunk, t_end - t_begin - j * chunk);
    cp_async_wait_ring();
    __syncthreads();  // chunk j is in; chunk j - 1 is done with everywhere
    if (j + kStages - 1 < n_chunks) fetch(j + kStages - 1);
    cp_async_commit();
    if (j + kStages < n_chunks) {  // rows[j % kStages] is free again
      store_row(j + kStages, next_entry);
      next_entry = table_entry(j + kStages + 1);
    }

    const T* ks = kv + (j % kStages) * 2 * chunk * D;
    const T* vs = ks + chunk * D;
    // scores: 8 lanes per position, each an eighth of every dot product;
    // a lane takes positions c and c + 32, so each q load feeds both
    const int c_a = warp * 4 + pg;
    const bool two = chunk > 32;
    for (int g0 = 0; g0 < G; g0 += 4) {  // 4 query rows at a time
      float dot[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      if (!zero_len) {
        for (int v = sub; v < nv; v += 8) {  // this lane's K vectors
          float kx[2][N];
          unpack(*reinterpret_cast<const uint4*>(ks + c_a * D + v * N),
                 kx[0], T());
          if (two)
            unpack(*reinterpret_cast<const uint4*>(ks + (c_a + 32) * D +
                                                   v * N),
                   kx[1], T());
#pragma unroll
          for (int gi = 0; gi < 4; ++gi) {
            if (g0 + gi < G) {
              const float4* qg = reinterpret_cast<const float4*>(qs) +
                                 (g0 + gi) * (N / 4) * nv;
#pragma unroll
              for (int u = 0; u < N; u += 4) {
                const float4 qv = qg[(u / 4) * nv + v];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  dot[h][gi] = fmaf(qv.x, kx[h][u], dot[h][gi]);
                  dot[h][gi] = fmaf(qv.y, kx[h][u + 1], dot[h][gi]);
                  dot[h][gi] = fmaf(qv.z, kx[h][u + 2], dot[h][gi]);
                  dot[h][gi] = fmaf(qv.w, kx[h][u + 3], dot[h][gi]);
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) {
          dot[h][gi] += __shfl_xor_sync(0xffffffffu, dot[h][gi], 4);
          dot[h][gi] += __shfl_xor_sync(0xffffffffu, dot[h][gi], 2);
          dot[h][gi] += __shfl_xor_sync(0xffffffffu, dot[h][gi], 1);
        }
      if (sub == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c_a + 32 * h;
          if (h == 0 || two)
#pragma unroll
            for (int gi = 0; gi < 4; ++gi)
              if (g0 + gi < G)
                ss[(g0 + gi) * chunk + c] =
                    !zero_len && c < nt ? __fdiv_rn(dot[h][gi], sqrt_d)
                                        : kNegInf;
        }
    }
    __syncthreads();
    // the online-softmax step: one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      float* sr = ss + g * chunk;
      float mx = kNegInf;
      for (int c = lane; c < nt; c += 32) mx = fmaxf(mx, sr[c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < chunk; c += 32) {
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
    // acc = alpha acc + p v over this thread's positions: for a paired
    // item one 16-byte (bf16) or two (float32) shared loads of V feed both
    // query rows; a last-row item loads its two slices one after the other
    if (my_pg < n_pg) {
      const float* p_lo = ss + g_lo * chunk;
      const float* p_hi = ss + g_hi * chunk;
      float pv[2][8];
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int u = 0; u < 8; ++u) pv[k][u] = 0.f;
#pragma unroll 4
      for (int c = my_pg; c < nt; c += n_pg) {
        const float p0 = p_lo[c], p1 = p_hi[c];
        float vx[8];
#pragma unroll
        for (int u = 0; u < 8; u += N)
          unpack(*reinterpret_cast<const uint4*>(vs + c * D + c_lo + u),
                 vx + u, T());
#pragma unroll
        for (int u = 0; u < 8; ++u) pv[0][u] = fmaf(p0, vx[u], pv[0][u]);
        if (!paired && has_hi) {
#pragma unroll
          for (int u = 0; u < 8; u += N)
            unpack(*reinterpret_cast<const uint4*>(vs + c * D + c_hi + u),
                   vx + u, T());
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) pv[1][u] = fmaf(p1, vx[u], pv[1][u]);
      }
      const float a0 = a_s[g_lo], a1 = a_s[g_hi];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        acc[0][u] = fmaf(acc[0][u], a0, pv[0][u]);
        acc[1][u] = fmaf(acc[1][u], a1, pv[1][u]);
      }
    }
  }

  // the position groups' sums, added in group order (through the ring,
  // whose copies are all done and read)
  if (n_pg > 1) {
    __syncthreads();
    if (my_pg < n_pg)  // laid out [16][kThreads]: no bank conflict
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int u = 0; u < 8; ++u)
          red[(k * 8 + u) * kThreads + tid] = acc[k][u];
    __syncthreads();
    // every thread sums some of the 16 n_items columns over the groups
    for (int e = tid; e < 16 * n_items; e += kThreads) {
      float* r = red + (e / n_items) * kThreads + e % n_items;
      float a = r[0];
#pragma unroll 8
      for (int pg = 1; pg < n_pg; ++pg) a += r[pg * n_items];
      r[0] = a;
    }
    __syncthreads();
    if (tid < n_items)
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int u = 0; u < 8; ++u)
          acc[k][u] = red[(k * 8 + u) * kThreads + tid];
  }
  if (tid < n_items)
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      part[g_lo * D + c_lo + u] = acc[0][u];
      if (has_hi) part[g_hi * D + c_hi + u] = acc[1][u];
    }
  for (int g = tid; g < G; g += kThreads) {
    part[G * D + g] = m_s[g];
    part[G * D + G + g] = l_s[g];
  }
  merge_if_last(row_ws, counters + row, o, G, D, gridDim.z,
                reinterpret_cast<float*>(smem));
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* bt,
           const void* lengths, void* out, void* ws, void* counters, int B,
           int Hkv, int G, int D, int P, int page, int n_pages,
           int pages_per_split, int n_splits, float sqrt_d,
           cudaStream_t stream) {
  const int chunk = chunk_for(D, (int)sizeof(T));
  const size_t bytes = split_smem_bytes(G, D, (int)sizeof(T), chunk);
  // the function's attributes outlive the call: set them on a device the
  // first time a call needs more shared memory than they allow
  static std::atomic<int> allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if ((int)bytes > allowed[dev].load()) {
    err = cudaFuncSetAttribute(paged_attention_split<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    // all of the SM's unified memory as shared memory: as many blocks as
    // fit
    err = cudaFuncSetAttribute(paged_attention_split<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
    if (err != cudaSuccess) return (int)err;
    allowed[dev].store((int)bytes);
  }
  paged_attention_split<T>
      <<<dim3((unsigned)Hkv, (unsigned)B, (unsigned)n_splits), kThreads,
         bytes, stream>>>((const T*)q, (const T*)kp, (const T*)vp,
                          (const int*)bt, (const int*)lengths, (T*)out,
                          (float*)ws, (int*)counters, P, page, Hkv, G, D,
                          n_pages, pages_per_split, chunk, sqrt_d);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (B, Hq, D); k_pages, v_pages: (P, page, Hkv, D); block_table:
// (B, n_pages) int32; lengths: (B,) int32; all contiguous, q and the pages
// of one type (dtype 0: float32, 1: bfloat16), the pages 16-byte aligned.
// workspace: B * Hkv * n_splits * (Hq / Hkv) * (D + 2) float32s, with
// n_splits = ceil(n_pages / pages_per_split) (at least 1, at most 16): the
// splits' partials.  counters: B * Hkv int32 arrival counters, 0 on entry
// and left 0 (the merging block resets its row's).  So one workspace and
// one zeroed counter buffer serve every call on a stream, but never two
// streams at once.  Hq a
// multiple of Hkv, D a multiple of 8 and <= 256, (Hq / Hkv) * D <= 4096,
// B <= 65535.  sqrt_d is sqrt(D) as a float.  Launches one kernel on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int rimms_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* block_table,
                                     const void* lengths, void* out,
                                     void* workspace, void* counters, int B,
                                     int Hq, int Hkv, int D, int P, int page,
                                     int n_pages, int pages_per_split,
                                     int n_splits, int dtype, float sqrt_d,
                                     void* stream) {
  if (B < 0 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || D < 8 || D % 8 != 0 ||
      D > kMaxD || (Hq / Hkv) * D > kMaxAcc * kThreads || P < 1 ||
      page < 1 || n_pages < 0 || B > 65535 || pages_per_split < 1 ||
      n_splits < 1 || n_splits > kMaxSplits ||
      (long long)n_splits * pages_per_split < n_pages ||  // splits cover
      (long long)(n_splits - 1) * pages_per_split >=
          (n_pages > 0 ? n_pages : 1) ||
      ((size_t)k_pages | (size_t)v_pages) % 16)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int G = Hq / Hkv;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, block_table, lengths, out,
                         workspace, counters, B, Hkv, G, D, P, page, n_pages,
                         pages_per_split, n_splits, sqrt_d, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, block_table, lengths,
                                 out, workspace, counters, B, Hkv, G, D, P,
                                 page, n_pages, pages_per_split, n_splits,
                                 sqrt_d, st);
  return (int)cudaErrorInvalidValue;
}
