// Batched FFT over complex64 rows, for Hopper (sm_90a): radix-8 and
// radix-16 passes in registers, twiddles from a table.
//
// Replaces the Pallas kernel src/repro/kernels/fft/fft.py::_fft_kernel
// (launched by fft_planes): the forward DFT along each row, or the inverse
// scaled by 1/N, of N = 2^p complex values, p from 1 to 20, in natural
// order: one launch of fft_rows up to N = 8192, two of fft_four_step above
// (see "Above 8192" at the end of this note).  The inverse is computed as
// conj(fft(conj x)) / N: the input is conjugated as it is loaded and the
// output as it is stored, which negates exactly and so equals conjugating
// every twiddle.
//
// What bounds it on the H100: a row moves 16 N bytes for 5 N log2 N flops
// (at most 4.1 flops a byte, under the FP32 ridge of 67 TFLOP/s over
// 3.35 TB/s), so a batch of rows is bound by memory.  The radar path calls
// it on one row at a time (N from 32 to 2048): there it is bound by latency
// -- dependent global loads, barriers, and the serial arithmetic of one
// block -- and never by bytes.
//
// Design.  Each thread holds V values in registers: V = 8 up to N = 512,
// where a one-row call is bound by the serial work of each thread and more
// threads a row finish sooner, and V = 16 above, where fewer passes move
// fewer bytes (V = N up to N = 8).  A row has N / V threads and goes
// through ceil(p / log2 V) Stockham passes (Govindaraju et al., SC 2008) of
// radix V, the last one of radix 2^(p mod log2 V) when that is not 1:
// N = 2048 takes 16, 16, 8, three passes and two barriers where a radix-2
// kernel takes eleven.  In the pass of sub-length Ns (the product of the
// radices before it) and radix R, butterfly j < N / R
//     reads   x[j + r N / R],                      r < R,
//     scales  them by w(r k, Ns R) with k = j mod Ns,
//     does a radix-R DFT in registers (radix-2 Stockham stages with
//     compile-time twiddles), and
//     writes  y[(j / Ns) Ns R + k + r Ns],
// so the result comes out in natural order with no bit reversal.  A thread
// does V / R butterflies of a smaller last radix.  The first pass reads the
// row from device memory and the last writes it there; shared memory only
// carries the exchange between passes, in two buffers (one barrier an
// exchange).  Shared index g of a block's rows is stored at
// g ^ ((g / V) mod 16): this swizzle makes every exchange of every N free
// of bank conflicts (each half-warp's 8-byte accesses land in 16 distinct
// bank pairs; tests/test_torch_fft_plan.py walks them all).
//
// Twiddles.  w(e, m) = exp(-2 pi i e / m) is entry e 8192 / m of a table
// of the 8192 roots exp(-2 pi i k / 8192), computed in float64 and rounded
// to float32 once per device by the wrapper; there is no sincos and no
// index arithmetic in the kernel.  Read from that table where each thread
// needs them, the 15 twiddles a thread takes a pass land on up to 32
// distinct sectors a warp-wide load, and on the H100 those loads took
// about as long as all the rest of the kernel.  So the wrapper also
// gathers, once per device and N, each pass's entries in the order the
// threads read them -- twiddle e of thread t of pass q at offset(q) + e T
// + t -- and a warp's load of one twiddle is one coalesced 256-byte read.
// A pass's twiddles are loaded while the pass before it computes.
//
// Shapes.  Each N is its own instantiation (the pass plan is compile-time,
// so every value stays in registers).  A block takes rows_per_group rows
// side by side (up to 512 threads) and walks groups_per_block such groups;
// the wrapper sizes both from block_rows, the autotuned launch parameter
// (the rows a block covers), so short rows fill a block and a batch of
// rows fills the SMs.  No row's arithmetic depends on which rows share its
// block, so every block_rows gives bit-identical output.
// The arithmetic uses round-to-nearest intrinsics, so no fused
// multiply-add changes a result between builds.  Loads are 8 bytes, so a
// row may start at any element (a fragment view); the input is never
// written.
//
// Above 8192.  A row of 16384 or more complex64 values (128 KB) no longer
// fits a block's two exchange buffers, and a 32768-point row alone (256 KB)
// is more than the 228 KB of an SM's shared memory, so N = N1 N2 (N1 =
// 2^ceil(p/2), N2 = 2^floor(p/2), both <= 1024 up to N = 2^20) goes through
// the four-step (Bailey) algorithm in two launches of fft_four_step, with
// the row seen as N1 x N2 (element n1 N2 + n2):
//   pass 1: the N1-point DFT of each column n2, times w_N^(n2 k1), into a
//           workspace row of the wrapper's at k1 N2 + n2;
//   pass 2: the N2-point DFT of each workspace row k1, into the output at
//           k1 + N1 k2 -- the transposed, natural order.
// Each block takes kTile = 8 adjacent lines (columns in pass 1, workspace
// rows in pass 2) so every strided load and store is a 64-byte run of
// adjacent lines: whole sectors.  The block copies its lines into shared
// memory, runs the same register passes on them as fft_rows (thread layout,
// twiddle tables and swizzle of an N1- or N2-point row), and copies the
// result out; the step twiddles w_N^(n2 k1) come from a table of N entries
// laid out as the workspace (computed in float64 and rounded once by the
// wrapper), read coalesced beside the stores.  The inverse conjugates on
// pass 1's loads and pass 2's stores.  A row's blocks and arithmetic depend
// on N alone, so neither the batch nor block_rows changes its bits.  It
// moves each value through device memory twice (2 x 16 N bytes, and 8 N of
// step twiddles): the strided loads of pass 1 are where its time goes.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kMaxLog = 13;     // one launch of fft_rows
constexpr int kMaxLog4 = 20;    // two launches of fft_four_step
constexpr int kMaxThreads = 512;
constexpr int kMaxDevices = 64;
// lines a four-step block takes side by side: 8 complex64 = 64 bytes
constexpr int kTileLog = 3;
constexpr int kTile = 1 << kTileLog;

// log2 of the values a thread holds for rows of 2^log (radix 8 up to 512)
__host__ __device__ constexpr int values_log(int log) {
  return log <= 3 ? log : log <= 9 ? 3 : 4;
}

template <int LOG>
struct Plan {
  static constexpr int N = 1 << LOG;
  static constexpr int VLOG = values_log(LOG);
  static constexpr int V = 1 << VLOG;
  static constexpr int PASSES = (LOG + VLOG - 1) / VLOG;
  static constexpr int TLOG = LOG - VLOG;  // threads a row
  static constexpr int T = 1 << TLOG;
  static constexpr int W = V > 1 ? V - 1 : 1;  // twiddles a pass, at most
  __host__ __device__ static constexpr int bits(int q) {
    return q < PASSES - 1 ? VLOG : LOG - VLOG * (PASSES - 1);
  }
  // where g of a block's shared buffer is stored
  __device__ static int swz(int g) { return g ^ ((g >> VLOG) & 15); }
  // where pass q's twiddles start in this N's pass table: passes 1 .. q - 1
  // take (V - V / R) twiddles for each of the T threads
  __host__ __device__ static constexpr int tw_offset(int q) {
    int off = 0;
    for (int p = 1; p < q; ++p) off += (V - (V >> bits(p))) * T;
    return off;
  }
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, w.x), __fmul_rn(a.y, w.y)),
                     __fadd_rn(__fmul_rn(a.x, w.y), __fmul_rn(a.y, w.x)));
}

// d * exp(-2 pi i e / 16), e < 8 a compile-time constant after unrolling
__device__ __forceinline__ float2 rot16(int e, float2 d) {
  constexpr float c1 = 0.92387953251128674f, s1 = 0.38268343236508978f;
  constexpr float h = 0.70710678118654752f;
  switch (e) {
    case 0: return d;
    case 1: return cmul(d, make_float2(c1, -s1));
    case 2: return cmul(d, make_float2(h, -h));
    case 3: return cmul(d, make_float2(s1, -c1));
    case 4: return make_float2(d.y, -d.x);
    case 5: return cmul(d, make_float2(-s1, -c1));
    case 6: return cmul(d, make_float2(-h, -h));
    default: return cmul(d, make_float2(-c1, -s1));
  }
}

// One radix-2 Stockham stage of sub-length M over the R values v, then the
// stages below it: the DFT of v in natural order, all in registers.
template <int R, int M>
__device__ __forceinline__ void dft_stages(float2* v) {
  if constexpr (M > 1) {
    constexpr int M2 = M / 2, L = R / M;
    float2 t[R];
#pragma unroll
    for (int l = 0; l < L; ++l) {
#pragma unroll
      for (int k = 0; k < M2; ++k) {
        const float2 a = v[l * M + k], b = v[l * M + M2 + k];
        t[l * M2 + k] = cadd(a, b);
        t[(L + l) * M2 + k] = rot16(k * (16 / M), csub(a, b));
      }
    }
#pragma unroll
    for (int e = 0; e < R; ++e) v[e] = t[e];
    dft_stages<R, M2>(v);
  }
}

// The twiddles of pass Q of a row of 2^LOG: w[i (R - 1) + r - 1] =
// w(r k, Ns R) with k = (t + i T) mod Ns multiplies input r of butterfly i
// of thread t; the pass table holds it at tw_offset(Q) + (i (R - 1) + r - 1)
// T + t.
template <int LOG, int Q>
__device__ __forceinline__ void load_twiddles(float2 (&w)[Plan<LOG>::W],
                                              const float2* __restrict__ tw,
                                              int t) {
  using P = Plan<LOG>;
  if constexpr (Q > 0 && Q < P::PASSES) {
    constexpr int E = P::V - (P::V >> P::bits(Q));
    constexpr int OFF = P::tw_offset(Q);
#pragma unroll
    for (int e = 0; e < E; ++e) w[e] = __ldg(tw + OFF + e * P::T + t);
  }
}

// Pass Q of a row of 2^LOG held by thread t.  On entry v holds the pass's
// inputs (pass 0 of a row) or they wait in shared buffer `in` (later
// passes, and every pass of a TILE: a four-step block's lines), and w
// holds the pass's twiddles; on exit the outputs are in shared buffer
// `out` or, after the last pass of a row, in `dst`, and w holds the next
// pass's twiddles.
template <int LOG, int Q, bool TILE>
__device__ __forceinline__ void fft_pass(float2 (&v)[Plan<LOG>::V],
                                         float2 (&w)[Plan<LOG>::W],
                                         const float2* __restrict__ tw,
                                         const float2* in, float2* out,
                                         float2* __restrict__ dst, int t,
                                         int base, bool active, float sgn,
                                         float scale) {
  using P = Plan<LOG>;
  constexpr int B = P::bits(Q), R = 1 << B, BF = P::V / R;
  constexpr int NSLOG = P::VLOG * Q, NS = 1 << NSLOG;
  if constexpr (Q > 0 || TILE) {
    __syncthreads();  // pass Q - 1's outputs (or a tile's lines) are in `in`
#pragma unroll
    for (int i = 0; i < BF; ++i) {
      const int j = t + i * P::T;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        v[i * R + r] = in[P::swz(base + j + r * (P::N / R))];
      }
      if constexpr (Q > 0) {
#pragma unroll
        for (int r = 1; r < R; ++r) {
          v[i * R + r] = cmul(v[i * R + r], w[i * (R - 1) + r - 1]);
        }
      }
    }
  }
  load_twiddles<LOG, Q + 1>(w, tw, t);
#pragma unroll
  for (int i = 0; i < BF; ++i) dft_stages<R, R>(v + i * R);
#pragma unroll
  for (int i = 0; i < BF; ++i) {
    const int j = t + i * P::T;
    const int d0 = ((j >> NSLOG) << (NSLOG + B)) + (j & (NS - 1));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 y = v[i * R + r];
      if constexpr (Q == P::PASSES - 1 && !TILE) {
        if (active) {
          dst[d0 + r * NS] = make_float2(__fmul_rn(y.x, scale),
                                         __fmul_rn(__fmul_rn(y.y, sgn), scale));
        }
      } else {
        out[P::swz(base + d0 + r * NS)] = y;
      }
    }
  }
}

template <int LOG, int Q, bool TILE>
__device__ __forceinline__ void fft_passes(float2 (&v)[Plan<LOG>::V],
                                           float2 (&w)[Plan<LOG>::W],
                                           const float2* __restrict__ tw,
                                           float2* s0, float2* s1,
                                           float2* __restrict__ dst, int t,
                                           int base, bool active, float sgn,
                                           float scale) {
  if constexpr (Q < Plan<LOG>::PASSES) {
    // pass Q reads the buffer pass Q - 1 wrote and writes the other one
    fft_pass<LOG, Q, TILE>(v, w, tw, (Q & 1) ? s0 : s1, (Q & 1) ? s1 : s0,
                           dst, t, base, active, sgn, scale);
    fft_passes<LOG, Q + 1, TILE>(v, w, tw, s0, s1, dst, t, base, active, sgn,
                                 scale);
  }
}

// A block walks groups_per_block groups of rows_per_group rows, one row to
// each run of T threads.  sgn = -1 and scale = 1/N give the inverse.
template <int LOG>
__global__ void __launch_bounds__(kMaxThreads)
    fft_rows(const float2* __restrict__ src, float2* __restrict__ dst,
             const float2* __restrict__ tw, long long rows,
             int rows_per_group, int groups_per_block, float sgn,
             float scale) {
  using P = Plan<LOG>;
  extern __shared__ float2 smem[];
  const int rloc = threadIdx.x >> P::TLOG;
  const int t = threadIdx.x & (P::T - 1);
  const int buf = rows_per_group * P::N;
  float2* s0 = smem;
  float2* s1 = smem + buf;
  const int base = rloc * P::N;
  const long long first = (long long)blockIdx.x * groups_per_block;
  for (int gi = 0; gi < groups_per_block; ++gi) {
    const long long row0 = (first + gi) * rows_per_group;
    if (row0 >= rows) break;  // the same for the whole block
    const long long row = row0 + rloc;
    const bool active = row < rows;
    if constexpr (P::PASSES > 1) {
      if (gi > 0) __syncthreads();  // the last group is done with s0, s1
    }
    const float2* x = src + row * P::N;
    float2 v[P::V];
    float2 w[P::W];
    constexpr int R0 = 1 << P::bits(0);  // = V: one butterfly a thread
#pragma unroll
    for (int r = 0; r < R0; ++r) {
      float2 a = make_float2(0.f, 0.f);
      if (active) a = __ldg(x + t + r * (P::N / R0));
      v[r] = make_float2(a.x, __fmul_rn(a.y, sgn));
    }
    fft_passes<LOG, 0, false>(v, w, tw, s0, s1, dst + row * P::N, t, base,
                              active, sgn, scale);
  }
}

// One pass of the four-step FFT of rows of N = 2^LOG M (M = 2^mlog lines
// of 2^LOG a row).  Block (row, b) takes lines b kTile + c, c < kTile, one
// to each run of T threads.  FIRST: line c is column n2 = b kTile + c of the
// row seen as 2^LOG x M (element e at e M + n2), conjugated when sgn = -1;
// element e of its DFT, times step[e M + n2] = w_N^(n2 e), goes to e M + n2
// of the workspace.  Otherwise: line c is workspace row k1 = b kTile + c
// (element e at k1 2^LOG + e); element e of its DFT goes to k1 + e M,
// conjugated when sgn = -1 and scaled.
template <int LOG, bool FIRST>
__global__ void __launch_bounds__(kMaxThreads)
    fft_four_step(const float2* __restrict__ src, float2* __restrict__ dst,
                  const float2* __restrict__ tw,
                  const float2* __restrict__ step, int mlog, float sgn,
                  float scale) {
  using P = Plan<LOG>;
  constexpr int THREADS = kTile * P::T;  // kTile lines of V values a thread
  extern __shared__ float2 smem[];
  float2* s0 = smem;
  float2* s1 = smem + kTile * P::N;
  const int tiles_log = mlog - kTileLog;
  const long long row_off = (long long)(blockIdx.x >> tiles_log)
                            << (LOG + mlog);
  const int col0 = (blockIdx.x & ((1 << tiles_log) - 1)) << kTileLog;
  src += row_off;
  dst += row_off;
  // the tile's lines into s1 (what pass 0 reads), line c at c 2^LOG: in
  // pass 1 a warp reads 4 elements of 8 adjacent columns, in pass 2 32
  // adjacent elements of a workspace row
#pragma unroll
  for (int k = 0; k < P::V; ++k) {
    const int idx = threadIdx.x + k * THREADS;
    int c, e;
    float2 a;
    if constexpr (FIRST) {
      c = idx & (kTile - 1);
      e = idx >> kTileLog;
      a = __ldg(src + ((long long)e << mlog) + col0 + c);
      a.y = __fmul_rn(a.y, sgn);
    } else {
      c = idx >> LOG;
      e = idx & (P::N - 1);
      a = __ldg(src + ((long long)(col0 + c) << LOG) + e);
    }
    s1[P::swz(c * P::N + e)] = a;
  }
  const int rloc = threadIdx.x >> P::TLOG;
  const int t = threadIdx.x & (P::T - 1);
  float2 v[P::V];
  float2 w[P::W];
  fft_passes<LOG, 0, true>(v, w, tw, s0, s1, nullptr, t, rloc * P::N, true,
                           1.0f, 1.0f);
  __syncthreads();  // the last pass's outputs are all in `res`
  const float2* res = ((P::PASSES - 1) & 1) ? s1 : s0;
#pragma unroll
  for (int k = 0; k < P::V; ++k) {
    const int idx = threadIdx.x + k * THREADS;
    const int c = idx & (kTile - 1);
    const int e = idx >> kTileLog;
    const float2 y = res[P::swz(c * P::N + e)];
    const long long off = ((long long)e << mlog) + col0 + c;
    if constexpr (FIRST) {
      dst[off] = cmul(y, __ldg(step + off));
    } else {
      dst[off] = make_float2(__fmul_rn(y.x, scale),
                             __fmul_rn(__fmul_rn(y.y, sgn), scale));
    }
  }
}

constexpr int threads_per_row(int log) { return 1 << (log - values_log(log)); }

// Shared bytes of a block of rows_per_group rows of 2^log: two buffers,
// none for a single pass.
size_t smem_bytes(int log, int rows_per_group) {
  if (log <= values_log(log)) return 0;
  return 2 * ((size_t)rows_per_group << log) * sizeof(float2);
}

template <int LOG>
cudaError_t allow_smem_one() {
  const int rpg = kMaxThreads / threads_per_row(LOG);
  return cudaFuncSetAttribute(fft_rows<LOG>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes(LOG, rpg));
}

// Shared bytes of a four-step block over lines of 2^log: two buffers of
// kTile lines.
size_t tile_smem_bytes(int log) {
  return 2 * ((size_t)kTile << log) * sizeof(float2);
}

template <int LOG, bool FIRST>
cudaError_t allow_smem_tile() {
  return cudaFuncSetAttribute(fft_four_step<LOG, FIRST>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)tile_smem_bytes(LOG));
}

// The opt-in above 48 KB for every N of more than one pass (a block of 512
// threads holds up to 8192 values, two buffers of them take 128 KB), at
// the most any rows_per_group the wrapper gives, and for the four-step
// passes (up to 128 KB over lines of 1024), once per device.
cudaError_t allow_smem() {
  static std::atomic<int> allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (allowed[dev].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t errs[] = {
      allow_smem_one<4>(),  allow_smem_one<5>(),  allow_smem_one<6>(),
      allow_smem_one<7>(),  allow_smem_one<8>(),  allow_smem_one<9>(),
      allow_smem_one<10>(), allow_smem_one<11>(), allow_smem_one<12>(),
      allow_smem_one<13>(),
      allow_smem_tile<7, true>(),  allow_smem_tile<7, false>(),
      allow_smem_tile<8, true>(),  allow_smem_tile<8, false>(),
      allow_smem_tile<9, true>(),  allow_smem_tile<9, false>(),
      allow_smem_tile<10, true>(), allow_smem_tile<10, false>()};
  for (const cudaError_t e : errs) {
    if (e != cudaSuccess) return e;
  }
  allowed[dev].store(1, std::memory_order_release);
  return cudaSuccess;
}

template <int LOG>
void launch(const float2* in, float2* out, const float2* tw, long long rows,
            int threads, int rpg, int gpb, long long grid, int smem,
            float sgn, float scale, cudaStream_t stream) {
  fft_rows<LOG><<<(unsigned)grid, threads, smem, stream>>>(
      in, out, tw, rows, rpg, gpb, sgn, scale);
}

template <int LOG, bool FIRST>
void launch_tile(const float2* in, float2* out, const float2* tw,
                 const float2* step, long long grid, int mlog, int smem,
                 float sgn, float scale, cudaStream_t stream) {
  fft_four_step<LOG, FIRST><<<(unsigned)grid, kTile * Plan<LOG>::T, smem,
                              stream>>>(in, out, tw, step, mlog, sgn, scale);
}

// One four-step pass over lines of 2^log, mlog lines a row.
void launch_four_step_pass(bool first, int log, const float2* in,
                           float2* out, const float2* tw, const float2* step,
                           long long grid, int mlog, int smem, float sgn,
                           float scale, cudaStream_t st) {
  switch (log * 2 + (first ? 1 : 0)) {
#define RIMMS_FFT4_CASE(L)                                                  \
  case 2 * L + 1:                                                           \
    launch_tile<L, true>(in, out, tw, step, grid, mlog, smem, sgn, scale,  \
                         st);                                               \
    break;                                                                  \
  case 2 * L:                                                               \
    launch_tile<L, false>(in, out, tw, step, grid, mlog, smem, sgn, scale, \
                          st);                                              \
    break;
    RIMMS_FFT4_CASE(7) RIMMS_FFT4_CASE(8) RIMMS_FFT4_CASE(9)
    RIMMS_FFT4_CASE(10)
#undef RIMMS_FFT4_CASE
  }
}

}  // namespace

// One call's geometry, built once per (device, n, rows, block_rows,
// inverse) by the wrapper (repro_torch.kernels.fft.fft.launch_plan) and
// passed by address, so that a call converts four arguments, not twelve.
struct FftLaunch {
  const void* twiddles;  // n's pass table (fft.pass_twiddles), this device
  long long rows;
  long long grid;
  int n;
  int inverse;
  int threads;  // rows_per_group * threads_per_row(log2 n)
  int rows_per_group;
  int groups_per_block;  // grid * groups_per_block * rows_per_group >= rows
  int smem;              // smem_bytes(log2 n, rows_per_group)
};

// in, out: p->rows x p->n complex64 (interleaved float2), distinct; in
// 8-byte aligned, at any element.  The geometry in *p is checked here.
// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int rimms_fft_c64(const void* in, void* out, const FftLaunch* p,
                             void* stream) {
  const int n = p->n, threads = p->threads, rpg = p->rows_per_group;
  const int gpb = p->groups_per_block, smem = p->smem;
  const long long rows = p->rows, grid = p->grid;
  int log = 0;
  while (log < 31 && (1 << log) < n) ++log;
  if (n < 2 || log > kMaxLog || (1 << log) != n || rows < 0 || rpg < 1 ||
      gpb < 1 || grid < 0 || grid > 0x7fffffffLL ||
      threads != rpg * threads_per_row(log) || threads > kMaxThreads ||
      (size_t)smem != smem_bytes(log, rpg) || grid * gpb * rpg < rows) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_smem();
    if (err != cudaSuccess) return (int)err;
  }
  const float sgn = p->inverse ? -1.0f : 1.0f;
  const float scale = p->inverse ? 1.0f / (float)n : 1.0f;
  const auto* x = (const float2*)in;
  auto* y = (float2*)out;
  const auto* tw = (const float2*)p->twiddles;
  const auto st = (cudaStream_t)stream;
  switch (log) {
#define RIMMS_FFT_CASE(L)                                                   \
  case L:                                                                   \
    launch<L>(x, y, tw, rows, threads, rpg, gpb, grid, smem, sgn, scale, st); \
    break;
    RIMMS_FFT_CASE(1) RIMMS_FFT_CASE(2) RIMMS_FFT_CASE(3) RIMMS_FFT_CASE(4)
    RIMMS_FFT_CASE(5) RIMMS_FFT_CASE(6) RIMMS_FFT_CASE(7) RIMMS_FFT_CASE(8)
    RIMMS_FFT_CASE(9) RIMMS_FFT_CASE(10) RIMMS_FFT_CASE(11)
    RIMMS_FFT_CASE(12) RIMMS_FFT_CASE(13)
#undef RIMMS_FFT_CASE
  }
  return (int)cudaGetLastError();
}

// One four-step call's tables, built once per (device, n, rows, inverse)
// by the wrapper (repro_torch.kernels.fft.fft._launch4_args).  The
// geometry is N's alone and derived here.
struct Fft4Launch {
  const void* twiddles1;  // the N1-point pass table (fft.pass_twiddles)
  const void* twiddles2;  // the N2-point pass table
  const void* step;       // w_N^(n2 k1) at k1 N2 + n2 (fft.step_twiddles)
  long long rows;
  int n;
  int inverse;
};

// in, out, work: p->rows x p->n complex64, distinct; in 8-byte aligned, at
// any element; work the wrapper's scratch.  n a power of two from 2^14 to
// 2^20, N = N1 N2 with N1 = 2^ceil(log2 n / 2).  Pass 1 takes the N2
// columns of each row, pass 2 the N1 workspace rows, kTile lines a block
// (kTile * threads_per_row threads, two shared buffers of the lines).
// Launches pass 1 (in -> work) and pass 2 (work -> out) on `stream`;
// returns the first CUDA error (0 on success), or cudaErrorInvalidValue
// for arguments it does not take.
extern "C" int rimms_fft4_c64(const void* in, void* out, void* work,
                              const Fft4Launch* p, void* stream) {
  const int n = p->n;
  const long long rows = p->rows;
  int log = 0;
  while (log < 31 && (1 << log) < n) ++log;
  const int l1 = log - log / 2, l2 = log / 2;
  if ((1 << log) != n || log <= kMaxLog || log > kMaxLog4 || rows < 0 ||
      p->twiddles1 == nullptr || p->twiddles2 == nullptr ||
      p->step == nullptr || work == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const long long grid1 = rows << (l2 - kTileLog);
  const long long grid2 = rows << (l1 - kTileLog);
  if (grid1 > 0x7fffffffLL || grid2 > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  const int smem1 = (int)tile_smem_bytes(l1), smem2 = (int)tile_smem_bytes(l2);
  if (smem1 > 48 * 1024 || smem2 > 48 * 1024) {
    const cudaError_t err = allow_smem();
    if (err != cudaSuccess) return (int)err;
  }
  const float sgn = p->inverse ? -1.0f : 1.0f;
  const float scale = p->inverse ? 1.0f / (float)n : 1.0f;
  const auto st = (cudaStream_t)stream;
  auto* ws = (float2*)work;
  launch_four_step_pass(true, l1, (const float2*)in, ws,
                        (const float2*)p->twiddles1, (const float2*)p->step,
                        grid1, l2, smem1, sgn, 1.0f, st);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launch_four_step_pass(false, l2, ws, (float2*)out,
                        (const float2*)p->twiddles2, nullptr, grid2, l1,
                        smem2, sgn, scale, st);
  return (int)cudaGetLastError();
}
