// Batched FFT over complex64 rows, for Hopper (sm_90a): radix-8 and
// radix-16 passes in registers, twiddles from a table.
//
// Replaces the Pallas kernel src/repro/kernels/fft/fft.py::_fft_kernel
// (launched by fft_planes): the forward DFT along each row, or the inverse
// scaled by 1/N, of N = 2^p complex values, p from 1 to 21, in natural
// order: one launch of fft_rows up to N = 8192, two of fft_four_step above
// (see "Above 8192" below).  Any other length N from 3 to 2^20 goes through
// Bluestein's chirp-z algorithm, also here (see "Bluestein" at the end of
// this note): a convolution of length M = the power of two >= 2N - 1, so
// N = 2^20 - 1 takes inner transforms of 2^21 -- the reason for p 21.  The
// inverse is computed as
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
// 2^ceil(p/2), N2 = 2^floor(p/2): 2048 x 1024 at N = 2^21, both <= 1024
// below) goes through
// the four-step (Bailey) algorithm in two launches of fft_four_step, with
// the row seen as N1 x N2 (element n1 N2 + n2):
//   pass 1: the N1-point DFT of each column n2, times w_N^(n2 k1), into a
//           workspace row of the wrapper's at k1 N2 + n2;
//   pass 2: the N2-point DFT of each workspace row k1, into the output at
//           k1 + N1 k2 -- the transposed, natural order.
// Each block takes 8 adjacent lines (columns in pass 1, workspace
// rows in pass 2) so every strided load and store is a 64-byte run of
// adjacent lines: whole sectors.  Lines of 2048 (pass 1 at N = 2^21) go 4
// a block: 8 would take 1024 threads and 256 KB of exchange buffers, 4
// take 512 threads and 128 KB, and a 32-byte run is still a whole sector.
// The block copies its lines into shared memory, runs the same register
// passes on them as fft_rows (thread layout,
// twiddle tables and swizzle of an N1- or N2-point row), and copies the
// result out; the step twiddles w_N^(n2 k1) come from a table of N entries
// laid out as the workspace (computed in float64 and rounded once by the
// wrapper), read coalesced beside the stores.  A strided copy puts a
// half-warp's 16 accesses on TILE lines at 16 / TILE elements each; the
// rows' swizzle alone sends every line's element e to one bank pair (an
// 8-way conflict on every copy), so line c of a tile also XORs c 16 / TILE
// into its bank bits (tile_xor): the copies land in 16 distinct bank pairs
// at every line length, and the passes, whose half-warps never leave a
// line, keep a conflict-free exchange (tests/test_torch_fft_plan.py walks
// both).  The inverse conjugates on
// pass 1's loads and pass 2's stores.  A row's blocks and arithmetic depend
// on N alone, so neither the batch nor block_rows changes its bits.  It
// moves each value through device memory twice (2 x 16 N bytes, and 8 N of
// step twiddles), so two passes over the data bound it; a one-pass design
// (a row in the shared memory of a thread-block cluster) would halve that.
// Pass 1's loads are 64-byte runs 16 KB apart at 2^20: what is left of its
// time beyond the bytes.
//
// Bluestein.  With w_k = exp(-+ i pi k^2 / N) (kernels/fft/bluestein.py
// builds the chirp w and the filter's spectrum, one table each per N and
// direction), the DFT is w_k times the circular convolution of x w with
// the filter, which the FFT of length M computes: forward FFT of x w
// zero-padded to M, product with the spectrum, inverse FFT (scale 1/M),
// product with w, the first N values.  Every step is the arithmetic of
// the launches it replaces (the chirp and spectrum products are zip.cu's,
// the passes fft_rows' or fft_four_step's), in their order, so the output
// has their composition's bits; only the data stays on the chip between
// them.  Up to M = 8192 (N <= 4096) bluestein_rows does it all in one
// launch, with launch_plan's geometry of M (block_rows as in fft_rows): a
// row's threads load x times w straight into registers (zeros past N: no
// padded buffer), run the forward passes, the last one storing its
// result times the spectrum, conjugated, into shared memory, where the
// inverse's first pass reads it after one barrier, and store times w only
// the first N.
// Above, four launches of fft_four_step carry the products at their edges:
// forward pass 1 loads x w (zeros past N), forward pass 2 stores, inverse
// pass 1 loads that times the spectrum, inverse pass 2 stores times w only
// the first N; a row's workspace is two buffers of M.

#include <cuda_runtime.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kMaxLog = 13;     // one launch of fft_rows
constexpr int kMaxLog4 = 21;    // two launches of fft_four_step
constexpr int kMaxThreads = 512;
constexpr int kMaxDevices = 64;
// lines a four-step block takes side by side: 8 complex64 = 64 bytes (log2)
constexpr int kTileLog = 3;
// log2 of the lines a four-step block takes for lines of 2^log: 8, and
// half as many for 2048 (the launch bound's 512 threads, 128 KB)
__host__ __device__ constexpr int tile_log(int log) {
  return log > 10 ? kTileLog - 1 : kTileLog;
}

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

// What the last pass of a row does with element e of the result: put(e,
// value), or with NoPut leave it in shared memory as the passes before.
struct NoPut {
  __device__ __forceinline__ void operator()(int, float2) const {}
};

// The last pass's store of fft_rows: conjugated (sgn = -1) and scaled.
struct RowStore {
  float2* __restrict__ dst;
  bool active;
  float sgn, scale;
  __device__ __forceinline__ void operator()(int e, float2 y) const {
    if (active) {
      dst[e] = make_float2(__fmul_rn(y.x, scale),
                           __fmul_rn(__fmul_rn(y.y, sgn), scale));
    }
  }
};

// Pass Q of a row of 2^LOG held by thread t.  On entry v holds the pass's
// inputs (pass 0 of a row loaded from device memory) or they wait in
// shared buffer `in` (later passes, and pass 0 when IN0: a four-step
// block's lines, Bluestein's inverse); w holds the pass's twiddles.  On
// exit the outputs are in shared buffer `out` or, after the last pass
// unless Put is NoPut, handed to `put`; w holds the next pass's twiddles.
// Element e of the line at `base` is stored at swz(base + e) ^ lx (lx:
// tile_xor of a four-step line, else 0).
template <int LOG, int Q, bool IN0, class Put>
__device__ __forceinline__ void fft_pass(float2 (&v)[Plan<LOG>::V],
                                         float2 (&w)[Plan<LOG>::W],
                                         const float2* __restrict__ tw,
                                         const float2* in, float2* out, int t,
                                         int base, int lx, const Put& put) {
  using P = Plan<LOG>;
  constexpr int B = P::bits(Q), R = 1 << B, BF = P::V / R;
  constexpr int NSLOG = P::VLOG * Q, NS = 1 << NSLOG;
  constexpr bool OUT = !std::is_same_v<Put, NoPut>;
  if constexpr (Q > 0 || IN0) {
    __syncthreads();  // pass Q - 1's outputs (or a tile's lines) are in `in`
#pragma unroll
    for (int i = 0; i < BF; ++i) {
      const int j = t + i * P::T;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        v[i * R + r] = in[P::swz(base + j + r * (P::N / R)) ^ lx];
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
      if constexpr (Q == P::PASSES - 1 && OUT) {
        put(d0 + r * NS, v[i * R + r]);
      } else {
        out[P::swz(base + d0 + r * NS) ^ lx] = v[i * R + r];
      }
    }
  }
}

template <int LOG, int Q, bool IN0, class Put>
__device__ __forceinline__ void fft_passes(float2 (&v)[Plan<LOG>::V],
                                           float2 (&w)[Plan<LOG>::W],
                                           const float2* __restrict__ tw,
                                           float2* s0, float2* s1, int t,
                                           int base, int lx, const Put& put) {
  if constexpr (Q < Plan<LOG>::PASSES) {
    // pass Q reads the buffer pass Q - 1 wrote and writes the other one
    fft_pass<LOG, Q, IN0>(v, w, tw, (Q & 1) ? s0 : s1, (Q & 1) ? s1 : s0, t,
                          base, lx, put);
    fft_passes<LOG, Q + 1, IN0>(v, w, tw, s0, s1, t, base, lx, put);
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
    fft_passes<LOG, 0, false>(
        v, w, tw, s0, s1, t, base, 0,
        RowStore{dst + row * P::N, active, sgn, scale});
  }
}

// Bluestein's forward leaves element e of its result times the spectrum,
// conjugated -- the inverse's input -- where its last pass would store it
// in shared memory (res, the line at base).
template <int LOG>
struct SpectrumConj {
  float2* res;
  const float2* __restrict__ spectrum;
  int base;
  __device__ __forceinline__ void operator()(int e, float2 y) const {
    const float2 b = cmul(y, __ldg(spectrum + e));
    res[Plan<LOG>::swz(base + e)] = make_float2(b.x, __fmul_rn(b.y, -1.0f));
  }
};

// Bluestein's last store: the inverse's conjugate scaled by 1/M, times the
// chirp, for the first n elements only.
struct ChirpStore {
  float2* __restrict__ dst;
  const float2* __restrict__ chirp;
  int n;
  bool active;
  float scale;
  __device__ __forceinline__ void operator()(int e, float2 y) const {
    if (active && e < n) {
      dst[e] = cmul(make_float2(__fmul_rn(y.x, scale),
                                __fmul_rn(__fmul_rn(y.y, -1.0f), scale)),
                    __ldg(chirp + e));
    }
  }
};

// Bluestein's DFT of rows of n (src and dst rows n apart) through inner
// transforms of M = 2^LOG <= 8192, in one launch with fft_rows' geometry
// of M: load x w (zeros past n), the forward passes into shared memory
// (the last one stores times the spectrum, conjugated), the inverse
// passes from there, store times w for e < n.  scale = 1/M.  Two shared
// buffers of a group's rows, even for one pass.
template <int LOG>
__global__ void __launch_bounds__(kMaxThreads)
    bluestein_rows(const float2* __restrict__ src, float2* __restrict__ dst,
                   const float2* __restrict__ tw,
                   const float2* __restrict__ chirp,
                   const float2* __restrict__ spectrum, long long rows,
                   int n, int rows_per_group, int groups_per_block,
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
  constexpr int R0 = 1 << P::bits(0);  // = V: one butterfly a thread
  for (int gi = 0; gi < groups_per_block; ++gi) {
    const long long row0 = (first + gi) * rows_per_group;
    if (row0 >= rows) break;  // the same for the whole block
    const long long row = row0 + rloc;
    const bool active = row < rows;
    if (gi > 0) __syncthreads();  // the last group is done with s0, s1
    const float2* x = src + row * n;
    float2 v[P::V];
    float2 w[P::W];
#pragma unroll
    for (int r = 0; r < R0; ++r) {
      const int e = t + r * (P::N / R0);
      v[r] = make_float2(0.f, 0.f);
      if (active && e < n) v[r] = cmul(__ldg(x + e), __ldg(chirp + e));
    }
    // the forward's last pass writes s0 after an odd number of passes
    float2* res = (P::PASSES & 1) ? s0 : s1;
    fft_passes<LOG, 0, false>(v, w, tw, s0, s1, t, base, 0,
                              SpectrumConj<LOG>{res, spectrum, base});
    // the inverse's first pass reads res and writes the other buffer
    const ChirpStore store{dst + row * n, chirp, n, active, scale};
    if constexpr (P::PASSES & 1) {
      fft_passes<LOG, 0, true>(v, w, tw, s1, s0, t, base, 0, store);
    } else {
      fft_passes<LOG, 0, true>(v, w, tw, s0, s1, t, base, 0, store);
    }
  }
}

// What a four-step pass does at its edges besides the plain FFT's: the
// plain pass, Bluestein's chirp (pass 1 loads x w, zeros past n; pass 2
// stores times w, the first n only), Bluestein's spectrum (pass 1 loads
// the forward's output times the spectrum).
enum FourStepEdge : int { kPlain = 0, kChirp = 1, kSpectrum = 2 };

// The bank bits line c of a four-step tile over lines of 2^LOG adds to
// the swizzle: c 16 / TILE, so a strided copy's TILE lines at one element
// land in distinct bank pairs (fft.py tile_slot mirrors it).
template <int LOG>
__device__ __forceinline__ int tile_xor(int c) {
  return (c << (4 - tile_log(LOG))) & 15;
}

// One pass of the four-step FFT of rows of N = 2^LOG M (M = 2^mlog lines
// of 2^LOG a row; row r at src + r src_stride, dst + r dst_stride).  Block
// (row, b) takes lines b TILE + c, c < TILE, one to each run of T
// threads.  FIRST: line c is column n2 = b TILE + c of the row seen as
// 2^LOG x M (element e at e M + n2), conjugated when sgn = -1; element e
// of its DFT, times step[e M + n2] = w_N^(n2 e), goes to e M + n2 of the
// workspace.  Otherwise: line c is workspace row k1 = b TILE + c (element
// e at k1 2^LOG + e); element e of its DFT goes to k1 + e M, conjugated
// when sgn = -1 and scaled.  EDGE (Bluestein's): FIRST with kChirp loads
// x w (aux the chirp; zeros from element n on), with kSpectrum x times
// aux (the spectrum); otherwise kChirp stores times aux for elements
// below n only.
template <int LOG, bool FIRST, int EDGE>
__global__ void __launch_bounds__(kMaxThreads)
    fft_four_step(const float2* __restrict__ src, float2* __restrict__ dst,
                  const float2* __restrict__ tw,
                  const float2* __restrict__ step,
                  const float2* __restrict__ aux, long long src_stride,
                  long long dst_stride, int n, int mlog, float sgn,
                  float scale) {
  using P = Plan<LOG>;
  constexpr int TL = tile_log(LOG), TILE = 1 << TL;  // lines a block
  constexpr int THREADS = TILE * P::T;  // TILE lines of V values a thread
  extern __shared__ float2 smem[];
  float2* s0 = smem;
  float2* s1 = smem + TILE * P::N;
  const int tiles_log = mlog - TL;
  const long long row = blockIdx.x >> tiles_log;
  const int col0 = (blockIdx.x & ((1 << tiles_log) - 1)) << TL;
  src += row * src_stride;
  dst += row * dst_stride;
  // the tile's lines into s1 (what pass 0 reads), line c at c 2^LOG: in
  // pass 1 a warp reads 4 elements of 8 adjacent columns, in pass 2 32
  // adjacent elements of a workspace row
#pragma unroll
  for (int k = 0; k < P::V; ++k) {
    const int idx = threadIdx.x + k * THREADS;
    int c, e;
    float2 a;
    if constexpr (FIRST) {
      c = idx & (TILE - 1);
      e = idx >> TL;
      const long long off = ((long long)e << mlog) + col0 + c;
      if constexpr (EDGE == kChirp) {
        a = make_float2(0.f, 0.f);
        if (off < n) a = cmul(__ldg(src + off), __ldg(aux + off));
      } else if constexpr (EDGE == kSpectrum) {
        a = cmul(__ldg(src + off), __ldg(aux + off));
      } else {
        a = __ldg(src + off);
      }
      a.y = __fmul_rn(a.y, sgn);
    } else {
      c = idx >> LOG;
      e = idx & (P::N - 1);
      a = __ldg(src + ((long long)(col0 + c) << LOG) + e);
    }
    s1[P::swz(c * P::N + e) ^ tile_xor<LOG>(c)] = a;
  }
  const int rloc = threadIdx.x >> P::TLOG;
  const int t = threadIdx.x & (P::T - 1);
  float2 v[P::V];
  float2 w[P::W];
  fft_passes<LOG, 0, true>(v, w, tw, s0, s1, t, rloc * P::N,
                           tile_xor<LOG>(rloc), NoPut{});
  __syncthreads();  // the last pass's outputs are all in `res`
  const float2* res = ((P::PASSES - 1) & 1) ? s1 : s0;
#pragma unroll
  for (int k = 0; k < P::V; ++k) {
    const int idx = threadIdx.x + k * THREADS;
    const int c = idx & (TILE - 1);
    const int e = idx >> TL;
    const float2 y = res[P::swz(c * P::N + e) ^ tile_xor<LOG>(c)];
    const long long off = ((long long)e << mlog) + col0 + c;
    if constexpr (FIRST) {
      dst[off] = cmul(y, __ldg(step + off));
    } else {
      const float2 z = make_float2(__fmul_rn(y.x, scale),
                                   __fmul_rn(__fmul_rn(y.y, sgn), scale));
      if constexpr (EDGE == kChirp) {
        if (off < n) dst[off] = cmul(z, __ldg(aux + off));
      } else {
        dst[off] = z;
      }
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

// Shared bytes of a bluestein_rows block: two buffers, even for one pass
// (the forward's output waits there for the inverse).
size_t bluestein_smem_bytes(int log, int rows_per_group) {
  return 2 * ((size_t)rows_per_group << log) * sizeof(float2);
}

template <int LOG>
cudaError_t allow_smem_one() {
  const int rpg = kMaxThreads / threads_per_row(LOG);
  if constexpr (LOG > values_log(LOG)) {  // fft_rows: more than one pass
    const cudaError_t err = cudaFuncSetAttribute(
        fft_rows<LOG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(LOG, rpg));
    if (err != cudaSuccess) return err;
  }
  return cudaFuncSetAttribute(bluestein_rows<LOG>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bluestein_smem_bytes(LOG, rpg));
}

// Shared bytes of a four-step block over lines of 2^log: two buffers of
// its 2^tile_log(log) lines.
size_t tile_smem_bytes(int log) {
  return 2 * ((size_t)1 << (tile_log(log) + log)) * sizeof(float2);
}

template <int LOG, bool FIRST, int EDGE>
cudaError_t allow_smem_tile() {
  return cudaFuncSetAttribute(fft_four_step<LOG, FIRST, EDGE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)tile_smem_bytes(LOG));
}

// Every four-step instance: pass 1 over lines of 2^7 to 2^11 (plain, and
// Bluestein's two loads), pass 2 over lines of 2^7 to 2^10 (plain, and
// Bluestein's store).
template <int LOG>
cudaError_t allow_smem_tiles() {
  const cudaError_t errs[] = {allow_smem_tile<LOG, true, kPlain>(),
                              allow_smem_tile<LOG, true, kChirp>(),
                              allow_smem_tile<LOG, true, kSpectrum>()};
  for (const cudaError_t e : errs) {
    if (e != cudaSuccess) return e;
  }
  if constexpr (LOG <= 10) {
    const cudaError_t e2[] = {allow_smem_tile<LOG, false, kPlain>(),
                              allow_smem_tile<LOG, false, kChirp>()};
    for (const cudaError_t e : e2) {
      if (e != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}

// The opt-in above 48 KB for every N of more than one pass (a block of 512
// threads holds up to 8192 values, two buffers of them take 128 KB), and
// for every bluestein_rows instance (64 KB at 512 rows of 8), at the most
// any rows_per_group the wrapper gives, and for the four-step passes (up
// to 128 KB over 8 lines of 1024 or 4 of 2048), once per device.
cudaError_t allow_smem() {
  static std::atomic<int> allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (allowed[dev].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t errs[] = {
      allow_smem_one<3>(),   allow_smem_one<4>(),  allow_smem_one<5>(),
      allow_smem_one<6>(),   allow_smem_one<7>(),  allow_smem_one<8>(),
      allow_smem_one<9>(),   allow_smem_one<10>(), allow_smem_one<11>(),
      allow_smem_one<12>(),  allow_smem_one<13>(), allow_smem_tiles<7>(),
      allow_smem_tiles<8>(), allow_smem_tiles<9>(), allow_smem_tiles<10>(),
      allow_smem_tiles<11>()};
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

// One four-step pass's arguments besides the instance.
struct TileArgs {
  const float2* in;
  float2* out;
  const float2* tw;
  const float2* step;
  const float2* aux;
  long long in_stride, out_stride, grid;
  int n, mlog, smem;
  float sgn, scale;
};

template <int LOG, bool FIRST, int EDGE>
void launch_tile(const TileArgs& a, cudaStream_t stream) {
  fft_four_step<LOG, FIRST, EDGE><<<(unsigned)a.grid,
                                    (1 << tile_log(LOG)) * Plan<LOG>::T,
                                    a.smem, stream>>>(
      a.in, a.out, a.tw, a.step, a.aux, a.in_stride, a.out_stride, a.n,
      a.mlog, a.sgn, a.scale);
}

template <int LOG>
void launch_tile_edge(bool first, int edge, const TileArgs& a,
                      cudaStream_t st) {
  if (first) {
    if (edge == kChirp) {
      launch_tile<LOG, true, kChirp>(a, st);
    } else if (edge == kSpectrum) {
      launch_tile<LOG, true, kSpectrum>(a, st);
    } else {
      launch_tile<LOG, true, kPlain>(a, st);
    }
  } else if constexpr (LOG <= 10) {  // pass 2's lines are at most 1024
    if (edge == kChirp) {
      launch_tile<LOG, false, kChirp>(a, st);
    } else {
      launch_tile<LOG, false, kPlain>(a, st);
    }
  }
}

// One four-step pass over lines of 2^log (7 to 11; pass 2's to 10).
void launch_four_step_pass(bool first, int log, int edge, const TileArgs& a,
                           cudaStream_t st) {
  switch (log) {
    case 7: launch_tile_edge<7>(first, edge, a, st); break;
    case 8: launch_tile_edge<8>(first, edge, a, st); break;
    case 9: launch_tile_edge<9>(first, edge, a, st); break;
    case 10: launch_tile_edge<10>(first, edge, a, st); break;
    case 11: launch_tile_edge<11>(first, edge, a, st); break;
  }
}

// Both passes of the four-step FFT of rows of 2^log (14 to 21): in ->
// work (pass 1, edge1) -> out (pass 2, edge2), rows in_stride and
// out_stride apart, the workspace's 2^log.  Returns the first CUDA error.
cudaError_t four_step(int log, long long rows, const float2* in,
                      long long in_stride, float2* work, float2* out,
                      long long out_stride, const float2* tw1,
                      const float2* tw2, const float2* step, int edge1,
                      int edge2, const float2* aux1, const float2* aux2,
                      int n, float sgn, float scale, cudaStream_t st) {
  const int l1 = log - log / 2, l2 = log / 2;
  const long long m = 1LL << log;
  const TileArgs pass1{in,  work, tw1, step, aux1, in_stride, m,
                       rows << (l2 - tile_log(l1)),   n, l2,
                       (int)tile_smem_bytes(l1), sgn, 1.0f};
  launch_four_step_pass(true, l1, edge1, pass1, st);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const TileArgs pass2{work, out, tw2, nullptr, aux2, m, out_stride,
                       rows << (l1 - tile_log(l2)),      n, l1,
                       (int)tile_smem_bytes(l2), sgn, scale};
  launch_four_step_pass(false, l2, edge2, pass2, st);
  return cudaGetLastError();
}

// log2 of n, or 31 if n is not a power of two below 2^31
int exact_log(int n) {
  int log = 0;
  while (log < 31 && (1 << log) < n) ++log;
  return (1 << log) == n ? log : 31;
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
  const int log = exact_log(n);
  if (n < 2 || log > kMaxLog || rows < 0 || rpg < 1 ||
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
// 2^21, N = N1 N2 with N1 = 2^ceil(log2 n / 2).  Pass 1 takes the N2
// columns of each row, pass 2 the N1 workspace rows, 2^tile_log lines a
// block (that many times threads_per_row threads, two shared buffers of
// the lines).
// Launches pass 1 (in -> work) and pass 2 (work -> out) on `stream`;
// returns the first CUDA error (0 on success), or cudaErrorInvalidValue
// for arguments it does not take.
extern "C" int rimms_fft4_c64(const void* in, void* out, void* work,
                              const Fft4Launch* p, void* stream) {
  const int n = p->n;
  const long long rows = p->rows;
  const int log = exact_log(n);
  const int l1 = log - log / 2, l2 = log / 2;
  if (log <= kMaxLog || log > kMaxLog4 || rows < 0 ||
      p->twiddles1 == nullptr || p->twiddles2 == nullptr ||
      p->step == nullptr || work == nullptr ||
      (rows << (l2 - tile_log(l1))) > 0x7fffffffLL ||
      (rows << (l1 - tile_log(l2))) > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  const float sgn = p->inverse ? -1.0f : 1.0f;
  const float scale = p->inverse ? 1.0f / (float)n : 1.0f;
  return (int)four_step(log, rows, (const float2*)in, n, (float2*)work,
                        (float2*)out, n, (const float2*)p->twiddles1,
                        (const float2*)p->twiddles2, (const float2*)p->step,
                        kPlain, kPlain, nullptr, nullptr, n, sgn, scale,
                        (cudaStream_t)stream);
}

// One Bluestein call's tables and geometry, built once per (device, n,
// rows, block_rows, inverse) by the wrapper
// (repro_torch.kernels.fft.bluestein._launch_args).  M = m, the inner
// length: up to 8192 one launch of bluestein_rows with launch_plan's
// geometry of M (grid, threads, rows_per_group, groups_per_block, smem =
// bluestein_smem_bytes), above four four-step launches (geometry derived
// here, those fields 0).
struct BluesteinLaunch {
  const void* twiddles1;  // M's pass table, or M1's above 8192
  const void* twiddles2;  // M2's pass table above 8192, else null
  const void* step;       // M's step twiddles above 8192, else null
  const void* chirp;      // w_k, k < n (bluestein.chirp)
  const void* spectrum;   // the filter's spectrum, M values
  long long rows;
  long long grid;
  int n;
  int m;
  int threads;
  int rows_per_group;
  int groups_per_block;
  int smem;
};

// in, out: p->rows x p->n complex64, distinct; in 8-byte aligned, at any
// element.  work: 2 p->rows x p->m complex64 above M = 8192 (the
// four-step's workspace, then the forward transform), unused below.  n
// from 3 to 2^20, m the least power of two >= 2n - 1.  Launches on
// `stream`; returns the first CUDA error (0 on success), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int rimms_bluestein_c64(const void* in, void* out, void* work,
                                   const BluesteinLaunch* p, void* stream) {
  const int n = p->n, m = p->m;
  const long long rows = p->rows;
  const int log = exact_log(m);
  if (n < 3 || log > kMaxLog4 || (long long)m < 2LL * n - 1 ||
      m / 2 >= 2 * n - 1 || rows < 0 || p->twiddles1 == nullptr ||
      p->chirp == nullptr || p->spectrum == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* x = (const float2*)in;
  auto* y = (float2*)out;
  const auto* chirp = (const float2*)p->chirp;
  const auto* spec = (const float2*)p->spectrum;
  const auto* tw1 = (const float2*)p->twiddles1;
  const float scale = 1.0f / (float)m;
  const auto st = (cudaStream_t)stream;
  if (log <= kMaxLog) {
    const int threads = p->threads, rpg = p->rows_per_group;
    const int gpb = p->groups_per_block, smem = p->smem;
    const long long grid = p->grid;
    if (rpg < 1 || gpb < 1 || grid < 0 || grid > 0x7fffffffLL ||
        threads != rpg * threads_per_row(log) || threads > kMaxThreads ||
        (size_t)smem != bluestein_smem_bytes(log, rpg) ||
        grid * gpb * rpg < rows) {
      return (int)cudaErrorInvalidValue;
    }
    if (rows == 0) return 0;
    if (smem > 48 * 1024) {
      const cudaError_t err = allow_smem();
      if (err != cudaSuccess) return (int)err;
    }
    switch (log) {
#define RIMMS_BLUESTEIN_CASE(L)                                            \
  case L:                                                                  \
    bluestein_rows<L><<<(unsigned)grid, threads, smem, st>>>(              \
        x, y, tw1, chirp, spec, rows, n, rpg, gpb, scale);                 \
    break;
      RIMMS_BLUESTEIN_CASE(3) RIMMS_BLUESTEIN_CASE(4) RIMMS_BLUESTEIN_CASE(5)
      RIMMS_BLUESTEIN_CASE(6) RIMMS_BLUESTEIN_CASE(7) RIMMS_BLUESTEIN_CASE(8)
      RIMMS_BLUESTEIN_CASE(9) RIMMS_BLUESTEIN_CASE(10)
      RIMMS_BLUESTEIN_CASE(11) RIMMS_BLUESTEIN_CASE(12)
      RIMMS_BLUESTEIN_CASE(13)
#undef RIMMS_BLUESTEIN_CASE
    }
    return (int)cudaGetLastError();
  }
  const int l1 = log - log / 2, l2 = log / 2;
  if (p->twiddles2 == nullptr || p->step == nullptr || work == nullptr ||
      (rows << (l2 - tile_log(l1))) > 0x7fffffffLL ||
      (rows << (l1 - tile_log(l2))) > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  const auto* tw2 = (const float2*)p->twiddles2;
  const auto* step = (const float2*)p->step;
  auto* ws = (float2*)work;             // the four-step's workspace
  float2* fwd = ws + rows * (long long)m;  // the forward transform
  // forward: x w (zeros past n) -> ws -> fwd, as the plain FFT's passes
  err = four_step(log, rows, x, n, ws, fwd, m, tw1, tw2, step, kChirp,
                  kPlain, chirp, nullptr, n, 1.0f, 1.0f, st);
  if (err != cudaSuccess) return (int)err;
  // inverse: fwd times the spectrum, conjugated -> ws -> out, conjugated,
  // scaled, times w, the first n only
  return (int)four_step(log, rows, fwd, m, ws, y, n, tw1, tw2, step,
                        kSpectrum, kChirp, spec, chirp, n, -1.0f, scale, st);
}
