// Online-softmax ("flash") attention, causal or not, with grouped K/V heads,
// over float32 or bfloat16, for Hopper (sm_90a).
//
// Replaces the Pallas kernel
// src/repro/kernels/flash_attention/flash_attention.py::_flash_kernel
// (launched by flash_attention_bh, behind flash_attention/ops.py, which
// repeats K/V for GQA).  For each query row, over its keys in chunks:
//     s = (q . k) * scale, masked to -1e30 above the diagonal when causal
//     m' = max(m, max s);  p = exp(s - m');  alpha = exp(m - m')
//     l = alpha l + sum p;  acc = alpha acc + p v;  m = m'
// and at the end out = acc / max(l, 1e-30), in the input type.
//
// What bounds it on the H100: 4 S^2 d flops per head (half of that when
// causal) against 4 S d elements moved, so it is bound by operations: the
// bf16 tensor-core rate for bf16 (reached only through wgmma), the FP32
// rate for float32 (its tolerance, 2e-4, rules out TF32's ~3 digits).
//
// Design (FlashAttention-2's scheme).  The query rows are cut into
// sub-tiles of 64 rows starting at multiples of 64; one thread block of 4
// warps per (batch*head, block_q rows) walks ceil(block_q / 64) of them,
// dealt in snake order across the blocks so that under a causal mask every
// block sees about the same number of keys.  K/V rows are read at head
// h / (Hq / Hkv) in place (no repeat for GQA).  Keys go in chunks of at
// most 64 that never cross a block_k tile: tile t covers [t block_k,
// (t+1) block_k) and is cut into chunks of 64 from its start (block_k 100:
// 64, 36, 64, 36, ...).  A chunk's K and V rows come by 16-byte
// cp.async.cg into a 2-stage ring in shared memory (rows past the chunk's
// end are zero-filled), so the next chunk's copy overlaps this chunk's
// products; one __syncthreads per chunk.  The online softmax step runs
// once per chunk, in log2 units: m is kept scaled by scale * log2e, and
// p = exp2(fma(s, scale * log2e, -m)).
//  * bf16: the 4 warps are one warpgroup and the 64-row sub-tile is its
//    wgmma tile.  Q.K^T is wgmma m64n64k16 with Q and K from shared
//    memory (K-major); P.V is wgmma m64nDk16 with P from registers and V
//    from shared memory (MN-major, transposed by the instruction), f32
//    accumulators in registers.  Q, K and V tiles are stored in the
//    128-byte swizzle (atoms of 64 rows x 128 bytes, 16-byte piece c of
//    row r at (c ^ r % 8) * 16), which the descriptors name; cp.async's
//    writes are fenced into the async proxy before wgmma reads them.  A
//    warp owns 16 rows of each accumulator (the m16n8 layout): the
//    row max and sum reduce over the 4 lanes of a quad with shuffles, and
//    the score accumulator is already P.V's register A operand.  p is
//    rounded to bf16 only there; l sums the f32 p.
//  * float32: CUDA-core FMAs.  Each warp owns 16 rows; a thread holds an
//    8 x 4 tile of scores (rows 16w + 2i + h, columns cg + 16j) and an
//    8 x (D/16) tile of the output (columns 4 cg + 64 t + u), fed by float4
//    shared loads from rows padded by 16 bytes (conflict-free).  Scores
//    stay in registers: P.V takes p from the owning lane by shuffle.
//
// Head widths.  A head width d from 1 to 256 runs at the compiled width D
// of 64, 128, 192 or 256 next above it: Q, K and V tiles are D wide, the
// columns past d zero-filled as they load (so every product over them adds
// exact zeros), and only d columns are stored; the host makes no padded
// copy, and the scale is the caller's 1/sqrt(d).  Each D has three
// instances: d = D (d a constant, the code of the widths the kernel always
// took, so d 64 and 128 keep their bits and times), d a multiple of 16
// bytes' elements (16-byte pieces, those past d zero-filled) and any other
// d (element by element through registers).  At D 192 and 256 the bf16
// P.V runs as an n128 wgmma and an n64 or n128 one on V's atoms 2 and 3;
// its accumulator, 96 or 128 floats a thread, fits the registers of two
// blocks an SM's 128 threads (ptxas: about 200 and 230, no spills).  A
// load forms its address as the kernel always did (d = D: the same code;
// measured, a pointer select in its place cost the bf16 path ~5 %).  The
// float32 path takes chunks of 32 keys above D 128, where two stages of 64
// K and V rows would not fit beside Q (250 KB at D 192).  bf16 wgmma's K
// steps of 16 divide every D.
//
// Grid.  One block per (batch*head, block) in the grid's x dimension (x =
// bh nb + block, nb blocks a head), so B * Hq has no limit of 65535 (the
// y dimension's) and a head's blocks stay next to each other.
//
// Bit identity across block_q (the tunables contract): a row's result is a
// function of its own q row and of the chunk sequence, and neither depends
// on block_q:
//  * the chunk boundaries depend on block_k and S only;
//  * each output row is its own dot products (a row of a wgmma, or one
//    thread's FMAs) and its own quad/16-lane reductions, in an instruction
//    sequence fixed by the chunk, so no other row's data or position
//    enters it;
//  * sub-tiles start at multiples of 64 whatever block_q is (block_q only
//    decides which block walks them), and a sub-tile's causal stop
//    depends only on its start (the float32 path's warps also skip chunks
//    that start past their last row);
//  * a chunk a row does not see (past its diagonal) leaves its m, l and acc
//    unchanged bit for bit: every raw score is -1e30, so the chunk's max
//    (-1e30 * scale * log2e) is below the row's real m and m' = m,
//    p = exp2(-1e30 * scale * log2e - m) = 0 exactly, alpha = exp2(0) = 1,
//    so l = 1 l + 0 and acc = 1 acc + 0.  The first chunk (key 0) is seen
//    by every row, so m is a real score before any masked chunk comes.
//    Hence visiting such a chunk or skipping it gives the same bits.  The
//    mask is applied only to chunks that hold a key some row of the tile
//    must not see; elsewhere it would change nothing.
// -1e30 (not -inf) and the 1e-30 floor are the reference's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // query rows per sub-tile
constexpr int kChunk = 64;     // keys per chunk
constexpr int kMaxBlockK = 512;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// How a head width d is loaded and stored at the compiled width D: kFull
// (d = D, d a constant: the code of the widths the kernel always took),
// kPieces (16-byte pieces, those past d zero-filled: d a multiple of 16
// bytes' elements), kElems (element by element, zeros included).
constexpr int kFull = 0, kPieces = 1, kElems = 2;

// End of the chunk that starts at c0: at most kc keys, inside c0's
// block_k tile, before S
__device__ __forceinline__ int chunk_end(int c0, int block_k, int S,
                                         int kc = kChunk) {
  const int tile_end = (c0 / block_k + 1) * block_k;
  return min(min(c0 + kc, tile_end), S);
}

// Copy positions [r0, r1) of one head (src points at position 0 of it,
// pos_stride elements apart), columns 0..d-1, into `dst` rows 0..NROWS-1
// (DS elements apart), zeros in rows past r1 - r0 and in columns d..D-1.
// kFull, kPieces: 16 bytes per cp.async (rows 16-byte aligned); kElems:
// element by element through registers.
template <typename T, int D, int DS, int NROWS, int MODE>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long pos_stride, int r0,
                                          int r1, int d) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  if constexpr (MODE != kElems) {
    for (int e = threadIdx.x; e < NROWS * kPerRow; e += kThreads) {
      const int r = e / kPerRow, c = (e % kPerRow) * kVec;
      if constexpr (MODE == kFull) {  // the kernel's own address form
        const bool ok = r0 + r < r1;
        const T* g = src + (long long)(ok ? r0 + r : 0) * pos_stride + c;
        cp_async16(dst + r * DS + c, g, ok ? 16 : 0);
      } else {  // pieces past d zero-filled
        const bool ok = r0 + r < r1 && c < d;
        const T* g = ok ? src + (long long)(r0 + r) * pos_stride + c : src;
        cp_async16(dst + r * DS + c, g, ok ? 16 : 0);
      }
    }
  } else {
    for (int e = threadIdx.x; e < NROWS * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const bool ok = r0 + r < r1 && c < d;
      dst[r * DS + c] = ok ? src[(long long)(r0 + r) * pos_stride + c] : T(0);
    }
  }
}

// ------------------------------------------------------------------ bf16
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 64 a warpgroup, 32 floats a thread) = A (shared, K-major) *
// B (shared, K-major), plus d when `accumulate`
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x 64, 32 floats a thread) += A (registers) * B (shared,
// MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (64 x 128, 64 floats a thread) += A (registers) * B (shared,
// MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// the compiler must treat an accumulator as written where this stands
__device__ __forceinline__ void reg_fence(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
// cp.async's writes to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}

// Tiles of 64 rows x D bf16 in the 128-byte swizzle: D / 64 atoms of
// 64 rows x 128 bytes (8 KiB), 16-byte piece c of row r at
// r * 128 + ((c ^ (r % 8)) * 16) within its atom.
constexpr int kAtom = 64 * 128;

// The rows as load_rows takes them, each 16-byte piece c of row r at its
// place in the swizzle.
template <int D, int NROWS, int MODE>
__device__ __forceinline__ void load_rows_sw(unsigned char* dst,
                                             const __nv_bfloat16* src,
                                             long long pos_stride, int r0,
                                             int r1, int d) {
  constexpr int kPerRow = D / 8;  // 16-byte pieces
  if constexpr (MODE != kElems) {
    for (int e = threadIdx.x; e < NROWS * kPerRow; e += kThreads) {
      const int r = e / kPerRow, c = e % kPerRow;
      unsigned char* to =
          dst + (c / 8) * kAtom + r * 128 + (((c % 8) ^ (r % 8)) << 4);
      if constexpr (MODE == kFull) {  // the kernel's own address form
        const bool ok = r0 + r < r1;
        cp_async16(to, src + (long long)(ok ? r0 + r : 0) * pos_stride + c * 8,
                   ok ? 16 : 0);
      } else {  // pieces past d zero-filled
        const bool ok = r0 + r < r1 && 8 * c < d;
        cp_async16(to, ok ? src + (long long)(r0 + r) * pos_stride + c * 8
                          : src, ok ? 16 : 0);
      }
    }
  } else {
    for (int e = threadIdx.x; e < NROWS * D; e += kThreads) {
      const int r = e / D, col = e % D, c = col / 8;
      const bool ok = r0 + r < r1 && col < d;
      *reinterpret_cast<__nv_bfloat16*>(
          dst + (c / 8) * kAtom + r * 128 + (((c % 8) ^ (r % 8)) << 4) +
          2 * (col % 8)) =
          ok ? src[(long long)(r0 + r) * pos_stride + col]
             : __float2bfloat16(0.f);
    }
  }
}

template <int D>
constexpr int wg_smem_bytes() {
  return 5 * (D / 64) * kAtom + 1024;  // Q, 2 stages of K and V; alignment
}

template <int D, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_bf16(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, int S, int Hq, int Hkv,
                     int block_q, int block_k, int causal, float scale,
                     int d_arg, int nb) {
  constexpr bool VEC = MODE != kElems;
  const int d = MODE == kFull ? D : d_arg;
  constexpr int KS = D / 16;       // k-steps of Q.K^T
  constexpr int NT = D / 8;        // n-tiles of the output
  constexpr int TILE = (D / 64) * kAtom;  // bytes of a 64-row tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = base;
  unsigned char* ks0 = base + TILE;  // stage s: K at ks0 + 2 s TILE, V after
  const uint32_t qs_a = smem_u32(qs), ks0_a = smem_u32(ks0);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int bh = blockIdx.x / nb, bx = blockIdx.x % nb;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const long long q_pos = (long long)Hq * d;
  const long long kv_pos = (long long)Hkv * d;
  const __nv_bfloat16* qb = q + (long long)b * S * q_pos + (long long)h * d;
  __nv_bfloat16* ob = out + (long long)b * S * q_pos + (long long)h * d;
  const __nv_bfloat16* kb =
      k + (long long)b * S * kv_pos + (long long)hk * d;
  const __nv_bfloat16* vb =
      v + (long long)b * S * kv_pos + (long long)hk * d;
  const float sl = scale * kLog2e;

  const int n_sub = (block_q + kRows - 1) / kRows;
  for (int rd = 0; rd < n_sub; ++rd) {
    const int r0 = (rd * nb + (rd % 2 == 0 ? bx : nb - 1 - bx)) * kRows;
    if (r0 >= S) continue;
    const int nrows = min(kRows, S - r0);
    const int k_end = causal ? min(S, r0 + nrows) : S;
    const int w0 = r0 + 16 * warp;       // this warp's first row
    load_rows_sw<D, kRows, MODE>(qs, qb, q_pos, r0, r0 + nrows, d);
    int c0 = 0, c1 = chunk_end(0, block_k, S);
    load_rows_sw<D, kChunk, MODE>(ks0, kb, kv_pos, c0, c1, d);
    load_rows_sw<D, kChunk, MODE>(ks0 + TILE, vb, kv_pos, c0, c1, d);
    cp_async_commit();

    float o[NT * 4];
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    for (int it = 0; c0 < k_end; ++it) {
      const int n0 = c1, n1 = n0 < k_end ? chunk_end(n0, block_k, S) : n0;
      cp_async_wait_all();
      fence_async_shared();
      __syncthreads();  // chunk `it` is in; every warp is done with it - 1
      if (n0 < k_end) {
        unsigned char* st = ks0 + ((it + 1) & 1) * 2 * TILE;
        load_rows_sw<D, kChunk, MODE>(st, kb, kv_pos, n0, n1, d);
        load_rows_sw<D, kChunk, MODE>(st + TILE, vb, kv_pos, n0, n1, d);
      }
      cp_async_commit();
      const uint32_t ks_a = ks0_a + (it & 1) * 2 * TILE, vs_a = ks_a + TILE;
      // s = q k^T for 64 keys: the warpgroup's 64 x 64, 8 n-tiles a warp
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t off = (kk / 4) * kAtom + (kk % 4) * 32;
        wgmma_ss_n64(s, sw128_desc(qs_a + off, 16, 1024),
                     sw128_desc(ks_a + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 32; ++i) reg_fence(s[i]);
      // mask (only where the chunk holds a key some row of this warpgroup
      // must not see), then the online-softmax step for rows g and g + 8
      if (c1 - c0 < kChunk || (causal && c1 - 1 > r0)) {
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = c0 + 8 * t + 2 * tig + (e & 1);
            const int row = w0 + g + 8 * (e >> 1);
            if (key >= c1 || (causal && key > row)) s[4 * t + e] = kNegInf;
          }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * t + e]);
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * sl);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * t + e] = exp2f(fmaf(s[4 * t + e], sl, -m[e >> 1]));
          sum[e >> 1] += s[4 * t + e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = alpha[r] * l[r] + sum[r];
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        o[4 * t] *= alpha[0];
        o[4 * t + 1] *= alpha[0];
        o[4 * t + 2] *= alpha[1];
        o[4 * t + 3] *= alpha[1];
      }
      // acc += p v: p (64 x 64) as 4 register A fragments of 16 keys
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
#pragma unroll
      for (int i = 0; i < NT * 4; ++i) reg_fence(o[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = sw128_desc(vs_a + kk * 16 * 128, kAtom, 1024);
        if constexpr (D == 64) {
          wgmma_rs_n64(o, pa[kk], dv);
        } else {
          wgmma_rs_n128(o, pa[kk], dv);
          if constexpr (D > 128) {  // columns 128.. from V's atoms 2, 3
            const uint64_t dv2 =
                sw128_desc(vs_a + 2 * kAtom + kk * 16 * 128, kAtom, 1024);
            if constexpr (D == 192)
              wgmma_rs_n64(o + 64, pa[kk], dv2);
            else
              wgmma_rs_n128(o + 64, pa[kk], dv2);
          }
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < NT * 4; ++i) reg_fence(o[i]);
      c0 = n0;
      c1 = n1;
    }
    // out = acc / max(l, 1e-30) for this thread's rows g and g + 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w0 + g + 8 * r;
      if (row < r0 + nrows) {
        const float lf = fmaxf(l[r], 1e-30f);
        __nv_bfloat16* dst = ob + (long long)row * q_pos + 2 * tig;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int col = 8 * t + 2 * tig;  // d columns of the padded D
          if constexpr (VEC) {  // d even: a pair is in whole or none
            if (col < d)
              *reinterpret_cast<__nv_bfloat162*>(dst + 8 * t) =
                  __floats2bfloat162_rn(o[4 * t + 2 * r] / lf,
                                        o[4 * t + 2 * r + 1] / lf);
          } else {
            if (col < d)
              dst[8 * t] = __float2bfloat16_rn(o[4 * t + 2 * r] / lf);
            if (col + 1 < d)
              dst[8 * t + 1] = __float2bfloat16_rn(o[4 * t + 2 * r + 1] / lf);
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the next sub-tile refills Q and the ring
  }
}

// --------------------------------------------------------------- float32
// keys a chunk of the float32 path: 64, and 32 above D 128, where two
// stages of 64 K and V rows would not fit beside Q (250 KB at D 192)
template <int D>
__host__ __device__ constexpr int f32_chunk() {
  return D > 128 ? 32 : kChunk;
}

template <int D>
constexpr int f32_smem_bytes() {
  return (kRows + 4 * f32_chunk<D>()) * (D + 4) * 4;  // Q, 2 stages of K, V
}

template <int D, int MODE>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    int S, int Hq, int Hkv, int block_q, int block_k,
                    int causal, float scale, int d_arg, int nb) {
  constexpr bool VEC = MODE != kElems;
  const int d = MODE == kFull ? D : d_arg;
  constexpr int DS = D + 4;   // padded row (16 bytes): conflict-free float4
  constexpr int OT = D / 64;  // output column groups of 4 per thread
  constexpr int KC = f32_chunk<D>();  // keys a chunk
  constexpr int KJ = KC / 16;         // of them a lane's: cg + 16 j
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks0 = qs + kRows * DS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hr = lane / 16, cg = lane % 16;  // row parity, column group
  const int bh = blockIdx.x / nb, bx = blockIdx.x % nb;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const long long q_pos = (long long)Hq * d;
  const long long kv_pos = (long long)Hkv * d;
  const float* qb = q + (long long)b * S * q_pos + (long long)h * d;
  float* ob = out + (long long)b * S * q_pos + (long long)h * d;
  const float* kb = k + (long long)b * S * kv_pos + (long long)hk * d;
  const float* vb = v + (long long)b * S * kv_pos + (long long)hk * d;
  const float sl = scale * kLog2e;

  // block_q / 64 sub-tiles, dealt in snake order (round r takes sub-tile
  // r nb + x on even rounds, r nb + nb - 1 - x on odd ones), so that under
  // a causal mask every block gets about the same number of keys
  const int n_sub = (block_q + kRows - 1) / kRows;
  for (int rd = 0; rd < n_sub; ++rd) {
    const int r0 = (rd * nb + (rd % 2 == 0 ? bx : nb - 1 - bx)) * kRows;
    if (r0 >= S) continue;
    const int nrows = min(kRows, S - r0);
    const int k_end = causal ? min(S, r0 + nrows) : S;
    const int w0 = r0 + 16 * warp;
    const int w_last = w0 + 15;
    load_rows<float, D, DS, kRows, MODE>(qs, qb, q_pos, r0, r0 + nrows, d);
    int c0 = 0, c1 = chunk_end(0, block_k, S, KC);
    load_rows<float, D, DS, KC, MODE>(ks0, kb, kv_pos, c0, c1, d);
    load_rows<float, D, DS, KC, MODE>(ks0 + KC * DS, vb, kv_pos, c0, c1, d);
    cp_async_commit();

    // rows 16 warp + 2 i + hr (i < 8); output columns 4 cg + 64 t + u
    float o[8][OT][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int t = 0; t < OT; ++t)
#pragma unroll
        for (int u = 0; u < 4; ++u) o[i][t][u] = 0.f;
    float m[8], l[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
    }
    const float* qw = qs + (16 * warp + hr) * DS;

    for (int it = 0; c0 < k_end; ++it) {
      const int n0 = c1,
                n1 = n0 < k_end ? chunk_end(n0, block_k, S, KC) : n0;
      cp_async_wait_all();
      __syncthreads();
      if (n0 < k_end) {
        float* st = ks0 + ((it + 1) & 1) * 2 * KC * DS;
        load_rows<float, D, DS, KC, MODE>(st, kb, kv_pos, n0, n1, d);
        load_rows<float, D, DS, KC, MODE>(st + KC * DS, vb, kv_pos, n0, n1, d);
      }
      cp_async_commit();
      if (!causal || c0 <= w_last) {
        const float* ks = ks0 + (it & 1) * 2 * KC * DS;
        const float* vs = ks + KC * DS;
        // s[i][j] = q[row i] . k[key cg + 16 j]
        float s[8][KJ];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 2
        for (int x = 0; x < D; x += 4) {
          float4 kx[KJ];
#pragma unroll
          for (int j = 0; j < KJ; ++j)
            kx[j] = *reinterpret_cast<const float4*>(ks + (cg + 16 * j) * DS +
                                                     x);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 qv =
                *reinterpret_cast<const float4*>(qw + 2 * i * DS + x);
#pragma unroll
            for (int j = 0; j < KJ; ++j) {
              s[i][j] = fmaf(qv.x, kx[j].x, s[i][j]);
              s[i][j] = fmaf(qv.y, kx[j].y, s[i][j]);
              s[i][j] = fmaf(qv.z, kx[j].z, s[i][j]);
              s[i][j] = fmaf(qv.w, kx[j].w, s[i][j]);
            }
          }
        }
        // mask and the online-softmax step; a row's KC scores lie in the
        // 16 lanes of its half-warp
        const bool edge = c1 - c0 < KC || (causal && c1 - 1 > w0);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = w0 + 2 * i + hr;
          float mx = kNegInf;
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            const int key = c0 + cg + 16 * j;
            if (edge && (key >= c1 || (causal && key > row)))
              s[i][j] = kNegInf;
            mx = fmaxf(mx, s[i][j]);
          }
#pragma unroll
          for (int off = 1; off < 16; off <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_new = fmaxf(m[i], mx * sl);  // log2 units
          const float alpha = exp2f(m[i] - m_new);
          m[i] = m_new;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            s[i][j] = exp2f(fmaf(s[i][j], sl, -m_new));
            sum += s[i][j];
          }
#pragma unroll
          for (int off = 1; off < 16; off <<= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          l[i] = alpha * l[i] + sum;
#pragma unroll
          for (int t = 0; t < OT; ++t)
#pragma unroll
            for (int u = 0; u < 4; ++u) o[i][t][u] *= alpha;
        }
        // acc += p v: p[row][key] comes from the lane owning key's column
        const int nkeys = c1 - c0;  // keys past it have p = 0, V rows 0
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          for (int c = 0; c < 16; ++c) {
            const int key = c + 16 * j;
            if (key >= nkeys) break;
            float4 vx[OT];
#pragma unroll
            for (int t = 0; t < OT; ++t)
              vx[t] = *reinterpret_cast<const float4*>(vs + key * DS +
                                                       4 * cg + 64 * t);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float p = __shfl_sync(0xffffffffu, s[i][j], 16 * hr + c);
#pragma unroll
              for (int t = 0; t < OT; ++t) {
                o[i][t][0] = fmaf(p, vx[t].x, o[i][t][0]);
                o[i][t][1] = fmaf(p, vx[t].y, o[i][t][1]);
                o[i][t][2] = fmaf(p, vx[t].z, o[i][t][2]);
                o[i][t][3] = fmaf(p, vx[t].w, o[i][t][3]);
              }
            }
          }
        }
      }
      c0 = n0;
      c1 = n1;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = w0 + 2 * i + hr;
      if (row < r0 + nrows) {
        const float lf = fmaxf(l[i], 1e-30f);
        float* dst = ob + (long long)row * q_pos + 4 * cg;
#pragma unroll
        for (int t = 0; t < OT; ++t) {
          const int col = 4 * cg + 64 * t;  // d columns of the padded D
          if constexpr (VEC) {  // d a multiple of 4: four whole or none
            if (col < d)
              *reinterpret_cast<float4*>(dst + 64 * t) =
                  make_float4(o[i][t][0] / lf, o[i][t][1] / lf,
                              o[i][t][2] / lf, o[i][t][3] / lf);
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (col + u < d) dst[64 * t + u] = o[i][t][u] / lf;
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

template <typename T, typename K>
int launch(K kernel, int bytes, const T* q, const T* k, const T* v, T* out,
           int B, int S, int Hq, int Hkv, int causal, int block_q,
           int block_k, float scale, int d, cudaStream_t stream) {
  // kernel: the instance for d (16-byte pieces or element-wise)
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_sub = (block_q + kRows - 1) / kRows;  // sub-tiles per block
  const int tiles = (S + kRows - 1) / kRows;
  const int nb = (tiles + n_sub - 1) / n_sub;       // blocks per head
  // (batch*head, block) folded into x: no limit of 65535 on B * Hq
  const long long blocks = (long long)nb * B * Hq;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, bytes, stream>>>(
      q, k, v, out, S, Hq, Hkv, block_q, block_k, causal, scale, d, nb);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int S, int Hq, int Hkv, int causal, int block_q,
                int block_k, float scale, int d, cudaStream_t st) {
  using T = __nv_bfloat16;
  return launch(d == D       ? flash_attention_bf16<D, kFull>
                : d % 8 == 0 ? flash_attention_bf16<D, kPieces>
                             : flash_attention_bf16<D, kElems>,
                wg_smem_bytes<D>(), (const T*)q, (const T*)k, (const T*)v,
                (T*)out, B, S, Hq, Hkv, causal, block_q, block_k, scale, d,
                st);
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int S, int Hq, int Hkv, int causal, int block_q, int block_k,
               float scale, int d, cudaStream_t st) {
  return launch(d == D       ? flash_attention_f32<D, kFull>
                : d % 4 == 0 ? flash_attention_f32<D, kPieces>
                             : flash_attention_f32<D, kElems>,
                f32_smem_bytes<D>(), (const float*)q, (const float*)k,
                (const float*)v, (float*)out, B, S, Hq, Hkv, causal, block_q,
                block_k, scale, d, st);
}

template <int D>
int launch_any(int dtype, const void* q, const void* k, const void* v,
               void* out, int B, int S, int Hq, int Hkv, int causal,
               int block_q, int block_k, float scale, int d,
               cudaStream_t st) {
  return dtype == 0 ? launch_f32<D>(q, k, v, out, B, S, Hq, Hkv, causal,
                                    block_q, block_k, scale, d, st)
                    : launch_bf16<D>(q, k, v, out, B, S, Hq, Hkv, causal,
                                     block_q, block_k, scale, d, st);
}

}  // namespace

// q, out: (B, S, Hq, d); k, v: (B, S, Hkv, d); all contiguous, of one type
// (dtype 0: float32, 1: bfloat16), 16-byte aligned; 1 <= d <= 256, run at
// the compiled width D of 64, 128, 192 or 256 next above it (scale is the
// caller's, 1/sqrt(d)); Hq a multiple of Hkv; 1 <= block_k <= 512
// (block_k <= S).  Launches on `stream`; returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for what it does not take.
extern "C" int rimms_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int S,
                                     int Hq, int Hkv, int d, int dtype,
                                     int causal, int block_q, int block_k,
                                     float scale, void* stream) {
  if (B < 0 || S < 0 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      block_q < 1 || block_k < 1 || block_k > kMaxBlockK || d < 1 ||
      d > 256 || (dtype != 0 && dtype != 1) ||
      ((size_t)q | (size_t)k | (size_t)v | (size_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (d <= 64)
    return launch_any<64>(dtype, q, k, v, out, B, S, Hq, Hkv, causal,
                          block_q, block_k, scale, d, st);
  if (d <= 128)
    return launch_any<128>(dtype, q, k, v, out, B, S, Hq, Hkv, causal,
                           block_q, block_k, scale, d, st);
  if (d <= 192)
    return launch_any<192>(dtype, q, k, v, out, B, S, Hq, Hkv, causal,
                           block_q, block_k, scale, d, st);
  return launch_any<256>(dtype, q, k, v, out, B, S, Hq, Hkv, causal, block_q,
                         block_k, scale, d, st);
}
