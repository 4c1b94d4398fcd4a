// Building blocks of the f32 route's tensor-core kernels (attention.cu K3,
// attention_bwd.cu K4 and K5): f32 products on Hopper's tensor cores by
// the 3xTF32 split, `mma.sync` fragments loaded from shared memory by
// hand, and the `cp.async` copies that fill their shared-memory rings.
//
// The split. Every f32 operand x of a product is split once, as its
// fragment is loaded: big = x rounded to TF32 (10 mantissa bits, to
// nearest, ties away from zero, as cvt.rna.tf32.f32 rounds a finite x),
// small = x - big (exact in f32) truncated to TF32. A product a b is then
// a_big b_small + a_small b_big + a_big b_big, the small terms first, all
// three into one f32 accumulator; a_small b_small (below 2^-22 of a b) is
// dropped, and small's truncation costs at most 2^-21 of x. One TF32
// product alone keeps about 11 bits of each operand and misses the f32
// route's limits by orders of magnitude; the three keep about 21
// (tests/test_torch_tf32x3.py emulates both on the CPU).
//
// The tensor cores do not round an mma's sum to nearest: they truncate
// it, so a long chain of mma.sync into one accumulator drifts toward zero.
// With P v's and dV's accumulators chained over every key or query (768
// mma.sync at 2,048), K3 and K5 read 8.0e-6 to 2.6e-5 tile-wise against
// their plain versions on an H100 (limit 1e-5); a model that truncates
// each mma's result to 24 significant bits reads the same on the CPU
// (tests/test_torch_tf32x3.py). So no chain spans a long axis: K3's P v
// over one 64-key tile, K4's dS k over one 32-key stage and K5's products
// over one 32-query tile (24, 12 and 12 mma.sync) start from zero and are
// added to the running f32 accumulators on the CUDA cores, which round to
// nearest (7e-7 to 2.5e-6 read). Products over D (48 mma.sync at D =
// 128) stay one chain.
//
// The instruction is mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32:
// one warp, A 16 x 8 and B 8 x 8 in registers, C 16 x 8 in f32. wgmma's
// tf32 form takes both operands K-major only, but P v (K3), dS k (K4),
// p^T dO and dS^T q (K5) read v, k, dO and q along their rows; mma.sync
// takes any layout because its fragments are loaded here element by
// element. Fragment
// layouts (PTX ISA, m16n8k8 .tf32), with g = lane / 4 and t = lane % 4:
//   A (row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (col): b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C:       c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// An accumulator tile (C) feeds the next product as its A operand with no
// shuffle: a sum over k may visit k in any order, so A's k = t is taken as
// the C tile's column 2t and A's k = t + 4 as column 2t + 1, and B's rows
// are read in the same permuted order (load_b_rows).
//
// Shared tiles are row-major with rows of D + 16 / sizeof(T) elements: the
// 16-byte pad keeps every row start 16-byte aligned for cp.async and makes
// the row stride 4 words modulo 32 banks, so the fragment loads below (8
// rows by 4 columns, or 4 row pairs by 8 columns) hit 32 distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tf32x3 {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

// Elements of a shared row: D and the 16-byte pad.
template <typename T, int D>
__host__ __device__ constexpr int row_len() {
  return D + 16 / static_cast<int>(sizeof(T));
}

// -- the split and the product ----------------------------------------------

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x (to nearest,
// ties away from zero; the 13 low bits cleared), in two integer
// operations: adding half of the dropped ulp to the magnitude bits carries
// into the kept ones exactly when the dropped part is at least half (inf
// stays inf). The card lowers cvt.rna.tf32.f32 to four instructions (a
// range test and a select besides these two), which made the splits the
// kernels' largest cost. A NaN whose 10 high mantissa bits are all ones
// (0x7fffffff, the NaN the card's arithmetic gives) carries into the sign
// and comes out as -0.0.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// big = x rounded, small = x - big with its 13 low bits cleared (one
// operation; rounding small as well cost two, and a select for NaN two
// more). small carries NaN: for a NaN x, x - big is the card's NaN, which
// truncation keeps (0x7fffe000), whatever to_tf32 made of big; for an
// infinite x it is inf - inf, NaN, as with cvt.rna. So a NaN or infinite
// operand makes its products NaN, as in f32.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[i] += a b[i] for G products that share their A operand, each in three
// TF32 products, the small terms first; each term is issued across all G
// accumulators in turn, so that G independent mma.sync stand between two
// that depend on each other.
template <int G>
__device__ __forceinline__ void mma3_rows(float (&c)[G][4], const FragA& a,
                                          const FragB (&b)[G]) {
#pragma unroll
  for (int i = 0; i < G; ++i) mma(c[i], a.big, b[i].small);
#pragma unroll
  for (int i = 0; i < G; ++i) mma(c[i], a.small, b[i].big);
#pragma unroll
  for (int i = 0; i < G; ++i) mma(c[i], a.big, b[i].big);
}

// -- fragments from shared tiles ----------------------------------------------

// A: rows r0..r0+15, columns c0..c0+7 of a row-major tile.
template <typename T>
__device__ __forceinline__ void load_a(FragA& f, const T* tile, int ld,
                                       int r0, int c0, int lane) {
  const T* p = tile + (r0 + (lane >> 2)) * ld + c0 + (lane & 3);
  split(to_f32(p[0]), f.big[0], f.small[0]);
  split(to_f32(p[8 * ld]), f.big[1], f.small[1]);
  split(to_f32(p[4]), f.big[2], f.small[2]);
  split(to_f32(p[8 * ld + 4]), f.big[3], f.small[3]);
}

// B (k x n) from a tile that holds n along its rows and k along its
// columns (B^T row-major: k for q k^T, q for k q^T): rows n0..n0+7,
// columns k0..k0+7.
template <typename T>
__device__ __forceinline__ void load_b_cols(FragB& f, const T* tile, int ld,
                                            int n0, int k0, int lane) {
  const T* p = tile + (n0 + (lane >> 2)) * ld + k0 + (lane & 3);
  split(to_f32(p[0]), f.big[0], f.small[0]);
  split(to_f32(p[4]), f.big[1], f.small[1]);
}

// B (k x n) from a tile that holds k along its rows (v for P v, k for dS
// k, dO and q for p^T dO and dS^T q): rows k0..k0+7 in the permuted
// order that a_from_c gives A (k = t is row k0 + 2t, k = t + 4 row k0 +
// 2t + 1), columns n0..n0+7.
template <typename T>
__device__ __forceinline__ void load_b_rows(FragB& f, const T* tile, int ld,
                                            int k0, int n0, int lane) {
  const T* p = tile + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
  split(to_f32(p[0]), f.big[0], f.small[0]);
  split(to_f32(p[ld]), f.big[1], f.small[1]);
}

// A (16 x 8) from the accumulator of a 16 x 8 product, in the permuted k
// order of load_b_rows.
__device__ __forceinline__ void a_from_c(FragA& f, const float (&c)[4]) {
  split(c[0], f.big[0], f.small[0]);
  split(c[2], f.big[1], f.small[1]);
  split(c[1], f.big[2], f.small[2]);
  split(c[3], f.big[3], f.small[3]);
}

// -- cp.async ------------------------------------------------------------------

// 16 bytes from global to shared; `bytes` < 16 fills the rest with zeros
// (0: reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes, or zeros where `bytes` is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage `rows` rows of one (batch, head) slice into a shared tile of
// row_len<T, D>() elements a row: row r from src + r * row_stride, columns
// [0, D). Columns from d on and rows from `valid` on are zero. vec: every
// row start is 16-byte aligned and d a multiple of 16 / sizeof(T), so each
// 16-byte chunk is one cp.async (asynchronous: it lands by the matching
// cp_async_wait); otherwise the elements are copied here, synchronously.
template <typename T, int D, int kThreads>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           long long row_stride, int rows,
                                           int valid, int d, int vec) {
  constexpr int kLd = row_len<T, D>();
  if (vec) {
    constexpr int kVec = 16 / static_cast<int>(sizeof(T));
    constexpr int kChunks = D / kVec;
    static_assert(kThreads % kChunks == 0, "a thread keeps one column");
    const int c = (threadIdx.x % kChunks) * kVec;
    for (int r = threadIdx.x / kChunks; r < rows; r += kThreads / kChunks) {
      const bool live = r < valid && c < d;
      cp_async16(dst + r * kLd + c, live ? src + r * row_stride + c : src,
                 live ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += kThreads) {
      const int r = i / D;
      const int c = i % D;
      dst[r * kLd + c] = r < valid && c < d ? src[r * row_stride + c]
                                            : from_f32<T>(0.f);
    }
  }
}

}  // namespace tf32x3
