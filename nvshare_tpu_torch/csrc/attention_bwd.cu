// Flash-attention backward for Hopper (sm_90a), the f32 route: dQ (K4) and
// dK/dV (K5) of exact attention over [B, S, H, D] tensors, recomputing each
// tile of probabilities from the forward's saved log-sum-exp, so the S x S
// score matrix never reaches device memory in training either.
//
// Replaces the Pallas TPU kernels nvshare_tpu/ops/attention.py
// `_flash_bwd_dq_kernel` (K4) and `_flash_bwd_dkv_kernel` (K5), both called
// by `_flash_backward`. Per tile pair: s = q k^T * scale (masked where q_pos
// < k_pos in causal mode), p = exp(s - lse), dP = dO v^T, dS = p * (dP -
// delta + g_lse) * scale; then dQ += dS k (K4), dV += p^T dO and dK += dS^T
// q (K5). delta = rowsum(dO * O) and g_lse (the LSE output's cotangent, or
// none) come in per row, in f32, as in the Pallas kernels. dQ, dK and dV
// are written contiguous [B, S, H, d] in their inputs' types. This is the
// route of f32, and of bf16 at head widths other than 64 and 128 (bf16 at
// 64 or 128 takes the wgmma K4 and K5 in attention_bwd_sm90.cu); bf16 is
// read as f32, d is zero-padded to the 64 or 128 template.
//
// Bound: operations. K4 does 3 products and K5 4, each 2*B*H*Sq*Sk*D flops
// (half in causal mode), against 4 bytes an element of q, k, v, dO, the
// row terms and the outputs. At the ring's blocks, [4, 1024, 32, 128] f32,
// a product is 1.72e10 flops on a causal diagonal block and 3.44e10 on a
// full past block; at the card's f32 CUDA-core rate (67 TFLOP/s) K4 takes
// at least 0.769 / 1.538 ms and K5 1.026 / 2.051 ms, and K5 by this
// design's three TF32 products (495 TFLOP/s, 165 TFLOP/s of f32 products)
// 0.417 / 0.833 ms; the bytes take 0.1 ms.
//
// Design. Two kernels, each output tile with exactly one writer, no atomics
// and a fixed order of sums, so the gradients are the same bits on every
// run (co-located training must equal solo training bit for bit). A Pallas
// grid axis that runs in order becomes a loop inside the block.
//   K4, on the CUDA cores: one block of 16 x 16 threads per (batch*head,
//     64-row query tile), looping over the live 64-key tiles; the q and dO
//     tiles stay in shared memory, the dQ accumulator in registers. A
//     thread computes 4 x 4 entries of s and dP (columns strided by 16)
//     from float4 reads along d, then accumulates its 4 rows over D/16
//     output columns; shared rows are padded by 4 floats so the 16-byte
//     reads hit distinct banks. The last query tiles go first in causal
//     mode.
//   K5, on the tensor cores by the 3xTF32 split (tf32x3.cuh: each operand
//     split into two TF32 halves as its fragment is loaded, three mma.sync
//     m16n8k8 products a step, small terms first, f32 accumulators). One
//     block of 8 warps per (batch*head, 128-key tile); warp w owns keys
//     16w..16w+15 and their [16, D] dK and dV accumulators in registers.
//     The k and v tiles stay in shared memory; the q and dO tiles of 32
//     rows, with their lse, delta and g_lse, stream through a two-stage
//     ring filled by cp.async, so the next tile's copy runs under this
//     tile's products, from the diagonal on in causal mode. Per tile a warp
//     computes s^T = k q^T and dP^T = v dO^T ([16, 32]), turns them into
//     p^T and dS^T in place on the CUDA cores, and feeds them from its
//     registers as the A operands of dV += p^T dO and dK += dS^T q (B = dO
//     and q read along their rows, which wgmma's K-major tf32 form cannot
//     do), dV's and then dK's, kG = 8 output tiles at a time (add_rows).
//     Those products run over the tile's 32 queries from zero and are added
//     to dV and dK in f32, so no chain of truncating tensor-core sums spans
//     the queries (tf32x3.cuh). Tiles, at D = 128 in f32: k and v 132 KB, two
//     stages of q and dO 66 KB, 199 KB in all of the 227 KB a block may
//     use. The 128 accumulator registers of a warp leave ptxas a few
//     spills at D = 128; warp pairs that split dK and dV by columns (half
//     the registers) measured no faster. A warp
//     whose keys all follow a query tile skips its products; the first key
//     tiles go first in causal mode.
//
// C interface (bound with ctypes): each entry point returns the
// cudaError_t of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kB = 64;         // K4: rows per tile, queries and keys alike
constexpr int kThreads = 256;  // K4: 16 x 16; K5: 8 warps
constexpr int kPad = 4;        // K4: floats of padding per shared row
constexpr int kKeys = 128;     // K5: keys per block, 8 warps x 16
constexpr int kQRows = 32;     // K5: query rows per ring stage
constexpr int kStages = 2;     // K5: the q and dO ring
constexpr int kG = 8;          // K5: output tiles of dV or dK in flight

using tf32x3::a_from_c;
using tf32x3::cp_async4;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::FragA;
using tf32x3::FragB;
using tf32x3::from_f32;
using tf32x3::load_a;
using tf32x3::load_b_cols;
using tf32x3::load_b_rows;
using tf32x3::mma3_rows;
using tf32x3::row_len;
using tf32x3::stage_rows;
using tf32x3::to_f32;

template <int D>
struct DqSmem {
  float q[kB][D + kPad];
  float dout[kB][D + kPad];
  float k[kB][D + kPad];
  float v[kB][D + kPad];
  float ds[kB][kB + kPad];
};

// K5: the block's key tile stays; q and dO tiles stream through the ring,
// with their rows of lse, delta and g_lse.
template <typename T, int D>
struct DkvSmem {
  static constexpr int kLd = row_len<T, D>();
  T k[kKeys * kLd];
  T v[kKeys * kLd];
  T q[kStages][kQRows * kLd];
  T dout[kStages][kQRows * kLd];
  float lse[kStages][kQRows];
  float delta[kStages][kQRows];
  float glse[kStages][kQRows];
};

// Stage rows [0, 64) of one (batch, head) slice into `dst` as f32; `src`
// points at its row 0, column 0, rows are `row_stride` elements apart and
// columns contiguous. Columns d..D-1 are zero. `vec`: every row start is
// 16-byte aligned and d is a multiple of the 16-byte vector.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float (*dst)[D + kPad],
                                          const T* src, long long row_stride,
                                          int d, int vec) {
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kChunks = D / kVec;
    for (int i = threadIdx.x; i < kB * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * kVec;
      float vals[kVec];
      if (c < d) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(src + r * row_stride + c);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < kVec; ++j) vals[j] = to_f32(e[j]);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) vals[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kVec; j += 4) {
        *reinterpret_cast<float4*>(&dst[r][c + j]) =
            make_float4(vals[j], vals[j + 1], vals[j + 2], vals[j + 3]);
      }
    }
  } else {
    for (int i = threadIdx.x; i < kB * D; i += kThreads) {
      const int r = i / D;
      const int c = i % D;
      dst[r][c] = c < d ? to_f32(src[r * row_stride + c]) : 0.f;
    }
  }
}

// out[i][j] = sum over the D columns of a[row0 + i] . b[tx + 16 j] for the
// thread's 4 rows of `a` and 4 rows of `b`.
template <int D>
__device__ __forceinline__ void tile_dots(float (&out)[4][4],
                                          const float (*a)[D + kPad],
                                          const float (*b)[D + kPad],
                                          int row0, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int dd = 0; dd < D; dd += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(&a[row0 + i][dd]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(&b[tx + 16 * j][dd]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = out[i][j];
        t = fmaf(av[i].x, bv[j].x, t);
        t = fmaf(av[i].y, bv[j].y, t);
        t = fmaf(av[i].z, bv[j].z, t);
        t = fmaf(av[i].w, bv[j].w, t);
        out[i][j] = t;
      }
  }
}

// acc[i][g*4 + t] += sum over kk of w[row0 + i][kk] * m[kk][g*64 + tx*4 + t]:
// the thread's 4 rows of a [64 x 64] weight tile times a [64 x D] tile.
template <int D>
__device__ __forceinline__ void tile_accumulate(float (&acc)[4][D / 16],
                                                const float (*w)[kB + kPad],
                                                const float (*m)[D + kPad],
                                                int row0, int tx) {
#pragma unroll 2
  for (int kk = 0; kk < kB; kk += 4) {
    float4 wa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wa[i] = *reinterpret_cast<const float4*>(&w[row0 + i][kk]);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int g = 0; g < D / 64; ++g) {
        const float4 mb =
            *reinterpret_cast<const float4*>(&m[kk + t][g * 64 + tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = t == 0   ? wa[i].x
                          : t == 1 ? wa[i].y
                          : t == 2 ? wa[i].z
                                   : wa[i].w;
          acc[i][g * 4 + 0] = fmaf(x, mb.x, acc[i][g * 4 + 0]);
          acc[i][g * 4 + 1] = fmaf(x, mb.y, acc[i][g * 4 + 1]);
          acc[i][g * 4 + 2] = fmaf(x, mb.z, acc[i][g * 4 + 2]);
          acc[i][g * 4 + 3] = fmaf(x, mb.w, acc[i][g * 4 + 3]);
        }
      }
    }
  }
}

// Write the thread's 4 rows of a [64 x D] accumulator to rows row0.. of
// one (batch, head) slice of a contiguous [B, S, H, d] output.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[4][D / 16],
                                           int b, int h, int heads, int seq,
                                           int d, int row0, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long base =
        ((static_cast<long long>(b) * seq + row0 + i) * heads + h) * d;
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int col = g * 64 + tx * 4 + t;
        if (col < d) out[base + col] = from_f32<T>(acc[i][g * 4 + t]);
      }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B*H, sq]
  const float* delta;  // [B*H, sq]
  const float* glse;   // [B*H, sq] or null (zero)
  void* out0;          // dQ (K4) or dK (K5)
  void* out1;          // dV (K5)
  int heads, sq, sk, d, causal, vec;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(const Args a) {
  extern __shared__ float4 smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(smem_raw);

  const int z = blockIdx.x;                   // b * heads + h
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest tiles first
  const int b = z / a.heads;
  const int h = z % a.heads;
  const int q0 = qt * kB;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int r0 = ty * 4;

  load_tile<T, D>(sm.q,
                  static_cast<const T*>(a.q) + b * a.qsb + q0 * a.qss +
                      h * a.qsh,
                  a.qss, a.d, a.vec);
  load_tile<T, D>(sm.dout,
                  static_cast<const T*>(a.dout) + b * a.osb + q0 * a.oss +
                      h * a.osh,
                  a.oss, a.d, a.vec);
  float lse[4], dlt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = static_cast<long long>(z) * a.sq + q0 + r0 + i;
    lse[i] = a.lse[row];
    dlt[i] = a.delta[row] - (a.glse ? a.glse[row] : 0.f);
  }
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

  // Causal: keys past this tile's last row are masked for every row.
  const int k_end = a.causal ? min(a.sk, q0 + kB) : a.sk;
  const int n_kt = (k_end + kB - 1) / kB;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // the previous tile's k and dS are consumed
    load_tile<T, D>(sm.k,
                    static_cast<const T*>(a.k) + b * a.ksb + k0 * a.kss +
                        h * a.ksh,
                    a.kss, a.d, a.vec);
    load_tile<T, D>(sm.v,
                    static_cast<const T*>(a.v) + b * a.vsb + k0 * a.vss +
                        h * a.vsh,
                    a.vss, a.d, a.vec);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dots<D>(s, sm.q, sm.k, r0, tx);
    tile_dots<D>(dp, sm.dout, sm.v, r0, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool masked = a.causal && q0 + r0 + i < k0 + tx + 16 * j;
        const float p = masked ? 0.f : expf(s[i][j] * a.scale - lse[i]);
        sm.ds[r0 + i][tx + 16 * j] = p * (dp[i][j] - dlt[i]) * a.scale;
      }
    __syncthreads();
    tile_accumulate<D>(acc, sm.ds, sm.k, r0, tx);  // dQ += dS k
  }
  store_rows<T, D>(static_cast<T*>(a.out0), acc, b, h, a.heads, a.sq, a.d,
                   q0 + r0, tx);
}

// acc += w m over the 8J rows of m: w is J 16 x 8 accumulator tiles (c),
// fed from registers as A operands, m a shared tile read along its rows;
// G of acc's 8-column tiles at a time. Each tile's product over the 8J rows
// starts from zero and is added to acc here, rounding to nearest
// (tf32x3.cuh: the tensor cores truncate).
template <int G, int J, int N, typename T>
__device__ __forceinline__ void add_rows(float (&acc)[N][4],
                                         const float (&c)[J][4], const T* m,
                                         int ld, int lane) {
  FragA a[J];
#pragma unroll
  for (int j = 0; j < J; ++j) a_from_c(a[j], c[j]);
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += G) {
    float part[G][4];
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      FragB b[G];
#pragma unroll
      for (int i = 0; i < G; ++i)
        load_b_rows(b[i], m, ld, 8 * j, 8 * (n0 + i), lane);
      mma3_rows(part, a[j], b);
    }
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + i][e] += part[i][e];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv(const Args a) {
  extern __shared__ float4 smem_raw[];
  using S = DkvSmem<T, D>;
  S& sm = *reinterpret_cast<S*>(smem_raw);
  constexpr int kLd = S::kLd;
  constexpr int kN = D / 8;  // 8-column tiles of dK and dV

  const int z = blockIdx.x;   // b * heads + h
  const int kt = blockIdx.y;  // causal: the first key tiles are heaviest
  const int b = z / a.heads;
  const int h = z % a.heads;
  const int k0 = kt * kKeys;
  const int k_rows = min(kKeys, a.sk - k0);
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;  // the warp's first key
  const int g = lane >> 2;
  const int t = lane & 3;

  const T* qp = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* op = static_cast<const T*>(a.dout) + b * a.osb + h * a.osh;
  const long long row0 = static_cast<long long>(z) * a.sq;
  // Causal: query tiles wholly before this key tile see none of its keys;
  // the loop starts at the diagonal (and is empty past the last query).
  const int n_qt = a.sq / kQRows;
  const int qt0 = a.causal ? k0 / kQRows : 0;
  auto stage_q = [&](int qt) {
    const int q0 = qt * kQRows;
    const int st = qt % kStages;
    stage_rows<T, D, kThreads>(sm.q[st], qp + q0 * a.qss, a.qss, kQRows,
                               kQRows, a.d, a.vec);
    stage_rows<T, D, kThreads>(sm.dout[st], op + q0 * a.oss, a.oss, kQRows,
                               kQRows, a.d, a.vec);
    const int i = threadIdx.x;
    if (i < 3 * kQRows) {
      const int r = i % kQRows;
      const float* src = i < kQRows ? a.lse : i < 2 * kQRows ? a.delta
                                                             : a.glse;
      float* dst = i < kQRows       ? sm.lse[st]
                   : i < 2 * kQRows ? sm.delta[st]
                                    : sm.glse[st];
      // A null g_lse reads as zero.
      cp_async4(dst + r, src ? src + row0 + q0 + r : a.lse + row0 + q0 + r,
                src ? 4 : 0);
    }
  };
  stage_rows<T, D, kThreads>(
      sm.k, static_cast<const T*>(a.k) + b * a.ksb + k0 * a.kss + h * a.ksh,
      a.kss, kKeys, k_rows, a.d, a.vec);
  stage_rows<T, D, kThreads>(
      sm.v, static_cast<const T*>(a.v) + b * a.vsb + k0 * a.vss + h * a.vsh,
      a.vss, kKeys, k_rows, a.d, a.vec);
  if (qt0 < n_qt) stage_q(qt0);
  cp_async_commit();

  float dk[kN][4], dv[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[n][e] = 0.f;
      dv[n][e] = 0.f;
    }

  for (int qt = qt0; qt < n_qt; ++qt) {
    if (qt + 1 < n_qt) stage_q(qt + 1);  // its stage was consumed at qt - 1
    cp_async_commit();
    cp_async_wait<1>();  // everything but the copy just issued has landed
    __syncthreads();
    const int q0 = qt * kQRows;
    const int st = qt % kStages;
    const T* qs = sm.q[st];
    const T* os = sm.dout[st];
    // The warp's keys exist, and some query of the tile sees one of them.
    if (r0 < k_rows && (!a.causal || q0 + kQRows - 1 >= k0 + r0)) {
      // Transposed tiles, rows the warp's 16 keys and columns the tile's
      // queries: s^T = k q^T and dP^T = v dO^T, 4 tiles of 8 queries.
      float pt[kQRows / 8][4], dsT[kQRows / 8][4];
#pragma unroll
      for (int j = 0; j < kQRows / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pt[j][e] = 0.f;
          dsT[j][e] = 0.f;
        }
#pragma unroll 2
      for (int kk = 0; kk < D; kk += 8) {
        FragA fa;
        FragB fb[kQRows / 8];
        load_a(fa, sm.k, kLd, r0, kk, lane);
#pragma unroll
        for (int j = 0; j < kQRows / 8; ++j)
          load_b_cols(fb[j], qs, kLd, 8 * j, kk, lane);
        mma3_rows(pt, fa, fb);
      }
#pragma unroll 2
      for (int kk = 0; kk < D; kk += 8) {
        FragA fa;
        FragB fb[kQRows / 8];
        load_a(fa, sm.v, kLd, r0, kk, lane);
#pragma unroll
        for (int j = 0; j < kQRows / 8; ++j)
          load_b_cols(fb[j], os, kLd, 8 * j, kk, lane);
        mma3_rows(dsT, fa, fb);
      }
      // p^T = exp(s^T * scale - lse) (0 where masked) and dS^T = p^T (dP^T
      // - delta + g_lse) * scale, in place: this thread holds keys g (e =
      // 0, 1) and g + 8 (e = 2, 3), queries 8j + 2t + (e & 1).
#pragma unroll
      for (int j = 0; j < kQRows / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const bool masked =
              a.causal && q0 + col < k0 + r0 + g + 8 * (e >> 1);
          const float p =
              masked ? 0.f : expf(pt[j][e] * a.scale - sm.lse[st][col]);
          const float dlt = sm.delta[st][col] - sm.glse[st][col];
          pt[j][e] = p;
          dsT[j][e] = p * (dsT[j][e] - dlt) * a.scale;
        }
      // dV += p^T dO and dK += dS^T q over this tile's queries.
      add_rows<kG>(dv, pt, os, kLd, lane);
      add_rows<kG>(dk, dsT, qs, kLd, lane);
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  T* outs[2] = {static_cast<T*>(a.out0), static_cast<T*>(a.out1)};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= k_rows) continue;
    const long long base =
        ((static_cast<long long>(b) * a.sk + k0 + row) * a.heads + h) * a.d;
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * n + 2 * t + c;
        if (col < a.d) {
          outs[0][base + col] = from_f32<T>(dk[n][2 * i + c]);
          outs[1][base + col] = from_f32<T>(dv[n][2 * i + c]);
        }
      }
  }
}

template <typename Smem>
int launch(void (*kernel)(const Args), const Args& a, int batch, int tiles,
           cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(batch) * a.heads, tiles);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(bool dkv, const Args& a, int batch, cudaStream_t stream) {
  if (dkv) {
    const int tiles = (a.sk + kKeys - 1) / kKeys;
    if (a.d <= 64)
      return launch<DkvSmem<T, 64>>(flash_bwd_dkv<T, 64>, a, batch, tiles,
                                    stream);
    return launch<DkvSmem<T, 128>>(flash_bwd_dkv<T, 128>, a, batch, tiles,
                                   stream);
  }
  if (a.d <= 64)
    return launch<DqSmem<64>>(flash_bwd_dq<T, 64>, a, batch, a.sq / kB,
                              stream);
  return launch<DqSmem<128>>(flash_bwd_dq<T, 128>, a, batch, a.sq / kB,
                             stream);
}

bool aligned16(const void* p, long long stride_elems, int itemsize) {
  return (reinterpret_cast<uintptr_t>(p) % 16) == 0 &&
         (stride_elems * itemsize) % 16 == 0;
}

int run(bool dkv, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta,
        const void* glse, void* out0, void* out1, int batch, int heads,
        int sq, int sk, int d, long long qsb, long long qss, long long qsh,
        long long ksb, long long kss, long long ksh, long long vsb,
        long long vss, long long vsh, long long osb, long long oss,
        long long osh, int causal, int dtype, float scale, void* stream) {
  if (batch < 0 || heads < 0 || sq < 0 || sk < 0 || d < 1 || d > 128 ||
      sq % kB || sk % kB) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || heads == 0 || (dkv ? sk : sq) == 0) return 0;
  const int itemsize = dtype == 0 ? 4 : 2;
  const int vec_elems = 16 / itemsize;
  Args a{q,
         k,
         v,
         dout,
         static_cast<const float*>(lse),
         static_cast<const float*>(delta),
         static_cast<const float*>(glse),
         out0,
         out1,
         heads,
         sq,
         sk,
         d,
         causal,
         0,
         qsb,
         qss,
         qsh,
         ksb,
         kss,
         ksh,
         vsb,
         vss,
         vsh,
         osb,
         oss,
         osh,
         scale};
  a.vec = d % vec_elems == 0 && aligned16(q, qss, itemsize) &&
          aligned16(q, qsb, itemsize) && aligned16(q, qsh, itemsize) &&
          aligned16(k, kss, itemsize) && aligned16(k, ksb, itemsize) &&
          aligned16(k, ksh, itemsize) && aligned16(v, vss, itemsize) &&
          aligned16(v, vsb, itemsize) && aligned16(v, vsh, itemsize) &&
          aligned16(dout, oss, itemsize) && aligned16(dout, osb, itemsize) &&
          aligned16(dout, osh, itemsize);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float>(dkv, a, batch, s);
    case 1:
      return dispatch<__nv_bfloat16>(dkv, a, batch, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, dout: [B, sq, H, d]; k, v: [B, sk, H, d]; each with unit column stride
// and the given batch, row and head strides (elements). lse, delta and glse
// (glse may be null, meaning zero): contiguous [B*H, sq] float32. dtype: 0 =
// float32, 1 = bfloat16 (q, k, v, dout and the outputs share it). sq and sk
// are multiples of 64, 1 <= d <= 128.

// K4: dq, contiguous [B, sq, H, d].
extern "C" int tpushare_flash_backward_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* glse, void* dq,
    int batch, int heads, int sq, int sk, int d, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh, int causal, int dtype,
    float scale, void* stream) {
  return run(false, q, k, v, dout, lse, delta, glse, dq, nullptr, batch,
             heads, sq, sk, d, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
             osb, oss, osh, causal, dtype, scale, stream);
}

// K5: dk and dv, contiguous [B, sk, H, d].
extern "C" int tpushare_flash_backward_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* glse, void* dk,
    void* dv, int batch, int heads, int sq, int sk, int d, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh, int causal, int dtype,
    float scale, void* stream) {
  return run(true, q, k, v, dout, lse, delta, glse, dk, dv, batch, heads,
             sq, sk, d, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb,
             oss, osh, causal, dtype, scale, stream);
}
