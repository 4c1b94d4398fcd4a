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
// full past block; by this design's three TF32 products (495 TFLOP/s, 165
// TFLOP/s of f32 products) K4 takes at least 0.312 / 0.625 ms and K5 0.417
// / 0.833 ms (at the card's f32 CUDA-core rate, 67 TFLOP/s, 0.769 / 1.538
// and 1.026 / 2.051 ms); the bytes take 0.1 ms.
//
// Design. Two kernels on the tensor cores by the 3xTF32 split (tf32x3.cuh:
// each operand split into two TF32 halves as its fragment is loaded, three
// mma.sync m16n8k8 products a step, small terms first, f32 accumulators),
// p and dS on the CUDA cores. Each output tile has exactly one writer, no
// atomics and a fixed order of sums, so the gradients are the same bits on
// every run (co-located training must equal solo training bit for bit). A
// Pallas grid axis that runs in order becomes a loop inside the block.
//   K4: one block of 8 warps per (batch*head, 128-row query tile); warp w
//     owns rows 16w..16w+15 and their [16, D] dQ accumulator in registers.
//     The q and dO tiles, with their rows of lse, delta and g_lse, stay in
//     shared memory; k and v stream in 32-key stages through a two-stage
//     ring filled by cp.async, so the next stage's copy runs under this
//     one's products, up to the tile's last row in causal mode. Per stage a
//     warp computes s = q k^T and dP = dO v^T ([16, 32], one chain over D
//     each, in one loop), turns them into p and dS in place, and feeds dS
//     from its registers as the A operand of dQ += dS k (B = k read along
//     its rows, which wgmma's K-major tf32 form cannot do), kG = 8 output
//     tiles at a time (add_rows). That product runs over the stage's 32
//     keys from zero and is added to dQ in f32, so no chain of truncating
//     tensor-core sums spans the keys (tf32x3.cuh). Tiles, at D = 128 in
//     f32: q and dO 132 KB, two stages of k and v 66 KB, 200 KB in all of
//     the 227 KB a block may use. A 64-row tile (4 warps) with 64-key
//     stages, s and dP in two loops over D, and the loop over D unrolled
//     by 2 (K3's and K5's) measured slower (PERF.md §6). A tile of sq % 128 = 64 stages its second half as zeros and
//     writes none of it. A warp whose rows all precede a key stage skips
//     its products; the last query tiles go first in causal mode.
//   K5: one block of 8 warps per (batch*head, 128-key tile); warp w owns
//     keys 16w..16w+15 and their [16, D] dK and dV accumulators in
//     registers.
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

constexpr int kTile = 64;      // sq and sk are multiples of this
constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 128;     // K4: query rows per block, 8 warps x 16
constexpr int kKeyRows = 32;   // K4: keys per ring stage
constexpr int kKeys = 128;     // K5: keys per block, 8 warps x 16
constexpr int kQRows = 32;     // K5: query rows per ring stage
constexpr int kStages = 2;     // K4: the k and v ring; K5: the q and dO ring
constexpr int kG = 8;          // output tiles of dQ, dV or dK in flight

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

// K4: the block's q and dO tiles stay, with their rows of lse, delta and
// g_lse; k and v tiles stream through the ring.
template <typename T, int D>
struct DqSmem {
  static constexpr int kLd = row_len<T, D>();
  T q[kRows * kLd];
  T dout[kRows * kLd];
  T k[kStages][kKeyRows * kLd];
  T v[kStages][kKeyRows * kLd];
  float lse[kRows];
  float delta[kRows];
  float glse[kRows];
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
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq(const Args a) {
  extern __shared__ float4 smem_raw[];
  using S = DqSmem<T, D>;
  S& sm = *reinterpret_cast<S*>(smem_raw);
  constexpr int kLd = S::kLd;
  constexpr int kN = D / 8;         // 8-column tiles of dQ
  constexpr int kJ = kKeyRows / 8;  // 8-key tiles of s, dP and dS

  const int z = blockIdx.x;                   // b * heads + h
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest tiles first
  const int b = z / a.heads;
  const int h = z % a.heads;
  const int q0 = qt * kRows;
  const int q_rows = min(kRows, a.sq - q0);
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;  // the warp's first row
  const int g = lane >> 2;
  const int t = lane & 3;

  const T* kp = static_cast<const T*>(a.k) + b * a.ksb + h * a.ksh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vsb + h * a.vsh;
  const long long row0 = static_cast<long long>(z) * a.sq + q0;
  // Causal: keys past this tile's last row are masked for every row.
  const int k_end = a.causal ? min(a.sk, q0 + q_rows) : a.sk;
  const int n_kt = (k_end + kKeyRows - 1) / kKeyRows;
  auto stage_kv = [&](int kt) {
    const int k0 = kt * kKeyRows;
    stage_rows<T, D, kThreads>(sm.k[kt % kStages], kp + k0 * a.kss, a.kss,
                                 kKeyRows, kKeyRows, a.d, a.vec);
    stage_rows<T, D, kThreads>(sm.v[kt % kStages], vp + k0 * a.vss, a.vss,
                                 kKeyRows, kKeyRows, a.d, a.vec);
  };
  // The rows from q_rows on (the second half of a tile of sq % 128 = 64)
  // stage as zeros and are never written.
  stage_rows<T, D, kThreads>(
      sm.q, static_cast<const T*>(a.q) + b * a.qsb + q0 * a.qss + h * a.qsh,
      a.qss, kRows, q_rows, a.d, a.vec);
  stage_rows<T, D, kThreads>(
      sm.dout,
      static_cast<const T*>(a.dout) + b * a.osb + q0 * a.oss + h * a.osh,
      a.oss, kRows, q_rows, a.d, a.vec);
  for (int i = threadIdx.x; i < 3 * kRows; i += kThreads) {
    const int r = i % kRows;
    const float* src = i < kRows ? a.lse : i < 2 * kRows ? a.delta : a.glse;
    float* dst = i < kRows ? sm.lse : i < 2 * kRows ? sm.delta : sm.glse;
    // A null g_lse reads as zero, as do the rows past q_rows.
    const bool live = src != nullptr && r < q_rows;
    cp_async4(dst + r, live ? src + row0 + r : a.lse, live ? 4 : 0);
  }
  if (n_kt > 0) stage_kv(0);
  cp_async_commit();

  float dq[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) stage_kv(kt + 1);  // its stage was consumed at kt - 1
    cp_async_commit();
    cp_async_wait<1>();  // everything but the copy just issued has landed
    __syncthreads();
    const int k0 = kt * kKeyRows;
    const T* ks = sm.k[kt % kStages];
    const T* vs = sm.v[kt % kStages];
    // The warp's rows exist, and one of them sees a key of the tile.
    if (r0 < q_rows && (!a.causal || k0 <= q0 + r0 + 15)) {
      // s = q k^T and dP = dO v^T, [16, 32] as 4 tiles of 8 keys each, in
      // one loop over D: 8 independent chains.
      float s[kJ][4], dp[kJ][4];
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = 0.f;
          dp[j][e] = 0.f;
        }
#pragma unroll 4
      for (int kk = 0; kk < D; kk += 8) {
        FragA fa;
        FragB fb[kJ];
        load_a(fa, sm.q, kLd, r0, kk, lane);
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          load_b_cols(fb[j], ks, kLd, 8 * j, kk, lane);
        mma3_rows(s, fa, fb);
        load_a(fa, sm.dout, kLd, r0, kk, lane);
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          load_b_cols(fb[j], vs, kLd, 8 * j, kk, lane);
        mma3_rows(dp, fa, fb);
      }
      // p = exp(s * scale - lse) (0 where masked) and dS = p (dP - delta +
      // g_lse) * scale, in place in s: this thread holds rows g (e = 0, 1)
      // and g + 8 (e = 2, 3), keys 8j + 2t + (e & 1).
      float lse[2], dlt[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + g + 8 * i;
        lse[i] = sm.lse[row];
        dlt[i] = sm.delta[row] - sm.glse[row];
      }
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool masked = a.causal && q0 + r0 + g + 8 * (e >> 1) <
                                              k0 + 8 * j + 2 * t + (e & 1);
          const float p =
              masked ? 0.f : expf(s[j][e] * a.scale - lse[e >> 1]);
          s[j][e] = p * (dp[j][e] - dlt[e >> 1]) * a.scale;
        }
      // dQ += dS k over this stage's keys (k read along its rows).
      add_rows<kG>(dq, s, ks, kLd, lane);
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  T* out = static_cast<T*>(a.out0);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= q_rows) continue;
    const long long base =
        ((static_cast<long long>(b) * a.sq + q0 + row) * a.heads + h) * a.d;
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * n + 2 * t + c;
        if (col < a.d) out[base + col] = from_f32<T>(dq[n][2 * i + c]);
      }
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
  const int tiles = (a.sq + kRows - 1) / kRows;
  if (a.d <= 64)
    return launch<DqSmem<T, 64>>(flash_bwd_dq<T, 64>, a, batch, tiles, stream);
  return launch<DqSmem<T, 128>>(flash_bwd_dq<T, 128>, a, batch, tiles,
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
      sq % kTile || sk % kTile) {
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
