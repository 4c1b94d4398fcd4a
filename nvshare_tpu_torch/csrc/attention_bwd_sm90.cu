// Flash-attention backward for Hopper (sm_90a) in bf16 on the tensor cores:
// the dQ sweep (K4) and the dK/dV sweep (K5) of exact attention over
// [B, S, H, D] bf16 tensors, D = 64 or 128, each recomputing its tiles of
// probabilities from the forward's saved log-sum-exp. f32 inputs, and bf16
// of other widths, take the CUDA-core K4 and K5 in attention_bwd.cu.
//
// Replaces the Pallas TPU kernels nvshare_tpu/ops/attention.py
// `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel` (both called by
// `_flash_backward`) on bf16 inputs. Per pair of a query tile and a key
// tile: S = q k^T, P = exp(S * scale - lse) (0 where q_pos < k_pos in
// causal mode), dP = dO v^T, dS = P (dP - (delta - g_lse)) * scale; then
// dQ += dS k (K4), and dV += P^T dO, dK += dS^T q (K5, which works on the
// transposed tiles: rows are keys). delta = rowsum(dO * O) and g_lse (the
// LSE output's cotangent, or none) come in per query row in f32. dQ, dK
// and dV are written contiguous [B, S, H, d] in bf16.
//
// Bound: operations. At the training shape (B=4, S=2048, H=32, D=128,
// causal) each product does 2*B*H*S*S*D/2 = 6.87e10 flops: K4's three
// take 0.208 ms at the card's dense bf16 rate and K5's four 0.278 ms,
// against 0.4 GB of q, k, v, dO, lse and delta and 0.07 GB (dQ) or 0.13 GB
// (dK and dV) of outputs.
//
// Both kernels give each output tile exactly one writer and use no
// atomics, so the gradients are the same bits on every run (co-located
// training must equal solo training bit for bit). Both have three
// warpgroups: warpgroup 0 is the producer, whose one thread issues every
// load (TMA, and bulk copies) into shared memory, each ring stage guarded
// by a "full" and an "empty" barrier, and which gives its registers away
// (setmaxnreg); warpgroups 1 and 2 are the consumers, each owning 64 rows
// of the block's tile.
//
// K4 design. One block owns one (batch*head, 128-query tile); causal tiles
// are scheduled heaviest (last) first. The producer loads the q and dO
// tiles once, then streams the 64-key k and v tiles through a ring of two
// stages, stopping in causal mode at the tile that holds the block's last
// query. A consumer thread owns two query rows (the accumulator layout),
// so it reads their lse, delta and g_lse from global memory once, before
// the loop. Per key tile, in each consumer:
//   S = q k^T, dP = dO v^T   wgmma m64n64k16, operands from shared memory,
//                            both K-major;
//   P, dS                    in registers in f32 on the accumulator layout,
//                            then dS rounded to bf16 A fragments in place;
//   dQ += dS k               wgmma m64nDk16, A from registers, k MN-major;
// with the dQ accumulator (64 x D f32) in registers across the loop. Key
// tiles wholly past a consumer's last query (causal) are dead for it but
// live for the other: it skips their products and still releases the
// stage.
//
// K5 design. One block of three warpgroups owns one (batch*head, 128-key
// tile). The producer loads the k and v tiles once by TMA, then streams
// the 64-row q and dO tiles (TMA) and the tile's lse, delta and g_lse rows
// (bulk copies) through a ring of two stages. Each consumer owns 64 keys
// and loops over the query tiles, from the diagonal on in causal mode (the
// first key tiles are heaviest and are scheduled first); per query tile:
//   S^T = k q^T, dP^T = v dO^T   wgmma m64n64k16, operands from shared
//                                memory, both K-major;
//   P^T, dS^T                    in registers in f32 on the accumulator
//                                layout, then rounded to bf16 A fragments
//                                (the accumulator's registers packed in
//                                pairs);
//   dV += P^T dO, dK += dS^T q   wgmma m64nDk16, A from registers, dO and q
//                                MN-major;
// with the dK and dV accumulators (64 x D f32 each) in registers across the
// loop.
//
// Numerics against the plain versions (flash_backward_dq_reference and
// flash_backward_dkv_reference, f32 throughout). Products of bf16 operands
// are exact in f32, so S, dP and P in f32 differ from them only by
// summation order and exp2's rounding. The new rounding points are dS (K4
// and K5) and P^T (K5), each rounded to bf16 before its product (the
// tensor cores take bf16 operands).
//
// C interface (bound with ctypes): returns 0 or the cudaError_t of the
// launch, or sm90::kErrNoEncoder / kErrEncode + a CUresult (sm90.cuh).

#include "sm90.cuh"

namespace {

using namespace sm90;

// K5's tiles (K4's are below).
constexpr int kBKV = 128;       // keys per block, 64 per consumer
constexpr int kBQ = 64;         // query rows per tile
constexpr int kStages = 2;      // the ring: K5's q/dO, K4's k/v
constexpr int kThreads = 384;   // producer + two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Dkv {
  static constexpr int kKVBytes = kBKV * D * 2;  // the k or the v tile
  static constexpr int kTileBytes = kBQ * D * 2;  // a q or a dO tile
  static constexpr int kRowBytes = kBQ * 4;       // lse, delta or g_lse
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKVBytes;
  static constexpr int kStage0 = kV + kKVBytes;
  // Within a stage: q, dO, then the three rows; stages 1,024-aligned.
  static constexpr int kSQ = 0;
  static constexpr int kSDo = kTileBytes;
  static constexpr int kSLse = 2 * kTileBytes;
  static constexpr int kSDelta = kSLse + kRowBytes;
  static constexpr int kSGlse = kSDelta + kRowBytes;
  static constexpr int kStageBytes = (kSGlse + kRowBytes + 1023) / 1024 * 1024;
  static constexpr int kBar = kStage0 + kStages * kStageBytes;
  // kv_full, then full and empty per stage.
  static constexpr int kSmem = kBar + 8 * (1 + 2 * kStages) + 1024;
};

struct DkvArgs {
  const float* lse;    // [B*H, sq]
  const float* delta;  // [B*H, sq]
  const float* glse;   // [B*H, sq] or null (zero)
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int heads, sq, sk, causal;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv,
                       const __grid_constant__ CUtensorMap mdo,
                       const DkvArgs a) {
  using L = Dkv<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t kv_full = base + L::kBar;
  auto full = [&](int s) { return base + L::kBar + 8 + 8 * s; };
  auto empty = [&](int s) { return base + L::kBar + 8 + 8 * (kStages + s); };
  auto stage = [&](int s) { return base + L::kStage0 + s * L::kStageBytes; };

  const int bh = blockIdx.x;           // b * heads + h
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int k0 = blockIdx.y * kBKV;    // causal: the first tiles are heaviest
  // Causal: query tiles wholly before this key tile see none of its keys;
  // the loop starts at the diagonal (and is empty past the last query).
  const int qt0 = a.causal ? k0 / kBQ : 0;
  const int n_it = max(a.sq / kBQ - qt0, 0);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread issues every load.
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::kKVBytes);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(base + L::kK + c * kBKV * 128, &mk, kv_full, c * 64, h,
                    k0, b);
        tma_load_4d(base + L::kV + c * kBKV * 128, &mv, kv_full, c * 64, h,
                    k0, b);
      }
      const uint32_t rows = a.glse ? 3 : 2;
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        const int q0 = (qt0 + it) * kBQ;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        const uint32_t st = stage(s);
        mbar_expect_tx(full(s), 2 * L::kTileBytes + rows * L::kRowBytes);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(st + L::kSQ + c * kBQ * 128, &mq, full(s), c * 64, h,
                      q0, b);
          tma_load_4d(st + L::kSDo + c * kBQ * 128, &mdo, full(s), c * 64, h,
                      q0, b);
        }
        const long long r0 = static_cast<long long>(bh) * a.sq + q0;
        bulk_load(st + L::kSLse, a.lse + r0, L::kRowBytes, full(s));
        bulk_load(st + L::kSDelta, a.delta + r0, L::kRowBytes, full(s));
        if (a.glse)
          bulk_load(st + L::kSGlse, a.glse + r0, L::kRowBytes, full(s));
      }
    }
  } else {
    reg_alloc<232>();
    const int cw = wg - 1;            // keys 64 cw .. 64 cw + 63 of the tile
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int key = k0 + 64 * cw + 16 * (t / 32) + lane / 4;  // and key + 8
    const int col = 2 * (lane % 4);   // query column within a tile: + 8j, + 1
    const float sl2 = a.scale * kLog2e;
    const uint32_t ka = base + L::kK + cw * 64 * 128;
    const uint32_t va = base + L::kV + cw * 64 * 128;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      dk[i] = 0.f;
      dv[i] = 0.f;
    }

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kStages;
      const int q0 = (qt0 + it) * kBQ;
      const uint32_t st = stage(s);
      mbar_wait(full(s), (it / kStages) & 1);

      // S^T = k q^T and dP^T = v dO^T over D in steps of 16 columns.
      float sv[kBQ / 2], dp[kBQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBKV * 128 + (kk % 4) * 32;
        const uint32_t qoff = (kk / 4) * kBQ * 128 + (kk % 4) * 32;
        Mma<kBQ>::ss(sv, desc_sw128(ka + off, 16, 1024),
                     desc_sw128(st + L::kSQ + qoff, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBKV * 128 + (kk % 4) * 32;
        const uint32_t qoff = (kk / 4) * kBQ * 128 + (kk % 4) * 32;
        Mma<kBQ>::ss(dp, desc_sw128(va + off, 16, 1024),
                     desc_sw128(st + L::kSDo + qoff, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sv);
      fence_regs(dp);

      // P^T and dS^T in f32, then as bf16 A fragments. Column j's query
      // rows are q0 + 8j + col and the next: their lse and delta - g_lse
      // are two adjacent floats of the stage's rows.
      const float* rows =
          reinterpret_cast<const float*>(smem_raw + (st - raw));
      const float* lse_r = rows + L::kSLse / 4;
      const float* dlt_r = rows + L::kSDelta / 4;
      const float* gl_r = rows + L::kSGlse / 4;
      // Causal: only tiles that start before this thread's last key mask.
      const bool masked = a.causal && q0 < key + 8;
      uint32_t pf[kBQ / 4], df[kBQ / 4];
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j) {
        const int c = 8 * j + col;
        const float2 lse = *reinterpret_cast<const float2*>(lse_r + c);
        float2 dl = *reinterpret_cast<const float2*>(dlt_r + c);
        if (a.glse) {
          const float2 g = *reinterpret_cast<const float2*>(gl_r + c);
          dl.x -= g.x;
          dl.y -= g.y;
        }
        const int qpos = q0 + c;
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = i % 2;            // query column qpos + e
          const int kr = key + 8 * (i / 2);  // key row
          const float l2 = (e ? lse.y : lse.x) * kLog2e;
          const float x = exp2f(fmaf(sv[4 * j + i], sl2, -l2));
          p[i] = masked && qpos + e < kr ? 0.f : x;
          ds[i] = p[i] * (dp[4 * j + i] - (e ? dl.y : dl.x)) * a.scale;
        }
        pf[2 * j] = pack_bf16(p[0], p[1]);
        pf[2 * j + 1] = pack_bf16(p[2], p[3]);
        df[2 * j] = pack_bf16(ds[0], ds[1]);
        df[2 * j + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dV += P^T dO and dK += dS^T q over the tile's queries in steps of 16.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        Mma<D>::rs_t(dv, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2],
                     pf[4 * kk + 3],
                     desc_sw128(st + L::kSDo + kk * 2048, kBQ * 128, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        Mma<D>::rs_t(dk, df[4 * kk], df[4 * kk + 1], df[4 * kk + 2],
                     df[4 * kk + 3],
                     desc_sw128(st + L::kSQ + kk * 2048, kBQ * 128, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pf);
      fence_regs(df);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    // Write this thread's two key rows of dK and dV.
    const long long rs = static_cast<long long>(a.heads) * D;
    const long long at =
        (static_cast<long long>(b) * a.sk + key) * rs + h * D + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(a.dk + at + 8 * j) =
          __floats2bfloat162_rn(dk[4 * j], dk[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(a.dk + at + 8 * rs + 8 * j) =
          __floats2bfloat162_rn(dk[4 * j + 2], dk[4 * j + 3]);
      *reinterpret_cast<__nv_bfloat162*>(a.dv + at + 8 * j) =
          __floats2bfloat162_rn(dv[4 * j], dv[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(a.dv + at + 8 * rs + 8 * j) =
          __floats2bfloat162_rn(dv[4 * j + 2], dv[4 * j + 3]);
    }
  }
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const DkvArgs& a, int batch, const long long (&st)[12],
               cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  int rc = encode_bshd(&mq, q, batch, a.sq, a.heads, D, st[0], st[1], st[2],
                       kBQ);
  if (rc == 0)
    rc = encode_bshd(&mk, k, batch, a.sk, a.heads, D, st[3], st[4], st[5],
                     kBKV);
  if (rc == 0)
    rc = encode_bshd(&mv, v, batch, a.sk, a.heads, D, st[6], st[7], st[8],
                     kBKV);
  if (rc == 0)
    rc = encode_bshd(&mdo, dout, batch, a.sq, a.heads, D, st[9], st[10],
                     st[11], kBQ);
  if (rc != 0) return rc;
  const int smem = Dkv<D>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(batch) * a.heads, a.sk / kBKV);
  flash_bwd_dkv_sm90<D><<<grid, kThreads, smem, stream>>>(mq, mk, mv, mdo, a);
  return static_cast<int>(cudaGetLastError());
}

// -- K4 ----------------------------------------------------------------------

constexpr int kDqBQ = 128;  // queries per block, 64 per consumer
constexpr int kDqBK = 64;   // keys per tile

template <int D>
struct Dq {
  static constexpr int kRowsBytes = 64 * D * 2;    // one consumer's q or dO
  static constexpr int kKVBytes = kDqBK * D * 2;   // a k or a v tile
  // q, then dO: consumer cw's 64 rows at cw * kRowsBytes of each.
  static constexpr int kQ = 0;
  static constexpr int kDo = 2 * kRowsBytes;
  static constexpr int kStage0 = 4 * kRowsBytes;
  // Within a stage: k, then v.
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kBar = kStage0 + kStages * kStageBytes;
  // qdo_full, then full and empty per stage.
  static constexpr int kSmem = kBar + 8 * (1 + 2 * kStages) + 1024;
};

struct DqArgs {
  const float* lse;    // [B*H, sq]
  const float* delta;  // [B*H, sq]
  const float* glse;   // [B*H, sq] or null (zero)
  __nv_bfloat16* dq;
  int heads, sq, sk, causal;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      const __grid_constant__ CUtensorMap mdo,
                      const DqArgs a) {
  using L = Dq<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t qdo_full = base + L::kBar;
  auto full = [&](int s) { return base + L::kBar + 8 + 8 * s; };
  auto empty = [&](int s) { return base + L::kBar + 8 + 8 * (kStages + s); };
  auto stage = [&](int s) { return base + L::kStage0 + s * L::kStageBytes; };

  const int bh = blockIdx.x;                             // b * heads + h
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqBQ;  // heaviest first
  // Causal: keys past this tile's last row are masked for every row.
  const int k_end = a.causal ? min(a.sk, q0 + kDqBQ) : a.sk;
  const int n_kt = (k_end + kDqBK - 1) / kDqBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread issues every load.
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qdo_full, 4 * L::kRowsBytes);
      for (int half = 0; half < 2; ++half)
        for (int c = 0; c < D / 64; ++c) {
          const uint32_t off = half * L::kRowsBytes + c * 64 * 128;
          tma_load_4d(base + L::kQ + off, &mq, qdo_full, c * 64, h,
                      q0 + 64 * half, b);
          tma_load_4d(base + L::kDo + off, &mdo, qdo_full, c * 64, h,
                      q0 + 64 * half, b);
        }
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        const uint32_t st = stage(s);
        mbar_expect_tx(full(s), 2 * L::kKVBytes);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(st + c * kDqBK * 128, &mk, full(s), c * 64, h,
                      it * kDqBK, b);
          tma_load_4d(st + L::kKVBytes + c * kDqBK * 128, &mv, full(s),
                      c * 64, h, it * kDqBK, b);
        }
      }
    }
  } else {
    reg_alloc<232>();
    const int cw = wg - 1;            // rows 64 cw .. 64 cw + 63 of the tile
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row = q0 + 64 * cw + 16 * (t / 32) + lane / 4;  // and row + 8
    const int col = 2 * (lane % 4);   // key column within a tile: + 8j, + 1
    const int last = q0 + 64 * cw + 63;  // this consumer's last query
    const float sl2 = a.scale * kLog2e;
    const uint32_t qa = base + L::kQ + cw * L::kRowsBytes;
    const uint32_t da = base + L::kDo + cw * L::kRowsBytes;

    // The two rows' terms: lse * log2(e), and delta - g_lse.
    const long long r = static_cast<long long>(bh) * a.sq + row;
    const float l2[2] = {a.lse[r] * kLog2e, a.lse[r + 8] * kLog2e};
    float dl[2] = {a.delta[r], a.delta[r + 8]};
    if (a.glse) {
      dl[0] -= a.glse[r];
      dl[1] -= a.glse[r + 8];
    }

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    mbar_wait(qdo_full, 0);
    for (int it = 0; it < n_kt; ++it) {
      const int s = it % kStages;
      const int k0 = it * kDqBK;
      const uint32_t ka = stage(s);
      const uint32_t va = ka + L::kKVBytes;
      mbar_wait(full(s), (it / kStages) & 1);

      if (!a.causal || k0 <= last) {
        // S = q k^T and dP = dO v^T over D in steps of 16 columns.
        float sv[kDqBK / 2], dp[kDqBK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t qoff = (kk / 4) * 64 * 128 + (kk % 4) * 32;
          const uint32_t koff = (kk / 4) * kDqBK * 128 + (kk % 4) * 32;
          Mma<kDqBK>::ss(sv, desc_sw128(qa + qoff, 16, 1024),
                         desc_sw128(ka + koff, 16, 1024), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t qoff = (kk / 4) * 64 * 128 + (kk % 4) * 32;
          const uint32_t koff = (kk / 4) * kDqBK * 128 + (kk % 4) * 32;
          Mma<kDqBK>::ss(dp, desc_sw128(da + qoff, 16, 1024),
                         desc_sw128(va + koff, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sv);
        fence_regs(dp);

        // P and dS in f32, then dS as bf16 A fragments. Column j's keys
        // are k0 + 8j + col and the next. Causal: only tiles that reach
        // past this thread's first row mask.
        const bool masked = a.causal && k0 + kDqBK - 1 > row;
        uint32_t df[kDqBK / 4];
#pragma unroll
        for (int j = 0; j < kDqBK / 8; ++j) {
          float ds[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = i / 2;                   // row + 8e
            const int key = k0 + 8 * j + col + i % 2;
            const float x = exp2f(fmaf(sv[4 * j + i], sl2, -l2[e]));
            const float p = masked && row + 8 * e < key ? 0.f : x;
            ds[i] = p * (dp[4 * j + i] - dl[e]) * a.scale;
          }
          df[2 * j] = pack_bf16(ds[0], ds[1]);
          df[2 * j + 1] = pack_bf16(ds[2], ds[3]);
        }

        // dQ += dS k over the tile's keys in steps of 16.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDqBK / 16; ++kk)
          Mma<D>::rs_t(dq, df[4 * kk], df[4 * kk + 1], df[4 * kk + 2],
                       df[4 * kk + 3],
                       desc_sw128(ka + kk * 2048, kDqBK * 128, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(df);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    // Write this thread's two query rows of dQ.
    const long long rs = static_cast<long long>(a.heads) * D;
    __nv_bfloat16* o0 =
        a.dq + (static_cast<long long>(b) * a.sq + row) * rs + h * D + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
          __floats2bfloat162_rn(dq[4 * j], dq[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * rs + 8 * j) =
          __floats2bfloat162_rn(dq[4 * j + 2], dq[4 * j + 3]);
    }
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const DqArgs& a, int batch, const long long (&st)[12],
              cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  int rc = encode_bshd(&mq, q, batch, a.sq, a.heads, D, st[0], st[1], st[2],
                       64);
  if (rc == 0)
    rc = encode_bshd(&mk, k, batch, a.sk, a.heads, D, st[3], st[4], st[5],
                     kDqBK);
  if (rc == 0)
    rc = encode_bshd(&mv, v, batch, a.sk, a.heads, D, st[6], st[7], st[8],
                     kDqBK);
  if (rc == 0)
    rc = encode_bshd(&mdo, dout, batch, a.sq, a.heads, D, st[9], st[10],
                     st[11], 64);
  if (rc != 0) return rc;
  const int smem = Dq<D>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(batch) * a.heads, a.sq / kDqBQ);
  flash_bwd_dq_sm90<D><<<grid, kThreads, smem, stream>>>(mq, mk, mv, mdo, a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// q, dout: bf16 [B, sq, H, d]; k, v: bf16 [B, sk, H, d]; each with unit
// column stride and the given batch, row and head strides (elements,
// multiples of 8; bases 16-byte aligned). lse, delta and glse (glse may be
// null, meaning zero): contiguous f32 [B*H, sq], 16-byte aligned. dk, dv:
// contiguous bf16 [B, sk, H, d]. d is 64 or 128; sq is a multiple of 64 and
// sk of 128. dtype must be 1 (bfloat16): the arguments are
// tpushare_flash_backward_dkv's (attention_bwd.cu).
extern "C" int tpushare_flash_backward_dkv_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* glse, void* dk,
    void* dv, int batch, int heads, int sq, int sk, int d, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh, int causal, int dtype,
    float scale, void* stream) {
  if (dtype != 1 || batch < 0 || heads < 0 || sq < 0 || sk < 0 ||
      (d != 64 && d != 128) ||
      sq % kBQ || sk % kBKV || !tma_ready(q, qsb, qss, qsh) ||
      !tma_ready(k, ksb, kss, ksh) || !tma_ready(v, vsb, vss, vsh) ||
      !tma_ready(dout, osb, oss, osh) || !aligned16(lse) ||
      !aligned16(delta) || !aligned16(glse)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || heads == 0 || sk == 0) return 0;
  const DkvArgs a{static_cast<const float*>(lse),
                  static_cast<const float*>(delta),
                  static_cast<const float*>(glse),
                  static_cast<__nv_bfloat16*>(dk),
                  static_cast<__nv_bfloat16*>(dv),
                  heads, sq, sk, causal, scale};
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_dkv<64>(q, k, v, dout, a, batch, st, s);
  return launch_dkv<128>(q, k, v, dout, a, batch, st, s);
}

// dq: contiguous bf16 [B, sq, H, d]; every other argument as for
// tpushare_flash_backward_dkv_sm90, except that sq is a multiple of 128
// and sk of 64 and at least 64. The arguments are
// tpushare_flash_backward_dq's (attention_bwd.cu).
extern "C" int tpushare_flash_backward_dq_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* glse, void* dq,
    int batch, int heads, int sq, int sk, int d, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh, int causal, int dtype,
    float scale, void* stream) {
  if (dtype != 1 || batch < 0 || heads < 0 || sq < 0 || sk < kDqBK ||
      (d != 64 && d != 128) ||
      sq % kDqBQ || sk % kDqBK || !tma_ready(q, qsb, qss, qsh) ||
      !tma_ready(k, ksb, kss, ksh) || !tma_ready(v, vsb, vss, vsh) ||
      !tma_ready(dout, osb, oss, osh) || !aligned16(lse) ||
      !aligned16(delta) || !aligned16(glse)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || heads == 0 || sq == 0) return 0;
  const DqArgs a{static_cast<const float*>(lse),
                 static_cast<const float*>(delta),
                 static_cast<const float*>(glse),
                 static_cast<__nv_bfloat16*>(dq), heads, sq, sk, causal,
                 scale};
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_dq<64>(q, k, v, dout, a, batch, st, s);
  return launch_dq<128>(q, k, v, dout, a, batch, st, s);
}
