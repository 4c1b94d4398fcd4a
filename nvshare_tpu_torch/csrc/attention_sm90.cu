// Flash-attention forward (K3) for Hopper (sm_90a) in bf16 on the tensor
// cores: exact softmax(q k^T / sqrt(d)) v over [B, S, H, D] bf16 tensors,
// D = 64 or 128, with the per-row log-sum-exp in f32.
//
// Replaces the Pallas TPU kernel nvshare_tpu/ops/attention.py `_flash_kernel`
// (called by `_flash_forward`) on bf16 inputs: online softmax over key
// tiles; scale = 1/sqrt(d); in causal mode the q_pos >= k_pos mask and no
// work for key tiles wholly in the future; O in bf16, LSE = m + log l in f32
// per row, O = 0 where l == 0. f32 inputs, and bf16 of other widths, take
// the CUDA-core kernel in attention.cu.
//
// Bound: operations. At the language model's scoring shape (B=4, S=2048,
// H=32, D=128, causal) the function does 4*B*H*S*S*D/2 = 1.37e11 flops,
// 0.139 ms at the card's dense bf16 rate, against 0.27 GB of q, k, v, o and
// lse (0.08 ms at 3.35 TB/s).
//
// Design (FlashAttention-3's shape, without its intra-warpgroup
// pipelining). One block of three warpgroups owns one (batch*head, 128-row
// query tile); causal tiles are scheduled heaviest first. Warpgroup 0 is
// the producer: one thread loads the q tile once and then streams the
// 128-key k and v tiles by TMA into a ring of two shared-memory stages,
// each stage guarded by "full" barriers (k and v apart, so the first
// product can start before v lands) and an "empty" barrier that the
// consumers release; it gives its registers away (setmaxnreg). Warpgroups
// 1 and 2 each own 64 query rows and, per key tile:
//   S = q k^T       wgmma m64n128k16, both operands from shared memory;
//   online softmax  in registers on the accumulator layout (a row lies in
//                   a quad of threads: two shuffles for its max; the sum is
//                   kept per thread and reduced once at the end), exp2 with
//                   scale * log2(e) folded in, the mask on the diagonal
//                   tile only;
//   O += P v        wgmma m64nDk16 with P as the register-A operand (the
//                   accumulator's registers, rounded to bf16 and packed in
//                   pairs: no shuffle, no shared memory) and v MN-major.
// q, k and v are read by TMA through 4-D tensor maps built on the host per
// launch with the caller's strides, so a view into a fused qkv projection
// needs no copy. O is written contiguous [B, S, H, d] from the registers.
// Every output row has one writer and the sums run in a fixed order, so
// runs repeat bit for bit.
//
// Numerics against the plain version (flash_attention_reference, f32
// throughout). Products of bf16 operands are exact in f32, so S and the
// LSE differ from it only by summation order. The one new rounding point
// is P, rounded to bf16 before P v (the tensor cores take bf16 operands);
// the row sum l is taken from the unrounded f32 P.
//
// C interface (bound with ctypes): returns 0 or the cudaError_t of the
// launch, or sm90::kErrNoEncoder / kErrEncode + a CUresult (sm90.cuh).

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBQ = 128;        // query rows per block, 64 per consumer
constexpr int kBK = 128;        // keys per tile
constexpr int kStages = 2;      // k/v ring
constexpr int kThreads = 384;   // producer + two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Fwd {
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;  // one k or v tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  // q_full, then k_full, v_full and empty per stage.
  static constexpr int kSmem = kBar + 8 * (1 + 3 * kStages) + 1024;
};

struct FwdArgs {
  __nv_bfloat16* o;
  float* lse;
  int heads, sq, sk, causal;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap mq,
                   const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv, const FwdArgs a) {
  using L = Fwd<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full = base + L::kBar;
  auto k_full = [&](int s) { return base + L::kBar + 8 + 8 * s; };
  auto v_full = [&](int s) { return base + L::kBar + 8 + 8 * (kStages + s); };
  auto empty = [&](int s) {
    return base + L::kBar + 8 + 8 * (2 * kStages + s);
  };

  const int bh = blockIdx.x;                  // b * heads + h
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  // Causal: keys past this tile's last row are masked for every row.
  const int k_end = a.causal ? min(a.sk, q0 + kBQ) : a.sk;
  const int n_kt = (k_end + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread issues every load.
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(base + L::kQ + c * kBQ * 128, &mq, q_full, c * 64, h,
                    q0, b);
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        const uint32_t ks = base + L::kK + s * L::kKVBytes;
        const uint32_t vs = base + L::kV + s * L::kKVBytes;
        mbar_expect_tx(k_full(s), L::kKVBytes);
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(ks + c * kBK * 128, &mk, k_full(s), c * 64, h,
                      it * kBK, b);
        mbar_expect_tx(v_full(s), L::kKVBytes);
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(vs + c * kBK * 128, &mv, v_full(s), c * 64, h,
                      it * kBK, b);
      }
    }
  } else {
    reg_alloc<232>();
    const int cw = wg - 1;              // rows 64 cw .. 64 cw + 63 of the tile
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row = q0 + 64 * cw + 16 * (t / 32) + lane / 4;  // and row + 8
    const int col = 2 * (lane % 4);     // + 8j, + 1
    const float sl2 = a.scale * kLog2e;
    const float neg_inf = __int_as_float(0xff800000);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = neg_inf, m1 = neg_inf, l0 = 0.f, l1 = 0.f;
    const uint32_t qa = base + L::kQ + cw * 64 * 128;

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_kt; ++it) {
      const int s = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const uint32_t ks = base + L::kK + s * L::kKVBytes;
      const uint32_t vs = base + L::kV + s * L::kKVBytes;

      // S = q k^T over D in steps of 16 columns.
      float sc[kBK / 2];
      mbar_wait(k_full(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns within a box
        Mma<kBK>::ss(sc,
                     desc_sw128(qa + (kk / 4) * kBQ * 128 + off, 16, 1024),
                     desc_sw128(ks + (kk / 4) * kBK * 128 + off, 16, 1024),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // The mask, on the tiles that reach past this warpgroup's first row.
      const int k0 = it * kBK;
      if (a.causal && k0 + kBK - 1 > q0 + 64 * cw) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * j + col + e;
            if (key > row) sc[4 * j + e] = neg_inf;
            if (key > row + 8) sc[4 * j + 2 + e] = neg_inf;
          }
      }

      // Online softmax: new row maxima (raw scores), the correction of the
      // running sums, then P in f32 and as bf16 A fragments.
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // A row with no live key yet keeps base 0, so exp2 gives 0, not NaN.
      const float b0 = mx0 == neg_inf ? 0.f : mx0 * sl2;
      const float b1 = mx1 == neg_inf ? 0.f : mx1 * sl2;
      const float corr0 = exp2f(m0 * sl2 - b0);
      const float corr1 = exp2f(m1 * sl2 - b1);
      m0 = mx0;
      m1 = mx1;
      l0 *= corr0;
      l1 *= corr1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corr0;
        o[4 * j + 1] *= corr0;
        o[4 * j + 2] *= corr1;
        o[4 * j + 3] *= corr1;
      }
      uint32_t pf[kBK / 4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const float p00 = exp2f(fmaf(sc[4 * j], sl2, -b0));
        const float p01 = exp2f(fmaf(sc[4 * j + 1], sl2, -b0));
        const float p10 = exp2f(fmaf(sc[4 * j + 2], sl2, -b1));
        const float p11 = exp2f(fmaf(sc[4 * j + 3], sl2, -b1));
        l0 += p00 + p01;
        l1 += p10 + p11;
        pf[2 * j] = pack_bf16(p00, p01);
        pf[2 * j + 1] = pack_bf16(p10, p11);
      }

      // O += P v over the tile's keys in steps of 16.
      mbar_wait(v_full(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        Mma<D>::rs_t(o, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2],
                     pf[4 * kk + 3],
                     desc_sw128(vs + kk * 2048, kBK * 128, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pf);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    // Flush: O = acc / l (0 where l == 0), LSE = m * scale + log l.
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    const long long rs = static_cast<long long>(a.heads) * D;
    __nv_bfloat16* o0 =
        a.o + (static_cast<long long>(b) * a.sq + row) * rs + h * D + col;
    __nv_bfloat16* o1 = o0 + 8 * rs;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    if (lane % 4 == 0) {
      float* lse = a.lse + static_cast<long long>(bh) * a.sq + row;
      lse[0] = l0 > 0.f ? m0 * a.scale + logf(l0) : -1e30f;
      lse[8] = l1 > 0.f ? m1 * a.scale + logf(l1) : -1e30f;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const FwdArgs& a,
           int batch, long long qsb, long long qss, long long qsh,
           long long ksb, long long kss, long long ksh, long long vsb,
           long long vss, long long vsh, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int rc = encode_bshd(&mq, q, batch, a.sq, a.heads, D, qsb, qss, qsh, kBQ);
  if (rc == 0)
    rc = encode_bshd(&mk, k, batch, a.sk, a.heads, D, ksb, kss, ksh, kBK);
  if (rc == 0)
    rc = encode_bshd(&mv, v, batch, a.sk, a.heads, D, vsb, vss, vsh, kBK);
  if (rc != 0) return rc;
  const int smem = Fwd<D>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(batch) * a.heads, a.sq / kBQ);
  flash_fwd_sm90<D><<<grid, kThreads, smem, stream>>>(mq, mk, mv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: bf16 [B, S, H, d] with unit column stride and the given batch,
// row and head strides (elements, multiples of 8; bases 16-byte aligned);
// o: contiguous bf16 [B, sq, H, d]; lse: contiguous f32 [B*H, sq]. d is 64
// or 128; sq and sk are multiples of 128. dtype must be 1 (bfloat16): the
// arguments are tpushare_flash_forward's (attention.cu).
extern "C" int tpushare_flash_forward_sm90(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int heads, int sq, int sk, int d, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, int causal,
    int dtype, float scale, void* stream) {
  if (dtype != 1 || batch < 0 || heads < 0 || sq < 0 || sk < 1 ||
      (d != 64 && d != 128) ||
      sq % kBQ || sk % kBK || !tma_ready(q, qsb, qss, qsh) ||
      !tma_ready(k, ksb, kss, ksh) || !tma_ready(v, vsb, vss, vsh)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || heads == 0 || sq == 0) return 0;
  const FwdArgs a{static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
                  heads, sq, sk, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<64>(q, k, v, a, batch, qsb, qss, qsh, ksb, kss, ksh, vsb,
                      vss, vsh, s);
  return launch<128>(q, k, v, a, batch, qsb, qss, qsh, ksb, kss, ksh, vsb,
                     vss, vsh, s);
}
