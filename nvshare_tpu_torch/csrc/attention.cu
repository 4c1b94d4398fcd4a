// Flash-attention forward for Hopper (sm_90a), the f32 route: exact
// softmax(q k^T / sqrt(d)) v over [B, S, H, D] tensors, with the per-row
// log-sum-exp, never forming the S x S score matrix in device memory.
//
// Replaces the Pallas TPU kernel nvshare_tpu/ops/attention.py `_flash_kernel`
// (called by `_flash_forward`): online softmax over key tiles; scale =
// 1/sqrt(d); in causal mode the q_pos >= k_pos mask (-1e30 elsewhere) and
// no work for key tiles wholly in the future; O in q's type; LSE in f32 per
// row (m + log l); rows with l == 0 give 0, and a NaN among a row's
// scores gives NaN in its O and LSE, as in the plain version (the Pallas
// kernel writes 0 to that O row). This is the route of f32, and
// of bf16 at head widths other than 64 and 128 (bf16 at 64 or 128 takes the
// wgmma kernel in attention_sm90.cu); bf16 is staged as it lies and read
// as f32, d is zero-padded to the 64 or 128 template.
//
// Bound: operations. The two products do 4*B*H*Sq*Sk*D flops (half of it
// in causal mode), against 4 bytes an element of q, k, v, o and the LSE.
// At the ring's blocks, [4, 1024, 32, 128] f32, that is 3.44e10 flops on a
// causal diagonal block and 6.87e10 on a full past block against 0.27 GB:
// 0.513 / 1.026 ms at the card's f32 CUDA-core rate (67 TFLOP/s), and
// 0.208 / 0.417 ms for this design, three TF32 products at 495 TFLOP/s
// (165 TFLOP/s of f32 products); the bytes take 0.08 ms.
//
// Design: the products on the tensor cores by the 3xTF32 split
// (tf32x3.cuh: each operand split into two TF32 halves as its fragment is
// loaded, three mma.sync m16n8k8 products a step, small terms first, f32
// accumulators), the softmax on the CUDA cores. One block of 8 warps owns
// one (batch, head, 128-row query tile); warp w owns rows 16w..16w+15, its
// running max m, normalizer l (a partial sum per thread, summed over the
// row's four lanes at the end) and the [16, D] output accumulator in
// registers. A loop over 64-key tiles takes the place of the Pallas grid's
// sequential key axis. Per tile a warp computes S = q k^T ([16, 64], A = q
// from shared memory, B = k), masks and exponentiates it in place, and
// feeds P from its registers as the A operand of P v (B = v read along its
// rows, which wgmma's K-major tf32 form cannot do). P v runs kG = 8 output
// tiles at a time, so that 8 independent chains of mma.sync hide each
// other's latency; each tile's product over the 64 keys starts from zero
// and is added to the accumulator in f32, so no chain of truncating
// tensor-core sums spans the keys (tf32x3.cuh). The q tile stays in shared
// memory; the k and v tiles stream through a two-stage ring filled by
// cp.async, so the next tile's copy runs under this tile's products.
// Tiles, at D = 128 in f32: q 66 KB, two stages of k and v 132 KB, 198 KB
// in all of the 227 KB a block may use: one block (8 warps) an SM. The
// operands stay as they lie and are split at every fragment load (8 warps
// each split the whole k and v tile): splitting k and v once a block into
// shared memory leaves room for 32-key tiles only, and measured slower
// (PERF.md §6, with the other choices measured on the card by
// kernel_ab.py). In causal mode a warp whose rows
// all precede a key tile skips its products, and the query tiles go
// heaviest first (the last tile attends to every key). The inputs are read
// strided, as they lie in [B, S, H, D] (a view into a fused qkv projection
// included); O is written contiguous [B, S, H, d]. Each output has one
// writer and a fixed order of sums: the same inputs give the same bits.
//
// C interface (bound with ctypes): returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kBQ = 128;       // query rows per block: 8 warps x 16
constexpr int kBK = 64;        // keys per tile
constexpr int kStages = 2;     // the k and v ring
constexpr int kG = 8;          // output tiles of P v in flight
constexpr int kThreads = 256;
constexpr int kTile = 64;      // sq and sk are multiples of this
constexpr float kNegInf = -1e30f;

template <typename T, int D>
struct Smem {
  static constexpr int kLd = row_len<T, D>();
  T q[kBQ * kLd];
  T k[kStages][kBK * kLd];
  T v[kStages][kBK * kLd];
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int heads, sq, sk, d, causal, vec;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd(const Args a) {
  extern __shared__ float4 smem_raw[];
  using S = Smem<T, D>;
  S& sm = *reinterpret_cast<S*>(smem_raw);
  constexpr int kLd = S::kLd;
  constexpr int kN = D / 8;  // 8-column tiles of the output

  const int z = blockIdx.x;                   // b * heads + h
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest tiles first
  const int b = z / a.heads;
  const int h = z % a.heads;
  const int q0 = qt * kBQ;
  const int q_rows = min(kBQ, a.sq - q0);
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;  // the warp's first row
  const int g = lane >> 2;
  const int t = lane & 3;

  const T* kp = static_cast<const T*>(a.k) + b * a.ksb + h * a.ksh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vsb + h * a.vsh;
  // Causal: keys past this tile's last row are masked for every row.
  const int k_end = a.causal ? min(a.sk, q0 + q_rows) : a.sk;
  const int n_kt = (k_end + kBK - 1) / kBK;
  auto stage_kv = [&](int kt) {
    const int k0 = kt * kBK;
    stage_rows<T, D, kThreads>(sm.k[kt % kStages], kp + k0 * a.kss, a.kss,
                               kBK, kBK, a.d, a.vec);
    stage_rows<T, D, kThreads>(sm.v[kt % kStages], vp + k0 * a.vss, a.vss,
                               kBK, kBK, a.d, a.vec);
  };
  stage_rows<T, D, kThreads>(
      sm.q, static_cast<const T*>(a.q) + b * a.qsb + q0 * a.qss + h * a.qsh,
      a.qss, kBQ, q_rows, a.d, a.vec);
  if (n_kt > 0) stage_kv(0);
  cp_async_commit();

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) stage_kv(kt + 1);  // its stage was consumed at kt - 1
    cp_async_commit();
    cp_async_wait<1>();  // everything but the copy just issued has landed
    __syncthreads();
    const int k0 = kt * kBK;
    const T* ks = sm.k[kt % kStages];
    const T* vs = sm.v[kt % kStages];
    if (!a.causal || k0 <= q0 + r0 + 15) {  // some row of the warp sees a key
      // S = q k^T: [16, 64] as 8 tiles of 8 keys.
      float s[kBK / 8][4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < D; kk += 8) {
        FragA qa;
        FragB kb[kBK / 8];
        load_a(qa, sm.q, kLd, r0, kk, lane);
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
          load_b_cols(kb[j], ks, kLd, 8 * j, kk, lane);
        mma3_rows(s, qa, kb);
      }

      // Online softmax on the accumulator fragments: this thread holds rows
      // g (e = 0, 1) and g + 8 (e = 2, 3), keys 8j + 2t + (e & 1); a row's
      // max is shuffled over its four lanes.
      const bool diag = a.causal && k0 + kBK - 1 > q0 + r0;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * a.scale;
          if (diag && q0 + r0 + g + 8 * (e >> 1) < k0 + 8 * j + 2 * t + (e & 1))
            x = kNegInf;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = expf(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[j][e] - m[e >> 1]);
          s[j][e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

      // acc += P v, P from registers, kG output tiles at a time. Each
      // 8-column tile's product over this key tile starts from zero and is
      // added to acc here, rounding to nearest (tf32x3.cuh: the tensor
      // cores truncate).
      FragA pa[kBK / 8];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) a_from_c(pa[j], s[j]);
#pragma unroll
      for (int n0 = 0; n0 < kN; n0 += kG) {
        float part[kG][4];
#pragma unroll
        for (int i = 0; i < kG; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          FragB vb[kG];
#pragma unroll
          for (int i = 0; i < kG; ++i)
            load_b_rows(vb[i], vs, kLd, 8 * j, 8 * (n0 + i), lane);
          mma3_rows(part, pa[j], vb);
        }
#pragma unroll
        for (int i = 0; i < kG; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n0 + i][e] += part[i][e];
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  // Flush: O = acc / l (0 where l == 0), LSE = m + log l. A NaN l (a NaN
  // in the row's scores) gives NaN in both, as the plain version does.
  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = r0 + g + 8 * i;
    if (row >= q_rows) continue;
    const long long base =
        ((static_cast<long long>(b) * a.sq + q0 + row) * a.heads + h) * a.d;
    const float denom = l[i] == 0.f ? 1e-38f : l[i];
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * n + 2 * t + c;
        if (col < a.d) {
          const float val = l[i] == 0.f ? 0.f : acc[n][2 * i + c] / denom;
          o[base + col] = from_f32<T>(val);
        }
      }
    if (t == 0) {
      a.lse[static_cast<long long>(z) * a.sq + q0 + row] = m[i] + logf(denom);
    }
  }
}

template <typename T, int D>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem<T, D>));
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(batch) * a.heads,
                  (a.sq + kBQ - 1) / kBQ);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, int batch, cudaStream_t stream) {
  if (a.d <= 64) return launch<T, 64>(a, batch, stream);
  return launch<T, 128>(a, batch, stream);
}

bool aligned16(const void* p, long long stride_elems, int itemsize) {
  return (reinterpret_cast<uintptr_t>(p) % 16) == 0 &&
         (stride_elems * itemsize) % 16 == 0;
}

}  // namespace

// q, k, v: [B, S, H, d] with unit column stride and the given batch, row
// and head strides (elements); o: contiguous [B, sq, H, d] of q's type;
// lse: contiguous [B*H, sq] float32. dtype: 0 = float32, 1 = bfloat16 (q,
// k, v and o share it). sq and sk are multiples of 64, 1 <= d <= 128.
extern "C" int tpushare_flash_forward(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int heads, int sq, int sk, int d, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, int causal,
    int dtype, float scale, void* stream) {
  if (batch < 0 || heads < 0 || sq < 0 || sk < 0 || d < 1 || d > 128 ||
      sq % kTile || sk % kTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || heads == 0 || sq == 0) return 0;
  const int itemsize = dtype == 0 ? 4 : 2;
  const int vec_elems = 16 / itemsize;
  Args a{q,   k,   v,   o,   static_cast<float*>(lse), heads, sq, sk, d,
         causal, 0, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, scale};
  a.vec = d % vec_elems == 0 && aligned16(q, qss, itemsize) &&
          aligned16(q, qsb, itemsize) && aligned16(q, qsh, itemsize) &&
          aligned16(k, kss, itemsize) && aligned16(k, ksb, itemsize) &&
          aligned16(k, ksh, itemsize) && aligned16(v, vss, itemsize) &&
          aligned16(v, vsb, itemsize) && aligned16(v, vsh, itemsize);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float>(a, batch, s);
    case 1:
      return dispatch<__nv_bfloat16>(a, batch, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
