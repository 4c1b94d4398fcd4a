// Flash-attention backward for Hopper (sm_90a): dQ (K4) and dK/dV (K5) of
// exact attention over [B, S, H, D] tensors, recomputing each tile of
// probabilities from the forward's saved log-sum-exp, so the S x S score
// matrix never reaches device memory in training either.
//
// Replaces the Pallas TPU kernels nvshare_tpu/ops/attention.py
// `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel` (both called by
// `_flash_backward`). Per tile pair: s = q k^T * scale (masked where q_pos <
// k_pos in causal mode), p = exp(s - lse), dP = dO v^T, dS = p * (dP - delta
// + g_lse) * scale; then dQ += dS k (K4), dV += p^T dO and dK += dS^T q (K5).
// delta = rowsum(dO * O) and g_lse (the LSE output's cotangent, or none)
// come in per row, in f32, as in the Pallas kernels. dQ, dK and dV are
// written contiguous [B, S, H, d] in their inputs' types.
//
// Bound: operations. At the training shape (B=4, S=2048, H=32, D=128,
// causal) K4 does 3 products of 2*B*H*S*S*D/2 flops (2.06e11) and K5 four
// (2.75e11), against 0.4 GB of q, k, v, dO, lse and delta and 0.07-0.13 GB
// of outputs. Like the Pallas kernels and K3's f32 route (attention.cu),
// these upcast to f32 and do all math in f32 on the CUDA cores, so their
// own ceiling is the card's f32 rate. They are the f32 route, and that of
// bf16 at head widths other than 64 and 128: bf16 at 64 or 128 takes the
// wgmma K4 and K5 in attention_bwd_sm90.cu.
//
// Design. Two kernels, each output tile with exactly one writer and no
// atomics, so the gradients are the same bits on every run (co-located
// training must equal solo training bit for bit). A Pallas grid axis that
// runs in order becomes a loop inside the block:
//   K4: one block of 256 threads per (batch*head, 64-row query tile),
//       looping over the live 64-key tiles; the q and dO tiles stay in
//       shared memory, the dQ accumulator in registers.
//   K5: one block per (batch*head, 64-key tile), looping over the live
//       query tiles (from the diagonal on, in causal mode); the k and v
//       tiles stay in shared memory, the dK and dV accumulators in
//       registers, and p^T and dS^T of the current pair of tiles are staged
//       in shared memory for the two products.
// The 16 x 16 threads each own 4 rows of the block's tile: a thread
// computes 4 x 4 entries of s and dP (columns strided by 16) from float4
// reads along d, then accumulates its 4 rows over D/16 output columns, as
// in K3. Shared rows are padded by 4 floats so the 16-byte reads hit
// distinct banks. The heaviest tiles go first: the last query tiles for K4
// and the first key tiles for K5 in causal mode.
//
// C interface (bound with ctypes): each entry point returns the
// cudaError_t of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kB = 64;         // rows per tile, queries and keys alike
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // floats of padding per shared row

template <int D>
struct DqSmem {
  float q[kB][D + kPad];
  float dout[kB][D + kPad];
  float k[kB][D + kPad];
  float v[kB][D + kPad];
  float ds[kB][kB + kPad];
};

template <int D>
struct DkvSmem {
  float k[kB][D + kPad];
  float v[kB][D + kPad];
  float q[kB][D + kPad];
  float dout[kB][D + kPad];
  float pt[kB][kB + kPad];   // p^T of the current tile pair: [key][query]
  float dst[kB][kB + kPad];  // dS^T
  float lse[kB];
  float dlt[kB];             // delta - g_lse
};

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv(const Args a) {
  extern __shared__ float4 smem_raw[];
  DkvSmem<D>& sm = *reinterpret_cast<DkvSmem<D>*>(smem_raw);

  const int z = blockIdx.x;   // b * heads + h
  const int kt = blockIdx.y;  // causal: the first key tiles are heaviest
  const int b = z / a.heads;
  const int h = z % a.heads;
  const int k0 = kt * kB;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int r0 = ty * 4;

  load_tile<T, D>(sm.k,
                  static_cast<const T*>(a.k) + b * a.ksb + k0 * a.kss +
                      h * a.ksh,
                  a.kss, a.d, a.vec);
  load_tile<T, D>(sm.v,
                  static_cast<const T*>(a.v) + b * a.vsb + k0 * a.vss +
                      h * a.vsh,
                  a.vss, a.d, a.vec);
  float dk[4][D / 16], dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      dk[i][c] = 0.f;
      dv[i][c] = 0.f;
    }

  // Causal: query tiles wholly before this key tile see none of its keys;
  // the loop starts at the diagonal (and is empty past the last query).
  const int n_qt = a.sq / kB;
  const int qt0 = a.causal ? k0 / kB : 0;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kB;
    __syncthreads();  // the previous tile's q, dO, p^T and dS^T are consumed
    load_tile<T, D>(sm.q,
                    static_cast<const T*>(a.q) + b * a.qsb + q0 * a.qss +
                        h * a.qsh,
                    a.qss, a.d, a.vec);
    load_tile<T, D>(sm.dout,
                    static_cast<const T*>(a.dout) + b * a.osb + q0 * a.oss +
                        h * a.osh,
                    a.oss, a.d, a.vec);
    if (threadIdx.x < kB) {
      const long long row =
          static_cast<long long>(z) * a.sq + q0 + threadIdx.x;
      sm.lse[threadIdx.x] = a.lse[row];
      sm.dlt[threadIdx.x] = a.delta[row] - (a.glse ? a.glse[row] : 0.f);
    }
    __syncthreads();

    // Transposed tiles: rows are this block's keys, columns the queries.
    float st[4][4], dpt[4][4];
    tile_dots<D>(st, sm.k, sm.q, r0, tx);
    tile_dots<D>(dpt, sm.v, sm.dout, r0, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const bool masked = a.causal && q0 + col < k0 + r0 + i;
        const float p =
            masked ? 0.f : expf(st[i][j] * a.scale - sm.lse[col]);
        sm.pt[r0 + i][col] = p;
        sm.dst[r0 + i][col] = p * (dpt[i][j] - sm.dlt[col]) * a.scale;
      }
    __syncthreads();
    tile_accumulate<D>(dv, sm.pt, sm.dout, r0, tx);  // dV += p^T dO
    tile_accumulate<D>(dk, sm.dst, sm.q, r0, tx);    // dK += dS^T q
  }
  store_rows<T, D>(static_cast<T*>(a.out0), dk, b, h, a.heads, a.sk, a.d,
                   k0 + r0, tx);
  store_rows<T, D>(static_cast<T*>(a.out1), dv, b, h, a.heads, a.sk, a.d,
                   k0 + r0, tx);
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
    if (a.d <= 64)
      return launch<DkvSmem<64>>(flash_bwd_dkv<T, 64>, a, batch, a.sk / kB,
                                 stream);
    return launch<DkvSmem<128>>(flash_bwd_dkv<T, 128>, a, batch, a.sk / kB,
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
