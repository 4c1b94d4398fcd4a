// Flash-attention forward for Hopper (sm_90a): exact softmax(q k^T / sqrt(d)) v
// over [B, S, H, D] tensors, with the per-row log-sum-exp, never forming the
// S x S score matrix in device memory.
//
// Replaces the Pallas TPU kernel nvshare_tpu/ops/attention.py `_flash_kernel`
// (called by `_flash_forward`): online softmax over key tiles; scale =
// 1/sqrt(d); in causal mode the q_pos >= k_pos mask (-1e30 elsewhere) and
// no work for key tiles wholly in the future; O in q's type; LSE in f32 per
// row (m + log l); rows with l == 0 give 0.
//
// Bound: operations. At the language model's scoring shape (B=4, S=2048,
// H=32, D=128, causal) the function does 4*B*H*S*S*D/2 = 1.37e11 flops
// against 0.27 GB of q, k, v, o and lse. Like the Pallas kernel, this
// version upcasts q, k and v to f32 and does all of its math in f32 on the
// CUDA cores (a wgmma design in bf16 is later work), so its own ceiling is
// the card's f32 rate, not the tensor cores'.
//
// Design. One block of 256 threads owns one (batch, head, 64-row query
// tile); a loop over 64-key tiles inside the block takes the place of the
// Pallas grid's sequential key axis, and the running max m, normalizer l
// and f32 accumulator live in registers. The q tile, the current k and v
// tiles (converted to f32 while staged) and the tile of probabilities sit
// in shared memory, rows padded by 4 floats so the 16-byte reads below hit
// distinct banks. The 16 x 16 threads each own 4 query rows: for S = q k^T
// a thread computes 4 x 4 scores (key columns strided by 16) from float4
// reads along d; row max and row sum are shuffles over the 16 threads of a
// row group; for P v a thread accumulates its 4 rows over D/16 output
// columns. The inputs are read strided, as they lie in [B, S, H, D] (a view
// into a fused qkv projection included), so the caller needs no
// transposes; O is written contiguous [B, S, H, d]. Causal query tiles are
// scheduled heaviest first (the last tile attends to every key).
//
// C interface (bound with ctypes): returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // floats of padding per shared row
constexpr float kNegInf = -1e30f;

template <int D>
struct Smem {
  float q[kBQ][D + kPad];
  float k[kBK][D + kPad];
  float v[kBK][D + kPad];
  float p[kBQ][kBK + kPad];
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
    for (int i = threadIdx.x; i < kBQ * kChunks; i += kThreads) {
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
    for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
      const int r = i / D;
      const int c = i % D;
      dst[r][c] = c < d ? to_f32(src[r * row_stride + c]) : 0.f;
    }
  }
}

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
__global__ void __launch_bounds__(kThreads) flash_fwd(const Args a) {
  extern __shared__ float4 smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  constexpr int kCols = D / 16;  // output columns per thread

  const int z = blockIdx.x;                     // b * heads + h
  const int qt = gridDim.y - 1 - blockIdx.y;    // heaviest tiles first
  const int b = z / a.heads;
  const int h = z % a.heads;
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  const T* qp = static_cast<const T*>(a.q) + b * a.qsb + q0 * a.qss +
                h * a.qsh;
  load_tile<T, D>(sm.q, qp, a.qss, a.d, a.vec);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  // Causal: keys past this tile's last row are masked for every row.
  const int k_end = a.causal ? min(a.sk, q0 + kBQ) : a.sk;
  const int n_kt = (k_end + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's k, v and p are consumed
    load_tile<T, D>(sm.k,
                    static_cast<const T*>(a.k) + b * a.ksb + k0 * a.kss +
                        h * a.ksh,
                    a.kss, a.d, a.vec);
    load_tile<T, D>(sm.v,
                    static_cast<const T*>(a.v) + b * a.vsb + k0 * a.vss +
                        h * a.vsh,
                    a.vss, a.d, a.vec);
    __syncthreads();

    // S = q k^T for rows ty*4+i and keys tx+16*j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; dd += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&sm.q[ty * 4 + i][dd]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(&sm.k[tx + 16 * j][dd]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(qa[i].x, kb[j].x, t);
          t = fmaf(qa[i].y, kb[j].y, t);
          t = fmaf(qa[i].z, kb[j].z, t);
          t = fmaf(qa[i].w, kb[j].w, t);
          s[i][j] = t;
        }
    }

    // Online softmax, one row group of 16 threads per row.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * a.scale;
        if (a.causal && qpos < k0 + tx + 16 * j) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sm.p[ty * 4 + i][tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P v over this tile's keys; thread columns g*64 + tx*4 + t.
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&sm.p[ty * 4 + i][kk]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int g = 0; g < D / 64; ++g) {
          const float4 vb =
              *reinterpret_cast<const float4*>(&sm.v[kk + t][g * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = t == 0 ? pa[i].x
                            : t == 1 ? pa[i].y
                            : t == 2 ? pa[i].z
                                     : pa[i].w;
            acc[i][g * 4 + 0] = fmaf(p, vb.x, acc[i][g * 4 + 0]);
            acc[i][g * 4 + 1] = fmaf(p, vb.y, acc[i][g * 4 + 1]);
            acc[i][g * 4 + 2] = fmaf(p, vb.z, acc[i][g * 4 + 2]);
            acc[i][g * 4 + 3] = fmaf(p, vb.w, acc[i][g * 4 + 3]);
          }
        }
      }
    }
  }

  // Flush: O = acc / l (0 where l == 0), LSE = m + log l.
  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const long long base =
        ((static_cast<long long>(b) * a.sq + row) * a.heads + h) * a.d;
    const float denom = fmaxf(l[i], 1e-38f);
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int col = g * 64 + tx * 4 + t;
        if (col < a.d) {
          const float val = l[i] > 0.f ? acc[i][g * 4 + t] / denom : 0.f;
          o[base + col] = from_f32<T>(val);
        }
      }
    if (tx == 0) {
      a.lse[static_cast<long long>(z) * a.sq + row] = m[i] + logf(denom);
    }
  }
}

template <typename T, int D>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem<D>));
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(batch) * a.heads, a.sq / kBQ);
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
      sq % kBQ || sk % kBK) {
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
