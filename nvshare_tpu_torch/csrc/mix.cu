// Fused scale-add-bias for Hopper (sm_90a): out = (a*alpha + b*beta) + bias.
//
// Replaces the Pallas TPU kernel nvshare_tpu/ops/mix.py `_mix_kernel`
// (called by `fused_mix`), which streams 256x256 tiles through VMEM.
//
// Bound: bytes. The function reads a and b once and writes out once,
// 3 * n * itemsize bytes against the card's HBM rate, with three flops per
// element. Design: no tiles and no shared memory (elementwise work has no
// reuse); one grid-stride pass over the flattened arrays with 16-byte
// vector loads and stores (float4, or 8 x bf16) so every warp moves whole
// 512-byte lines, and a scalar tail for the remainder. `out` may alias
// `a`: each element is read and written by the same thread.
//
// Arithmetic: every operation is rounded on its own (__fmul_rn and
// __fadd_rn cannot be contracted into an FMA), in the order of the plain
// PyTorch expression `a * alpha + b * beta + bias`. PyTorch runs that
// expression as separate kernels that compute in float and round each
// result to the tensor's type, so bf16 rounds after every operation here
// too, and the kernel equals the plain version bit for bit.
//
// C interface (bound with ctypes): returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mix_f32(float a, float b, float alpha,
                                         float beta, float bias) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, alpha), __fmul_rn(b, beta)), bias);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ __nv_bfloat16 mix_bf16(__nv_bfloat16 a,
                                                  __nv_bfloat16 b,
                                                  float alpha, float beta,
                                                  float bias) {
  const float x = round_bf16(__fmul_rn(__bfloat162float(a), alpha));
  const float y = round_bf16(__fmul_rn(__bfloat162float(b), beta));
  const float s = round_bf16(__fadd_rn(x, y));
  return __float2bfloat16_rn(__fadd_rn(s, bias));
}

template <typename T>
__device__ __forceinline__ T mix_one(T a, T b, float alpha, float beta,
                                     float bias) {
  if constexpr (std::is_same<T, float>::value) {
    return mix_f32(a, b, alpha, beta, bias);
  } else {
    return mix_bf16(a, b, alpha, beta, bias);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mix_kernel(const T* a, const T* b, T* out, int64_t n, float alpha,
               float beta, float bias, int vectorized) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte access
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t nvec = vectorized ? n / kVec : 0;
  const uint4* av = reinterpret_cast<const uint4*>(a);
  const uint4* bv = reinterpret_cast<const uint4*>(b);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (int64_t i = tid; i < nvec; i += stride) {
    const uint4 ra = av[i];
    const uint4 rb = bv[i];
    uint4 ro;
    const T* pa = reinterpret_cast<const T*>(&ra);
    const T* pb = reinterpret_cast<const T*>(&rb);
    T* po = reinterpret_cast<T*>(&ro);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      po[j] = mix_one<T>(pa[j], pb[j], alpha, beta, bias);
    }
    ov[i] = ro;
  }
  for (int64_t i = nvec * kVec + tid; i < n; i += stride) {
    out[i] = mix_one<T>(a[i], b[i], alpha, beta, bias);
  }
}

int sm_count() {
  int dev = 0;
  int sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      sms <= 0) {
    return 132;
  }
  return sms;
}

template <typename T>
int launch(const void* a, const void* b, void* out, int64_t n, float alpha,
           float beta, float bias, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(out);
  const int vectorized = (addr % 16) == 0;
  const int64_t work = vectorized ? (n + kVec - 1) / kVec : n;
  // Enough blocks to keep every SM's load slots busy; the grid-stride
  // loop covers the rest.
  const int64_t cap = static_cast<int64_t>(sm_count()) * 16;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  mix_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(out), n, alpha, beta, bias, vectorized);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a, b and out share it).
extern "C" int tpushare_fused_mix(const void* a, const void* b, void* out,
                                  long long n, int dtype, float alpha,
                                  float beta, float bias, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(a, b, out, n, alpha, beta, bias, s);
    case 1:
      return launch<__nv_bfloat16>(a, b, out, n, alpha, beta, bias, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
