// Tiled matrix product for Hopper (sm_90a): out = A @ B with the operands
// rounded to bf16, products accumulated in f32, the result cast to A's type.
//
// Replaces the Pallas TPU kernel nvshare_tpu/ops/matmul.py `_mm_kernel`
// (called by `tiled_matmul`): a (M/128, N/128, K/128) grid whose K steps run
// in order on one core, carrying a 128x128 f32 accumulator in VMEM scratch,
// zeroed at k == 0 and flushed at the last k.
//
// Bound: operations. 2*M*N*K flops against the card's dense bf16 tensor-core
// rate; at the burner's shapes (side >= 4096) the bytes are two orders of
// magnitude below the machine balance. Design: blocks run in parallel, so
// the sequential K grid becomes a loop inside the block and the accumulator
// lives in registers for the whole loop (nothing is flushed between K
// steps). Each block owns one 128x128 output tile; its 8 warps (2 x 4) each
// own a 64x32 sub-tile held in 4 x 2 `nvcuda::wmma` 16x16x16 bf16
// fragments with f32 accumulators. A and B stream through shared memory in
// 128x32 and 32x128 bf16 tiles, double-buffered: the next tile's global
// loads are in registers while the tensor cores work on the current one.
// f32 operands are rounded to bf16 (round to nearest even, as XLA's convert
// and torch's .to(bfloat16) round) while they are staged, which fuses the
// reference's astype(bfloat16) without a bf16 copy of the operands. Blocks
// are rasterized in groups of 8 tile rows so that concurrently resident
// blocks share B's column panels in L2.
//
// This is the simple form: warpgroup MMA (wgmma), TMA and deeper pipelines
// come later.
//
// C interface (bound with ctypes): returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarpsN = 4;
constexpr int kWM = 64;  // warp tile rows
constexpr int kWN = 32;  // warp tile cols
constexpr int kFM = kWM / 16;
constexpr int kFN = kWN / 16;
constexpr int kGroupM = 8;
// Shared-memory row pitches in bf16 elements: +8 skews consecutive rows
// across banks and keeps every 16x16 fragment origin 32-byte aligned.
constexpr int kALd = kBK + 8;  // 40
constexpr int kBLd = kBN + 8;  // 136

template <typename T>
struct Staging {
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  static constexpr int kALoads = kBM * kBK / kVec / kThreads;
  static constexpr int kBLoads = kBK * kBN / kVec / kThreads;
};

// Round the elements of one 16-byte global load to bf16 and store them.
template <typename T>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* dst, uint4 v) {
  if constexpr (std::is_same<T, float>::value) {
    const float* f = reinterpret_cast<const float*>(&v);
    __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = packed;
  } else {
    *reinterpret_cast<uint4*>(dst) = v;
  }
}

template <typename TO>
__device__ __forceinline__ void store_out(TO* dst, const float* src) {
  if constexpr (std::is_same<TO, float>::value) {
    reinterpret_cast<float4*>(dst)[0] =
        make_float4(src[0], src[1], src[2], src[3]);
    reinterpret_cast<float4*>(dst)[1] =
        make_float4(src[4], src[5], src[6], src[7]);
  } else {
    uint4 packed;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(dst) = packed;
  }
}

template <typename TA, typename TB, typename TO>
__global__ void __launch_bounds__(kThreads)
    mm_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
              TO* __restrict__ out, int m, int n, int k) {
  __shared__ __align__(128) __nv_bfloat16 a_s[2][kBM * kALd];
  __shared__ __align__(128) __nv_bfloat16 b_s[2][kBK * kBLd];
  __shared__ __align__(128) float c_s[kThreads / 32][16 * 16];

  // Grouped rasterization of the 1-D grid onto (tile row, tile col).
  const int grid_m = m / kBM;
  const int grid_n = n / kBN;
  const int pid = blockIdx.x;
  const int per_group = kGroupM * grid_n;
  const int first_m = (pid / per_group) * kGroupM;
  const int group_rows = min(grid_m - first_m, kGroupM);
  const int tile_m = first_m + (pid % per_group) % group_rows;
  const int tile_n = (pid % per_group) / group_rows;
  const int64_t m0 = static_cast<int64_t>(tile_m) * kBM;
  const int64_t n0 = static_cast<int64_t>(tile_n) * kBN;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int warp_m = warp / kWarpsN;
  const int warp_n = warp % kWarpsN;

  using SA = Staging<TA>;
  using SB = Staging<TB>;
  constexpr int kAPerRow = kBK / SA::kVec;  // 16-byte loads per A tile row
  constexpr int kBPerRow = kBN / SB::kVec;  // 16-byte loads per B tile row
  uint4 a_reg[SA::kALoads];
  uint4 b_reg[SB::kBLoads];

  auto load_tiles = [&](int kt) {
    const int64_t k0 = static_cast<int64_t>(kt) * kBK;
#pragma unroll
    for (int i = 0; i < SA::kALoads; ++i) {
      const int q = tid + i * kThreads;
      const int row = q / kAPerRow;
      const int col = (q % kAPerRow) * SA::kVec;
      a_reg[i] = *reinterpret_cast<const uint4*>(
          a + (m0 + row) * k + k0 + col);
    }
#pragma unroll
    for (int i = 0; i < SB::kBLoads; ++i) {
      const int q = tid + i * kThreads;
      const int row = q / kBPerRow;
      const int col = (q % kBPerRow) * SB::kVec;
      b_reg[i] = *reinterpret_cast<const uint4*>(
          b + (k0 + row) * n + n0 + col);
    }
  };
  auto stage_tiles = [&](int buf) {
#pragma unroll
    for (int i = 0; i < SA::kALoads; ++i) {
      const int q = tid + i * kThreads;
      const int row = q / kAPerRow;
      const int col = (q % kAPerRow) * SA::kVec;
      store_bf16<TA>(&a_s[buf][row * kALd + col], a_reg[i]);
    }
#pragma unroll
    for (int i = 0; i < SB::kBLoads; ++i) {
      const int q = tid + i * kThreads;
      const int row = q / kBPerRow;
      const int col = (q % kBPerRow) * SB::kVec;
      store_bf16<TB>(&b_s[buf][row * kBLd + col], b_reg[i]);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i) {
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  }

  const int k_tiles = k / kBK;
  load_tiles(0);
  stage_tiles(0);
  __syncthreads();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < k_tiles) load_tiles(kt + 1);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fa[kFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fb[kFN];
#pragma unroll
      for (int i = 0; i < kFM; ++i) {
        wmma::load_matrix_sync(
            fa[i], &a_s[cur][(warp_m * kWM + i * 16) * kALd + kk], kALd);
      }
#pragma unroll
      for (int j = 0; j < kFN; ++j) {
        wmma::load_matrix_sync(
            fb[j], &b_s[cur][kk * kBLd + warp_n * kWN + j * 16], kBLd);
      }
#pragma unroll
      for (int i = 0; i < kFM; ++i) {
#pragma unroll
        for (int j = 0; j < kFN; ++j) {
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
      }
    }
    // The other buffer was last read in the previous iteration, which the
    // barrier below (one iteration back) has closed.
    if (kt + 1 < k_tiles) stage_tiles(cur ^ 1);
    __syncthreads();
  }

  // Epilogue: each fragment goes through this warp's 16x16 f32 scratch so
  // that every lane writes 8 contiguous outputs in the output's type.
  float* scratch = c_s[warp];
  const int r = lane / 2;
  const int c = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < kFM; ++i) {
#pragma unroll
    for (int j = 0; j < kFN; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int64_t row = m0 + warp_m * kWM + i * 16 + r;
      const int64_t col = n0 + warp_n * kWN + j * 16 + c;
      store_out<TO>(out + row * n + col, scratch + r * 16 + c);
      __syncwarp();
    }
  }
}

template <typename TA, typename TB>
int launch(const void* a, const void* b, void* out, int m, int n, int k,
           cudaStream_t stream) {
  const int64_t blocks = static_cast<int64_t>(m / kBM) * (n / kBN);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  mm_kernel<TA, TB, TA><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(static_cast<const TA*>(a),
                                    static_cast<const TB*>(b),
                                    static_cast<TA*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: m x k, b: k x n, out: m x n, all row-major and 16-byte aligned; m, n
// and k multiples of 128. a_dtype / b_dtype: 0 = float32, 1 = bfloat16;
// out has a's type.
extern "C" int tpushare_tiled_matmul(const void* a, const void* b, void* out,
                                     int m, int n, int k, int a_dtype,
                                     int b_dtype, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || m % kBM || n % kBN || k % 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_dtype == 0 && b_dtype == 0) {
    return launch<float, float>(a, b, out, m, n, k, s);
  }
  if (a_dtype == 0 && b_dtype == 1) {
    return launch<float, __nv_bfloat16>(a, b, out, m, n, k, s);
  }
  if (a_dtype == 1 && b_dtype == 0) {
    return launch<__nv_bfloat16, float>(a, b, out, m, n, k, s);
  }
  if (a_dtype == 1 && b_dtype == 1) {
    return launch<__nv_bfloat16, __nv_bfloat16>(a, b, out, m, n, k, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
