// Tiled matrix product (K2) for Hopper (sm_90a) on the tensor cores:
// out = A @ B of row-major bf16 operands, products accumulated in f32, the
// result written in f32 or bf16.
//
// Replaces the Pallas TPU kernel nvshare_tpu/ops/matmul.py `_mm_kernel`
// (called by `tiled_matmul`): a (M/128, N/128, K/128) grid whose K steps run
// in order on one core, carrying a 128x128 f32 accumulator in VMEM scratch,
// zeroed at k == 0 and flushed at the last k. Like that kernel it takes bf16
// operands: the JAX wrapper casts them (`astype(jnp.bfloat16)`) outside the
// Pallas call, and the port's wrapper (ops/matmul.py) casts them before
// this launch.
//
// Bound: operations. 2*M*N*K flops against the card's dense bf16 rate: at
// the burner's 8192^3, 1.1e12 flops take 1.112 ms, against 0.54 GB of bf16
// operands and f32 output (0.16 ms at 3.35 TB/s).
//
// Design. The sequential K grid becomes a loop inside the block, and the
// accumulator lives in registers for the whole loop. One block of three
// warpgroups owns one 128x256 output tile. Warpgroup 0 is the producer: it
// gives its registers away (setmaxnreg) and one thread streams the K steps,
// 64 deep, by TMA into a ring of four shared-memory stages (16 KiB of A and
// 32 KiB of B each), each guarded by a "full" and an "empty" barrier.
// Warpgroups 1 and 2 each own 64 rows of the tile and run, per K step,
// four wgmma m64n256k16 from shared memory: A K-major (one 64-column box of
// 128 rows), B MN-major (four 64-column boxes of 64 k-rows, with the
// transpose flag). A consumer keeps one K step's products in flight and
// releases a stage when the products after it are issued, so the tensor
// cores do not wait on the barrier round trip. Blocks are rasterized in
// groups of 8 tile rows so that co-resident blocks share B's column panels
// in L2. N may be an odd multiple of 128: the last tile column's upper half
// lies past N, its B boxes are not loaded and its columns not written
// (each output column reads only its own B column).
//
// Epilogue: straight from the accumulator layout. A thread holds two
// adjacent columns of each of its two rows, so an f32 output goes out as
// 8-byte stores and each warp's store fills whole 32-byte sectors (8 rows
// x 4 threads x 8 bytes); staging through shared memory for a TMA store
// would add a barrier and 64 KiB of shared memory for no fewer bytes.
//
// C interface (bound with ctypes): returns 0 or the cudaError_t of the
// launch, or sm90::kErrNoEncoder / kErrEncode + a CUresult (sm90.cuh).

#include <type_traits>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBM = 128;       // tile rows, 64 per consumer
constexpr int kBN = 256;       // tile columns
constexpr int kBK = 64;        // K step
constexpr int kStages = 4;
constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr int kGroupM = 8;
constexpr int kABytes = kBM * kBK * 2;   // one 64-column box of 128 rows
constexpr int kBBox = kBK * 64 * 2;      // one 64-column box of 64 k-rows
constexpr int kBBytes = kBN / 64 * kBBox;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kBar = kStages * kStageBytes;
// full, then empty, per stage.
constexpr int kSmem = kBar + 8 * 2 * kStages + 1024;

template <typename TO>
__device__ __forceinline__ void store2(TO* dst, float x, float y) {
  if constexpr (std::is_same<TO, float>::value) {
    *reinterpret_cast<float2*>(dst) = make_float2(x, y);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
  }
}

template <typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    mm_sm90(const __grid_constant__ CUtensorMap ma,
            const __grid_constant__ CUtensorMap mb, TO* __restrict__ out,
            int m, int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  auto full = [&](int s) { return base + kBar + 8 * s; };
  auto empty = [&](int s) { return base + kBar + 8 * (kStages + s); };
  auto a_tile = [&](int s) { return base + s * kStageBytes; };
  auto b_tile = [&](int s) { return base + s * kStageBytes + kABytes; };

  // Grouped rasterization of the 1-D grid onto (tile row, tile column).
  const int grid_m = m / kBM;
  const int grid_n = (n + kBN - 1) / kBN;
  const int pid = blockIdx.x;
  const int per_group = kGroupM * grid_n;
  const int first_m = (pid / per_group) * kGroupM;
  const int group_rows = min(grid_m - first_m, kGroupM);
  const int m0 = (first_m + (pid % per_group) % group_rows) * kBM;
  const int n0 = ((pid % per_group) / group_rows) * kBN;
  const int boxes = min(kBN, n - n0) / 64;  // B boxes inside N
  const int k_steps = k / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
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
      for (int it = 0; it < k_steps; ++it) {
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), kABytes + boxes * kBBox);
        tma_load_2d(a_tile(s), &ma, full(s), it * kBK, m0);
        for (int c = 0; c < boxes; ++c)
          tma_load_2d(b_tile(s) + c * kBBox, &mb, full(s), n0 + 64 * c,
                      it * kBK);
      }
    }
  } else {
    reg_alloc<232>();
    const int cw = wg - 1;            // rows 64 cw .. 64 cw + 63 of the tile
    const int t = threadIdx.x % 128;
    const int lane = t % 32;

    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;

    for (int it = 0; it < k_steps; ++it) {
      const int s = it % kStages;
      mbar_wait(full(s), (it / kStages) & 1);
      const uint32_t a0 = a_tile(s) + cw * 64 * 128;
      const uint32_t b0 = b_tile(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        Mma<kBN>::ss_t(acc, desc_sw128(a0 + kk * 32, 16, 1024),
                       desc_sw128(b0 + kk * 2048, kBBox, 1024), 1);
      wgmma_commit();
      // The previous step's products are done: release its stage.
      wgmma_wait<1>();
      if (it > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty((it - 1) % kStages));
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // Thread t holds rows 16 (t / 32) + lane / 4 and that + 8, columns
    // 8j + 2 (lane % 4) and the next (the accumulator layout).
    const int row = m0 + 64 * cw + 16 * (t / 32) + lane / 4;
    TO* o0 = out + static_cast<long long>(row) * n + n0 + 2 * (lane % 4);
    TO* o1 = o0 + 8ll * n;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      if (n0 + 8 * j < n) {
        store2(o0 + 8 * j, acc[4 * j], acc[4 * j + 1]);
        store2(o1 + 8 * j, acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

template <typename TO>
int launch(const void* a, const void* b, void* out, int m, int n, int k,
           cudaStream_t stream) {
  CUtensorMap ma, mb;
  int rc = encode_2d(&ma, a, m, k, kBM);
  if (rc == 0) rc = encode_2d(&mb, b, k, n, kBK);
  if (rc != 0) return rc;
  const long long blocks =
      static_cast<long long>(m / kBM) * ((n + kBN - 1) / kBN);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      mm_sm90<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  mm_sm90<TO><<<static_cast<unsigned>(blocks), kThreads, kSmem, stream>>>(
      ma, mb, static_cast<TO*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// a: bf16 m x k, b: bf16 k x n, out: m x n, all contiguous row-major and
// 16-byte aligned; m, n and k multiples of 128. out_dtype: 0 = float32,
// 1 = bfloat16.
extern "C" int tpushare_tiled_matmul_sm90(const void* a, const void* b,
                                          void* out, int m, int n, int k,
                                          int out_dtype, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || m % kBM || n % 128 || k % 128 ||
      !aligned16(a) || !aligned16(b) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) return launch<float>(a, b, out, m, n, k, s);
  if (out_dtype == 1) return launch<__nv_bfloat16>(a, b, out, m, n, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
