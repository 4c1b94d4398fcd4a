// libcuda.so.1 (mock) — a small fake CUDA driver for the interposer's tests.
//
// The port's counterpart of src/mock_pjrt.cpp: enough of the driver API
// for libtpushare_cuda.so and tpushare-cuda-hook-test to initialise, make
// a context, allocate, copy, launch and fence, with no hardware. It
//
//   * reports 16 GiB of device memory through cuMemGetInfo_v2 and serves
//     allocations from a fake address space (backed by host memory up to
//     64 MiB an allocation, so copies move real bytes);
//   * gives every stream a completion clock: each launch adds
//     $TPUSHARE_MOCK_EXEC_MS to its stream's clock, -1 wedges the device
//     (nothing ever completes), $TPUSHARE_MOCK_WEDGE_NTH wedges only the
//     nth launch (0-based) and, the stream being in order, what follows it
//     on that stream. An event records its stream's clock; cuEventQuery
//     answers CUDA_ERROR_NOT_READY until then. Recording on the legacy
//     stream waits for every stream, as the legacy stream does;
//   * requires a current context for contexts' work (events, launches,
//     allocation), and says so on stderr when a call comes without one;
//   * answers cuGetProcAddress(_v2) by base name, version and the
//     per-thread-default-stream flag, from its own table (as the real
//     driver does: `cuMemcpyHtoD` at 3020 or later is cuMemcpyHtoD_v2,
//     with the flag cuMemcpyHtoD_v2_ptds), and exports every entry point
//     under its own name too;
//   * counts launches (mock_libcuda_counters) and gives a symbol's own
//     address (mock_libcuda_self), so that a test can tell a wrapper from
//     the driver's entry point.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "cuda_defs.h"

namespace {

constexpr int64_t kNever = std::numeric_limits<int64_t>::max();
constexpr size_t kCapacity = 16ull << 30;
constexpr size_t kBackedMax = 64ull << 20;

int64_t now_ms() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

int64_t env_ll(const char* name, int64_t fallback) {
  const char* v = std::getenv(name);
  return v != nullptr && v[0] != '\0' ? std::atoll(v) : fallback;
}

struct MockStream {
  std::atomic<int64_t> done_at{0};  // when its last work completes
  bool capturing = false;
};

struct MockEvent {
  int64_t done_at = 0;
};

struct Alloc {
  size_t size = 0;
  std::vector<char> data;  // empty above kBackedMax: flow only
};

std::atomic<bool> g_initialized{false};
int g_ctx_obj;  // the one (primary) context
thread_local CUcontext t_ctx = nullptr;
thread_local CUstreamCaptureMode t_capture_mode =
    CU_STREAM_CAPTURE_MODE_GLOBAL;

std::mutex g_mu;
MockStream g_legacy;
thread_local MockStream t_per_thread;
std::unordered_set<MockStream*> g_streams;
std::map<CUdeviceptr, Alloc> g_allocs;
CUdeviceptr g_next = 0x100000000ull;
size_t g_used = 0;

std::atomic<uint64_t> g_launches{0}, g_ptsz_launches{0};
std::atomic<uint64_t> g_captured{0}, g_graph_launches{0};

bool has_ctx(const char* fn) {
  if (t_ctx != nullptr) return true;
  std::fprintf(stderr, "mock_libcuda: %s without a current context\n", fn);
  return false;
}

MockStream* stream_of(CUstream s, bool ptsz) {
  if (s == CU_STREAM_PER_THREAD || (ptsz && s == nullptr))
    return &t_per_thread;
  if (s == nullptr || s == CU_STREAM_LEGACY) return &g_legacy;
  return reinterpret_cast<MockStream*>(s);
}

// One launch's work on its stream: the stream's clock moves on by the
// configured time, or stops for good on a wedged launch.
CUresult launch(const char* fn, CUstream s, bool ptsz) {
  if (!has_ctx(fn)) return CUDA_ERROR_INVALID_CONTEXT;
  MockStream* st = stream_of(s, ptsz);
  if (st->capturing) {
    g_captured++;
    return CUDA_SUCCESS;
  }
  static const int64_t exec_ms = env_ll("TPUSHARE_MOCK_EXEC_MS", 0);
  static const int64_t wedge_nth = env_ll("TPUSHARE_MOCK_WEDGE_NTH", -1);
  const int64_t idx = static_cast<int64_t>(g_launches++);
  if (ptsz || s == CU_STREAM_PER_THREAD) g_ptsz_launches++;
  const int64_t prev = st->done_at.load();
  if (prev == kNever) return CUDA_SUCCESS;
  if (exec_ms < 0 || idx == wedge_nth)
    st->done_at = kNever;
  else
    st->done_at = std::max(now_ms(), prev) + exec_ms;
  return CUDA_SUCCESS;
}

int64_t record_clock(CUstream s, bool ptsz) {
  MockStream* st = stream_of(s, ptsz);
  int64_t at = st->done_at.load();
  if (st == &g_legacy) {
    std::lock_guard<std::mutex> lk(g_mu);
    for (MockStream* other : g_streams) at = std::max(at, other->done_at.load());
  }
  return at;
}

// Where a unified address lies: a device allocation and its offset, or
// host memory (nullptr).
Alloc* find_alloc(CUdeviceptr p, size_t n, size_t* off) {
  auto it = g_allocs.upper_bound(p);
  if (it == g_allocs.begin()) return nullptr;
  --it;
  if (p < it->first || p + n > it->first + it->second.size) return nullptr;
  *off = static_cast<size_t>(p - it->first);
  return &it->second;
}

uintptr_t addr(CUdeviceptr p) { return static_cast<uintptr_t>(p); }
uintptr_t addr(const void* p) { return reinterpret_cast<uintptr_t>(p); }

// Copies move real bytes where both sides are backed.
CUresult copy(uintptr_t dst, uintptr_t src, size_t n) {
  std::lock_guard<std::mutex> lk(g_mu);
  size_t doff = 0, soff = 0;
  Alloc* d = find_alloc(dst, n, &doff);
  Alloc* s = find_alloc(src, n, &soff);
  char* dp = d != nullptr ? (d->data.empty() ? nullptr : d->data.data() + doff)
                          : reinterpret_cast<char*>(dst);
  const char* sp = s != nullptr
                       ? (s->data.empty() ? nullptr : s->data.data() + soff)
                       : reinterpret_cast<const char*>(src);
  if (dp != nullptr && sp != nullptr && n > 0) std::memmove(dp, sp, n);
  return CUDA_SUCCESS;
}

template <typename T>
CUresult fill(CUdeviceptr dst, T v, size_t count) {
  std::lock_guard<std::mutex> lk(g_mu);
  size_t off = 0;
  Alloc* a = find_alloc(dst, count * sizeof(T), &off);
  if (a == nullptr) return CUDA_ERROR_INVALID_VALUE;
  if (!a->data.empty()) {
    T* p = reinterpret_cast<T*>(a->data.data() + off);
    std::fill(p, p + count, v);
  }
  return CUDA_SUCCESS;
}

CUresult allocate(CUdeviceptr* dptr, size_t bytes) {
  if (!has_ctx("cuMemAlloc")) return CUDA_ERROR_INVALID_CONTEXT;
  if (dptr == nullptr || bytes == 0) return CUDA_ERROR_INVALID_VALUE;
  std::lock_guard<std::mutex> lk(g_mu);
  if (g_used + bytes > kCapacity) return CUDA_ERROR_OUT_OF_MEMORY;
  Alloc a;
  a.size = bytes;
  if (bytes <= kBackedMax) a.data.assign(bytes, 0);
  *dptr = g_next;
  g_next += (bytes + 511) / 512 * 512;
  g_used += bytes;
  g_allocs.emplace(*dptr, std::move(a));
  return CUDA_SUCCESS;
}

}  // namespace

extern "C" {

CUresult cuInit(unsigned int) {
  g_initialized = true;
  return CUDA_SUCCESS;
}

CUresult cuDriverGetVersion(int* v) {
  *v = 12040;
  return CUDA_SUCCESS;
}

CUresult cuDeviceGetCount(int* n) {
  *n = 1;
  return g_initialized ? CUDA_SUCCESS : CUDA_ERROR_NOT_INITIALIZED;
}

CUresult cuDeviceGet(CUdevice* dev, int ordinal) {
  if (!g_initialized) return CUDA_ERROR_NOT_INITIALIZED;
  if (ordinal != 0) return CUDA_ERROR_INVALID_VALUE;
  *dev = 0;
  return CUDA_SUCCESS;
}

CUresult cuDevicePrimaryCtxRetain(CUcontext* ctx, CUdevice) {
  if (!g_initialized) return CUDA_ERROR_NOT_INITIALIZED;
  *ctx = reinterpret_cast<CUcontext>(&g_ctx_obj);
  return CUDA_SUCCESS;
}

CUresult cuCtxSetCurrent(CUcontext ctx) {
  t_ctx = ctx;
  return CUDA_SUCCESS;
}

CUresult cuCtxGetCurrent(CUcontext* ctx) {
  *ctx = t_ctx;
  return CUDA_SUCCESS;
}

CUresult cuCtxSynchronize() {
  if (!has_ctx("cuCtxSynchronize")) return CUDA_ERROR_INVALID_CONTEXT;
  return CUDA_SUCCESS;
}

CUresult cuGetErrorString(CUresult, const char** s) {
  *s = "mock error";
  return CUDA_SUCCESS;
}

// -- streams, capture, events -------------------------------------------

CUresult cuStreamCreate(CUstream* s, unsigned int) {
  if (!has_ctx("cuStreamCreate")) return CUDA_ERROR_INVALID_CONTEXT;
  auto* st = new MockStream();
  std::lock_guard<std::mutex> lk(g_mu);
  g_streams.insert(st);
  *s = reinterpret_cast<CUstream>(st);
  return CUDA_SUCCESS;
}

CUresult cuStreamDestroy_v2(CUstream s) {
  auto* st = reinterpret_cast<MockStream*>(s);
  std::lock_guard<std::mutex> lk(g_mu);
  if (g_streams.erase(st) == 0) return CUDA_ERROR_INVALID_HANDLE;
  delete st;
  return CUDA_SUCCESS;
}

CUresult cuStreamDestroy(CUstream s) { return cuStreamDestroy_v2(s); }

CUresult cuStreamIsCapturing(CUstream s, CUstreamCaptureStatus* st) {
  *st = stream_of(s, false)->capturing ? CU_STREAM_CAPTURE_STATUS_ACTIVE
                                       : CU_STREAM_CAPTURE_STATUS_NONE;
  return CUDA_SUCCESS;
}

CUresult cuStreamIsCapturing_ptsz(CUstream s, CUstreamCaptureStatus* st) {
  *st = stream_of(s, true)->capturing ? CU_STREAM_CAPTURE_STATUS_ACTIVE
                                      : CU_STREAM_CAPTURE_STATUS_NONE;
  return CUDA_SUCCESS;
}

CUresult cuStreamBeginCapture_v2(CUstream s, CUstreamCaptureMode) {
  if (s == nullptr || s == CU_STREAM_LEGACY) return CUDA_ERROR_NOT_SUPPORTED;
  stream_of(s, false)->capturing = true;
  return CUDA_SUCCESS;
}

CUresult cuStreamEndCapture(CUstream s, void** graph) {
  stream_of(s, false)->capturing = false;
  static int fake_graph;
  *graph = &fake_graph;
  return CUDA_SUCCESS;
}

CUresult cuThreadExchangeStreamCaptureMode(CUstreamCaptureMode* mode) {
  std::swap(*mode, t_capture_mode);
  return CUDA_SUCCESS;
}

CUresult cuEventCreate(CUevent* ev, unsigned int) {
  if (!has_ctx("cuEventCreate")) return CUDA_ERROR_INVALID_CONTEXT;
  *ev = reinterpret_cast<CUevent>(new MockEvent());
  return CUDA_SUCCESS;
}

CUresult cuEventRecord(CUevent ev, CUstream s) {
  if (!has_ctx("cuEventRecord")) return CUDA_ERROR_INVALID_CONTEXT;
  reinterpret_cast<MockEvent*>(ev)->done_at = record_clock(s, false);
  return CUDA_SUCCESS;
}

CUresult cuEventRecord_ptsz(CUevent ev, CUstream s) {
  if (!has_ctx("cuEventRecord_ptsz")) return CUDA_ERROR_INVALID_CONTEXT;
  reinterpret_cast<MockEvent*>(ev)->done_at = record_clock(s, true);
  return CUDA_SUCCESS;
}

CUresult cuEventQuery(CUevent ev) {
  if (!has_ctx("cuEventQuery")) return CUDA_ERROR_INVALID_CONTEXT;
  const int64_t at = reinterpret_cast<MockEvent*>(ev)->done_at;
  return at != kNever && now_ms() >= at ? CUDA_SUCCESS : CUDA_ERROR_NOT_READY;
}

CUresult cuEventSynchronize(CUevent ev) {
  const int64_t at = reinterpret_cast<MockEvent*>(ev)->done_at;
  // A wedged event sleeps a bounded time, so that a caller that should
  // not have waited shows as slow rather than hanging the test.
  int64_t wait = at == kNever ? 600000 : at - now_ms();
  if (wait > 0) std::this_thread::sleep_for(std::chrono::milliseconds(wait));
  return CUDA_SUCCESS;
}

CUresult cuEventDestroy_v2(CUevent ev) {
  delete reinterpret_cast<MockEvent*>(ev);
  return CUDA_SUCCESS;
}

// -- launches -----------------------------------------------------------

#define MOCK_LAUNCH_PARAMS                                               \
  CUfunction, unsigned int, unsigned int, unsigned int, unsigned int,    \
      unsigned int, unsigned int, unsigned int, CUstream s, void**, void**
#define MOCK_COOP_PARAMS                                                 \
  CUfunction, unsigned int, unsigned int, unsigned int, unsigned int,    \
      unsigned int, unsigned int, unsigned int, CUstream s, void**

CUresult cuLaunchKernel(MOCK_LAUNCH_PARAMS) {
  return launch("cuLaunchKernel", s, false);
}
CUresult cuLaunchKernel_ptsz(MOCK_LAUNCH_PARAMS) {
  return launch("cuLaunchKernel_ptsz", s, true);
}
CUresult cuLaunchKernelEx(const CUlaunchConfig* c, CUfunction, void**,
                          void**) {
  return launch("cuLaunchKernelEx", c->hStream, false);
}
CUresult cuLaunchKernelEx_ptsz(const CUlaunchConfig* c, CUfunction, void**,
                               void**) {
  return launch("cuLaunchKernelEx_ptsz", c->hStream, true);
}
CUresult cuLaunchCooperativeKernel(MOCK_COOP_PARAMS) {
  return launch("cuLaunchCooperativeKernel", s, false);
}
CUresult cuLaunchCooperativeKernel_ptsz(MOCK_COOP_PARAMS) {
  return launch("cuLaunchCooperativeKernel_ptsz", s, true);
}
CUresult cuGraphLaunch(CUgraphExec, CUstream s) {
  g_graph_launches++;
  return launch("cuGraphLaunch", s, false);
}
CUresult cuGraphLaunch_ptsz(CUgraphExec, CUstream s) {
  g_graph_launches++;
  return launch("cuGraphLaunch_ptsz", s, true);
}

// -- memory -------------------------------------------------------------

CUresult cuMemGetInfo_v2(size_t* free_bytes, size_t* total_bytes) {
  std::lock_guard<std::mutex> lk(g_mu);
  *free_bytes = kCapacity - g_used;
  *total_bytes = kCapacity;
  return CUDA_SUCCESS;
}

CUresult cuMemAlloc_v2(CUdeviceptr* dptr, size_t bytes) {
  return allocate(dptr, bytes);
}

CUresult cuMemAllocPitch_v2(CUdeviceptr* dptr, size_t* pitch, size_t width,
                            size_t height, unsigned int) {
  *pitch = (width + 511) / 512 * 512;
  return allocate(dptr, *pitch * height);
}

CUresult cuMemFree_v2(CUdeviceptr dptr) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_allocs.find(dptr);
  if (it == g_allocs.end()) return CUDA_ERROR_INVALID_VALUE;
  g_used -= it->second.size;
  g_allocs.erase(it);
  return CUDA_SUCCESS;
}

CUresult cuMemAllocAsync(CUdeviceptr* dptr, size_t bytes, CUstream) {
  return allocate(dptr, bytes);
}
CUresult cuMemAllocAsync_ptsz(CUdeviceptr* dptr, size_t bytes, CUstream) {
  return allocate(dptr, bytes);
}
CUresult cuMemAllocFromPoolAsync(CUdeviceptr* dptr, size_t bytes,
                                 CUmemoryPool, CUstream) {
  return allocate(dptr, bytes);
}
CUresult cuMemAllocFromPoolAsync_ptsz(CUdeviceptr* dptr, size_t bytes,
                                      CUmemoryPool, CUstream) {
  return allocate(dptr, bytes);
}
CUresult cuMemAllocManaged(CUdeviceptr* dptr, size_t bytes, unsigned int) {
  return allocate(dptr, bytes);
}
CUresult cuMemCreate(CUmemGenericAllocationHandle* h, size_t bytes,
                     const CUmemAllocationProp*, unsigned long long) {
  CUdeviceptr p = 0;
  CUresult r = allocate(&p, bytes);
  *h = p;
  return r;
}

// Pinned host memory lives on the host: the mock never charges it.
CUresult cuMemAllocHost_v2(void** pp, size_t bytes) {
  *pp = std::malloc(bytes);
  return *pp != nullptr ? CUDA_SUCCESS : CUDA_ERROR_OUT_OF_MEMORY;
}
CUresult cuMemHostAlloc(void** pp, size_t bytes, unsigned int) {
  return cuMemAllocHost_v2(pp, bytes);
}
CUresult cuMemFreeHost(void* p) {
  std::free(p);
  return CUDA_SUCCESS;
}

#define MOCK_COPY(name, dst_t, src_t)                                        \
  CUresult name(dst_t dst, src_t src, size_t n) {                            \
    return copy(addr(dst), addr(src), n);                                    \
  }                                                                          \
  CUresult name##_ptds(dst_t dst, src_t src, size_t n) {                     \
    return name(dst, src, n);                                                \
  }
#define MOCK_COPY_ASYNC(name, dst_t, src_t)                                  \
  CUresult name(dst_t dst, src_t src, size_t n, CUstream) {                  \
    return copy(addr(dst), addr(src), n);                                    \
  }                                                                          \
  CUresult name##_ptsz(dst_t dst, src_t src, size_t n, CUstream s) {         \
    return name(dst, src, n, s);                                             \
  }
MOCK_COPY(cuMemcpy, CUdeviceptr, CUdeviceptr)
MOCK_COPY(cuMemcpyHtoD_v2, CUdeviceptr, const void*)
MOCK_COPY(cuMemcpyDtoH_v2, void*, CUdeviceptr)
MOCK_COPY(cuMemcpyDtoD_v2, CUdeviceptr, CUdeviceptr)
MOCK_COPY_ASYNC(cuMemcpyAsync, CUdeviceptr, CUdeviceptr)
MOCK_COPY_ASYNC(cuMemcpyHtoDAsync_v2, CUdeviceptr, const void*)
MOCK_COPY_ASYNC(cuMemcpyDtoHAsync_v2, void*, CUdeviceptr)
MOCK_COPY_ASYNC(cuMemcpyDtoDAsync_v2, CUdeviceptr, CUdeviceptr)

#define MOCK_MEMSET(bits, type)                                              \
  CUresult cuMemsetD##bits##_v2(CUdeviceptr d, type v, size_t n) {           \
    return fill<type>(d, v, n);                                              \
  }                                                                          \
  CUresult cuMemsetD##bits##_v2_ptds(CUdeviceptr d, type v, size_t n) {      \
    return fill<type>(d, v, n);                                              \
  }                                                                          \
  CUresult cuMemsetD##bits##Async(CUdeviceptr d, type v, size_t n,           \
                                  CUstream) {                                \
    return fill<type>(d, v, n);                                              \
  }                                                                          \
  CUresult cuMemsetD##bits##Async_ptsz(CUdeviceptr d, type v, size_t n,      \
                                       CUstream) {                           \
    return fill<type>(d, v, n);                                              \
  }
MOCK_MEMSET(8, unsigned char)
MOCK_MEMSET(16, unsigned short)
MOCK_MEMSET(32, unsigned int)

CUresult cuGetProcAddress_v2(const char* symbol, void** pfn, int version,
                             cuuint64_t flags,
                             CUdriverProcAddressQueryResult* status);

CUresult cuGetProcAddress(const char* symbol, void** pfn, int version,
                          cuuint64_t flags) {
  return cuGetProcAddress_v2(symbol, pfn, version, flags, nullptr);
}

}  // extern "C"

namespace {

// Every exported entry point, for cuGetProcAddress and mock_libcuda_self.
#define MOCK_SYMBOLS(X)                                                     \
  X(cuInit) X(cuDriverGetVersion) X(cuDeviceGetCount) X(cuDeviceGet)        \
  X(cuDevicePrimaryCtxRetain) X(cuCtxSetCurrent) X(cuCtxGetCurrent)         \
  X(cuCtxSynchronize) X(cuGetErrorString) X(cuGetProcAddress)               \
  X(cuGetProcAddress_v2) X(cuStreamCreate) X(cuStreamDestroy)               \
  X(cuStreamDestroy_v2) X(cuStreamIsCapturing) X(cuStreamIsCapturing_ptsz)  \
  X(cuStreamBeginCapture_v2) X(cuStreamEndCapture)                          \
  X(cuThreadExchangeStreamCaptureMode) X(cuEventCreate) X(cuEventRecord)    \
  X(cuEventRecord_ptsz) X(cuEventQuery) X(cuEventSynchronize)               \
  X(cuEventDestroy_v2) X(cuLaunchKernel) X(cuLaunchKernel_ptsz)             \
  X(cuLaunchKernelEx) X(cuLaunchKernelEx_ptsz)                              \
  X(cuLaunchCooperativeKernel) X(cuLaunchCooperativeKernel_ptsz)            \
  X(cuGraphLaunch) X(cuGraphLaunch_ptsz) X(cuMemGetInfo_v2)                 \
  X(cuMemAlloc_v2) X(cuMemAllocPitch_v2) X(cuMemFree_v2)                    \
  X(cuMemAllocAsync) X(cuMemAllocAsync_ptsz) X(cuMemAllocFromPoolAsync)     \
  X(cuMemAllocFromPoolAsync_ptsz) X(cuMemAllocManaged) X(cuMemCreate)       \
  X(cuMemAllocHost_v2) X(cuMemHostAlloc) X(cuMemFreeHost)                   \
  X(cuMemcpy) X(cuMemcpy_ptds) X(cuMemcpyHtoD_v2) X(cuMemcpyHtoD_v2_ptds)   \
  X(cuMemcpyDtoH_v2) X(cuMemcpyDtoH_v2_ptds) X(cuMemcpyDtoD_v2)             \
  X(cuMemcpyDtoD_v2_ptds) X(cuMemcpyAsync) X(cuMemcpyAsync_ptsz)            \
  X(cuMemcpyHtoDAsync_v2) X(cuMemcpyHtoDAsync_v2_ptsz)                      \
  X(cuMemcpyDtoHAsync_v2) X(cuMemcpyDtoHAsync_v2_ptsz)                      \
  X(cuMemcpyDtoDAsync_v2) X(cuMemcpyDtoDAsync_v2_ptsz)                      \
  X(cuMemsetD8_v2) X(cuMemsetD8_v2_ptds) X(cuMemsetD16_v2)                  \
  X(cuMemsetD16_v2_ptds) X(cuMemsetD32_v2) X(cuMemsetD32_v2_ptds)           \
  X(cuMemsetD8Async) X(cuMemsetD8Async_ptsz) X(cuMemsetD16Async)            \
  X(cuMemsetD16Async_ptsz) X(cuMemsetD32Async) X(cuMemsetD32Async_ptsz)

struct Entry {
  std::string base;
  int version;      // the first CUDA version that returns this variant
  bool per_thread;  // the per-thread-default-stream variant
  void* fn;
};

// The CUDA version that introduced a variant: per-thread variants 7.0,
// _v2 variants 3.2 (the 64-bit pointer ABI), with the later additions
// named.
int version_of(const std::string& name) {
  static const std::unordered_map<std::string, int> introduced = {
      {"cuGetProcAddress", 11030},    {"cuGetProcAddress_v2", 12000},
      {"cuLaunchKernelEx", 11080},    {"cuLaunchKernelEx_ptsz", 11080},
      {"cuMemAllocAsync", 11020},     {"cuMemAllocAsync_ptsz", 11020},
      {"cuMemAllocFromPoolAsync", 11020},
      {"cuMemAllocFromPoolAsync_ptsz", 11020},
      {"cuMemCreate", 10020},         {"cuStreamDestroy_v2", 4000},
      {"cuEventDestroy_v2", 4000},    {"cuStreamBeginCapture_v2", 10010},
      {"cuThreadExchangeStreamCaptureMode", 10010},
      {"cuStreamIsCapturing", 10000}, {"cuStreamIsCapturing_ptsz", 10000},
      {"cuGraphLaunch", 10000},       {"cuGraphLaunch_ptsz", 10000}};
  auto it = introduced.find(name);
  if (it != introduced.end()) return it->second;
  auto ends = [&](const char* s) {
    size_t n = std::strlen(s);
    return name.size() > n && name.compare(name.size() - n, n, s) == 0;
  };
  if (ends("_ptsz") || ends("_ptds")) return 7000;
  if (ends("_v2")) return 3020;
  return 2000;
}

std::string strip(std::string name, bool* per_thread) {
  *per_thread = false;
  for (const char* s : {"_ptsz", "_ptds"}) {
    size_t n = std::strlen(s);
    if (name.size() > n && name.compare(name.size() - n, n, s) == 0) {
      name.resize(name.size() - n);
      *per_thread = true;
    }
  }
  if (name.size() > 3 && name.compare(name.size() - 3, 3, "_v2") == 0)
    name.resize(name.size() - 3);
  return name;
}

const std::vector<Entry>& entries() {
  static const std::vector<Entry>* table = [] {
    auto* t = new std::vector<Entry>();
#define MOCK_ENTRY(name)                                               \
  {                                                                    \
    bool pt = false;                                                   \
    std::string base = strip(#name, &pt);                              \
    t->push_back(Entry{base, version_of(#name), pt,                    \
                       reinterpret_cast<void*>(&::name)});             \
  }
    MOCK_SYMBOLS(MOCK_ENTRY)
#undef MOCK_ENTRY
    return t;
  }();
  return *table;
}

const std::unordered_map<std::string, void*>& self_table() {
  static const auto* table = [] {
    auto* t = new std::unordered_map<std::string, void*>();
#define MOCK_SELF(name) t->emplace(#name, reinterpret_cast<void*>(&::name));
    MOCK_SYMBOLS(MOCK_SELF)
#undef MOCK_SELF
    return t;
  }();
  return *table;
}

}  // namespace

extern "C" {

// The newest variant of `symbol` that `version` allows, the per-thread
// one when the flag asks for it and one exists.
CUresult cuGetProcAddress_v2(const char* symbol, void** pfn, int version,
                             cuuint64_t flags,
                             CUdriverProcAddressQueryResult* status) {
  const bool want_pt =
      (flags & CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM) != 0;
  const Entry* best = nullptr;
  bool named = false;
  for (int pass = 0; pass < 2 && best == nullptr; pass++) {
    const bool pt = pass == 0 ? want_pt : false;
    if (pass == 1 && !want_pt) break;
    for (const Entry& e : entries()) {
      if (e.base != symbol || e.per_thread != pt) continue;
      named = true;
      if (e.version <= version && (best == nullptr || e.version > best->version))
        best = &e;
    }
  }
  *pfn = best != nullptr ? best->fn : nullptr;
  if (status != nullptr)
    *status = best != nullptr ? CU_GET_PROC_ADDRESS_SUCCESS
              : named         ? CU_GET_PROC_ADDRESS_VERSION_NOT_SUFFICIENT
                              : CU_GET_PROC_ADDRESS_SYMBOL_NOT_FOUND;
  return best != nullptr ? CUDA_SUCCESS : CUDA_ERROR_NOT_FOUND;
}

// Mock-only introspection for the test driver.
void mock_libcuda_counters(uint64_t* launches, uint64_t* ptsz_launches,
                           uint64_t* captured, uint64_t* graph_launches) {
  *launches = g_launches;
  *ptsz_launches = g_ptsz_launches;
  *captured = g_captured;
  *graph_launches = g_graph_launches;
}

void* mock_libcuda_self(const char* name) {
  auto it = self_table().find(name);
  return it == self_table().end() ? nullptr : it->second;
}

}  // extern "C"
