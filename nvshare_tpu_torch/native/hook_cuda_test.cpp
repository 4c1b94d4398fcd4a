// tpushare-cuda-hook-test — drives the driver-API interposer against the
// mock driver; the counterpart of src/hook_test.cpp.
//
// Usage: tpushare-cuda-hook-test <n_launches> [scenario]
// Env:   LD_PRELOAD=libtpushare_cuda.so, with libcuda.so.1 (the mock) on
//        LD_LIBRARY_PATH and $TPUSHARE_REAL_LIBCUDA naming it;
//        TPUSHARE_TEST_RESOLVE = getproc (default) | dlsym | dlsym225;
//        TPUSHARE_TEST_STREAM  = legacy (default) | ptsz | created.
//
// The driver finds the driver the way the CUDA 12 runtime does:
// dlopen("libcuda.so.1"), dlsym of cuGetProcAddress_v2, then every entry
// point through it (the per-thread-stream variants with
// CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM). `dlsym` resolves each
// symbol by its exact name instead, and `dlsym225` does so through
// dlsym@GLIBC_2.2.5, the version that programs linked before glibc 2.34
// bind. It prints the milestone lines of tpushare-hook-test (CLIENT,
// H2D, EXEC <i> <ms>, D2H, MEMLIMIT, DONE) with CLOCK_MONOTONIC ms, and
// the scenarios `policy`, `c2d`, `hostalloc`, `passthru`, `untracked`
// and `capture`.

#include <dlfcn.h>
#include <time.h>
#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "cuda_defs.h"

extern "C" void* dlsym_glibc_225(void* handle, const char* name);
__asm__(".symver dlsym_glibc_225,dlsym@GLIBC_2.2.5");

namespace {

long long now_ms() {
  timespec ts;
  ::clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<long long>(ts.tv_sec) * 1000 + ts.tv_nsec / 1000000;
}

void* g_handle = nullptr;
std::string g_route = "getproc";
bool g_per_thread = false;

using GetProcFn = CUresult (*)(const char*, void**, int, cuuint64_t,
                               CUdriverProcAddressQueryResult*);
GetProcFn g_getproc = nullptr;

void* lookup_symbol(const char* exact) {
  return g_route == "dlsym225" ? dlsym_glibc_225(g_handle, exact)
                               : ::dlsym(g_handle, exact);
}

// One entry point: by its base name through cuGetProcAddress_v2 (with the
// per-thread flag when `per_thread`), or by its exact symbol name.
void* resolve(const char* base, const char* exact, bool per_thread = false) {
  void* p = nullptr;
  if (g_route == "getproc") {
    CUdriverProcAddressQueryResult st = CU_GET_PROC_ADDRESS_SUCCESS;
    cuuint64_t flags =
        per_thread ? CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM
                   : CU_GET_PROC_ADDRESS_DEFAULT;
    if (g_getproc(base, &p, 12040, flags, &st) != CUDA_SUCCESS) p = nullptr;
  } else {
    p = lookup_symbol(exact);
  }
  if (p == nullptr) {
    std::fprintf(stderr, "cannot resolve %s (%s)\n", base, exact);
    std::exit(1);
  }
  return p;
}

template <typename Fn>
Fn get(const char* base, const char* exact, bool per_thread = false) {
  return reinterpret_cast<Fn>(resolve(base, exact, per_thread));
}

struct Api {
  CUresult (*init)(unsigned int);
  CUresult (*device_get)(CUdevice*, int);
  CUresult (*primary_ctx)(CUcontext*, CUdevice);
  CUresult (*ctx_set)(CUcontext);
  CUresult (*stream_create)(CUstream*, unsigned int);
  CUresult (*launch)(CUfunction, unsigned int, unsigned int, unsigned int,
                     unsigned int, unsigned int, unsigned int, unsigned int,
                     CUstream, void**, void**);
  CUresult (*htod)(CUdeviceptr, const void*, size_t);
  CUresult (*dtoh)(void*, CUdeviceptr, size_t);
  CUresult (*dtod)(CUdeviceptr, CUdeviceptr, size_t);
  CUresult (*mem_info)(size_t*, size_t*);
  CUresult (*alloc)(CUdeviceptr*, size_t);
  CUresult (*free)(CUdeviceptr);
};
Api api;

void must(CUresult r, const char* what) {
  if (r == CUDA_SUCCESS) return;
  std::fprintf(stderr, "%s failed: %d\n", what, r);
  std::exit(1);
}

CUfunction kernel() { return reinterpret_cast<CUfunction>(0x1); }

CUresult launch_on(CUstream s) {
  return api.launch(kernel(), 1, 1, 1, 1, 1, 1, 0, s, nullptr, nullptr);
}

void print_mock_counters() {
  using CountFn = void (*)(uint64_t*, uint64_t*, uint64_t*, uint64_t*);
  auto fn = reinterpret_cast<CountFn>(
      ::dlsym(g_handle, "mock_libcuda_counters"));
  if (fn == nullptr) return;
  uint64_t l = 0, pt = 0, cap = 0, g = 0;
  fn(&l, &pt, &cap, &g);
  std::printf("MOCK launches=%llu ptsz=%llu captured=%llu graphs=%llu\n",
              (unsigned long long)l, (unsigned long long)pt,
              (unsigned long long)cap, (unsigned long long)g);
}

void sleep_env_ms() {
  if (const char* ms = std::getenv("TPUSHARE_TEST_SLEEP_MS"))
    ::usleep(static_cast<useconds_t>(std::atoll(ms)) * 1000);
}

// Base-mode allocation policy: a claim past (capacity − reserve) fails
// with CUDA_ERROR_OUT_OF_MEMORY unless TPUSHARE_ENABLE_SINGLE_OVERSUB=1;
// a small one works either way.
int run_policy() {
  CUdeviceptr big = 0;
  CUresult r = api.alloc(&big, 20000ull * 20000 * 4);  // ~1.5 GiB
  if (r != CUDA_SUCCESS) {
    std::printf("POLICY_REFUSED\nREFUSAL_CODE %d\n", r);
  } else {
    std::printf("POLICY_ALLOWED\n");
    must(api.free(big), "free big");
  }
  CUdeviceptr small = 0;
  must(api.alloc(&small, 256), "small alloc");
  std::printf("SMALL_OK\n");
  must(api.free(small), "free small");
  std::printf("POLICY_DONE\n");
  return 0;
}

// A device-to-device copy is gated like a launch: H2D (takes the lock),
// an idle window that lets the early release hand the lock away, then
// cuMemcpyDtoD_v2, whose timestamp shows it waited.
int run_c2d() {
  CUdeviceptr a = 0, b = 0;
  must(api.alloc(&a, 256), "alloc a");
  must(api.alloc(&b, 256), "alloc b");
  char host[256] = {7};
  must(api.htod(a, host, sizeof(host)), "htod");
  std::printf("H2D %lld\n", now_ms());
  std::fflush(stdout);
  sleep_env_ms();
  must(api.dtod(b, a, sizeof(host)), "dtod");
  std::printf("C2D %lld\n", now_ms());
  char back[256] = {0};
  must(api.dtoh(back, b, sizeof(back)), "dtoh");
  if (back[0] != 7) {
    std::fprintf(stderr, "copies lost the bytes\n");
    return 1;
  }
  must(api.free(a), "free a");
  must(api.free(b), "free b");
  std::printf("C2D_DONE %lld\n", now_ms());
  return 0;
}

// A device claim is charged against capacity − reserve, pinned host
// memory is not: a second device copy of a ~0.9 GiB buffer against a
// ~1 GiB cap is refused, the same size in pinned host memory is not.
// Side from $TPUSHARE_TEST_C2M_DIM (floats), as the reference's c2m.
int run_hostalloc() {
  int64_t side = 512;
  if (const char* d = std::getenv("TPUSHARE_TEST_C2M_DIM")) side = std::atoll(d);
  const size_t bytes = static_cast<size_t>(side) * side * 4;
  CUdeviceptr src = 0;
  must(api.alloc(&src, bytes), "src alloc");
  std::printf("SRC_OK\n");
  CUdeviceptr dup = 0;
  if (api.alloc(&dup, bytes) != CUDA_SUCCESS) {
    std::printf("DEV_REFUSED\n");
  } else {
    std::printf("DEV_ALLOWED\n");
    must(api.free(dup), "free dup");
  }
  auto host_alloc = get<CUresult (*)(void**, size_t)>("cuMemAllocHost",
                                                      "cuMemAllocHost_v2");
  auto host_alloc2 = get<CUresult (*)(void**, size_t, unsigned int)>(
      "cuMemHostAlloc", "cuMemHostAlloc");
  auto free_host = get<CUresult (*)(void*)>("cuMemFreeHost", "cuMemFreeHost");
  void* pinned = nullptr;
  void* pinned2 = nullptr;
  if (host_alloc(&pinned, bytes) == CUDA_SUCCESS &&
      host_alloc2(&pinned2, bytes, 0) == CUDA_SUCCESS) {
    must(api.dtoh(pinned, src, 4096), "dtoh to pinned");
    std::printf("HOST_OK\n");
    must(free_host(pinned), "free pinned");
    must(free_host(pinned2), "free pinned 2");
  } else {
    std::printf("HOST_REFUSED\n");
  }
  must(api.free(src), "free src");
  std::printf("HOSTALLOC_DONE\n");
  return 0;
}

// A symbol the hook does not wrap resolves to the driver's own entry
// point; a wrapped one (and cuGetProcAddress itself) to the hook's.
int run_passthru() {
  using SelfFn = void* (*)(const char*);
  auto self = reinterpret_cast<SelfFn>(::dlsym(g_handle, "mock_libcuda_self"));
  if (self == nullptr) {
    std::fprintf(stderr, "no mock_libcuda_self\n");
    return 1;
  }
  struct Probe {
    const char* base;
    const char* exact;
  };
  for (const Probe& p : {Probe{"cuCtxGetCurrent", "cuCtxGetCurrent"},
                         Probe{"cuEventQuery", "cuEventQuery"},
                         Probe{"cuLaunchKernel", "cuLaunchKernel"},
                         Probe{"cuGetProcAddress", "cuGetProcAddress_v2"}}) {
    void* got = resolve(p.base, p.exact);
    std::printf("RESOLVED %s same=%d\n", p.base, got == self(p.exact) ? 1 : 0);
  }
  std::printf("PASSTHRU_DONE\n");
  return 0;
}

// Allocation routes the hook does not count fail with an error.
int run_untracked() {
  auto alloc_async = get<CUresult (*)(CUdeviceptr*, size_t, CUstream)>(
      "cuMemAllocAsync", "cuMemAllocAsync");
  auto create = get<CUresult (*)(CUmemGenericAllocationHandle*, size_t,
                                 const CUmemAllocationProp*,
                                 unsigned long long)>("cuMemCreate",
                                                      "cuMemCreate");
  auto managed = get<CUresult (*)(CUdeviceptr*, size_t, unsigned int)>(
      "cuMemAllocManaged", "cuMemAllocManaged");
  CUdeviceptr p = 0;
  CUmemGenericAllocationHandle h = 0;
  std::printf("ALLOC_ASYNC %d\n", alloc_async(&p, 1 << 20, nullptr));
  std::printf("MEM_CREATE %d\n", create(&h, 1 << 21, nullptr, 0));
  std::printf("MANAGED %d\n", managed(&p, 1 << 20, 1));
  std::printf("UNTRACKED_DONE\n");
  return 0;
}

// A launch on a capturing stream executes nothing: it must not wait at
// the gate. The captured graph's launch is gated.
int run_capture() {
  auto begin = get<CUresult (*)(CUstream, CUstreamCaptureMode)>(
      "cuStreamBeginCapture", "cuStreamBeginCapture_v2");
  auto end = get<CUresult (*)(CUstream, void**)>("cuStreamEndCapture",
                                                 "cuStreamEndCapture");
  auto graph_launch = get<CUresult (*)(CUgraphExec, CUstream)>(
      "cuGraphLaunch", "cuGraphLaunch");
  CUstream s = nullptr;
  must(api.stream_create(&s, 0), "stream create");
  must(begin(s, CU_STREAM_CAPTURE_MODE_GLOBAL), "begin capture");
  must(launch_on(s), "captured launch");
  std::printf("CAPTURED %lld\n", now_ms());
  void* graph = nullptr;
  must(end(s, &graph), "end capture");
  must(graph_launch(reinterpret_cast<CUgraphExec>(graph), s), "graph launch");
  std::printf("GRAPH %lld\n", now_ms());
  print_mock_counters();
  std::printf("CAPTURE_DONE\n");
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  int n = argc > 1 ? std::atoi(argv[1]) : 4;
  std::string scenario = argc > 2 ? argv[2] : "";
  if (const char* r = std::getenv("TPUSHARE_TEST_RESOLVE")) g_route = r;
  std::string stream_kind = "legacy";
  if (const char* s = std::getenv("TPUSHARE_TEST_STREAM")) stream_kind = s;
  g_per_thread = stream_kind == "ptsz";
  setvbuf(stdout, nullptr, _IOLBF, 0);

  g_handle = ::dlopen("libcuda.so.1", RTLD_NOW);
  if (g_handle == nullptr) {
    std::fprintf(stderr, "dlopen libcuda.so.1: %s\n", ::dlerror());
    return 1;
  }
  g_getproc = reinterpret_cast<GetProcFn>(lookup_symbol("cuGetProcAddress_v2"));
  if (g_getproc == nullptr) {
    std::fprintf(stderr, "no cuGetProcAddress_v2\n");
    return 1;
  }
  api.init = get<decltype(api.init)>("cuInit", "cuInit");
  api.device_get = get<decltype(api.device_get)>("cuDeviceGet", "cuDeviceGet");
  api.primary_ctx = get<decltype(api.primary_ctx)>(
      "cuDevicePrimaryCtxRetain", "cuDevicePrimaryCtxRetain");
  api.ctx_set = get<decltype(api.ctx_set)>("cuCtxSetCurrent", "cuCtxSetCurrent");
  api.stream_create =
      get<decltype(api.stream_create)>("cuStreamCreate", "cuStreamCreate");
  api.launch = get<decltype(api.launch)>(
      "cuLaunchKernel", g_per_thread ? "cuLaunchKernel_ptsz" : "cuLaunchKernel",
      g_per_thread);
  api.htod = get<decltype(api.htod)>(
      "cuMemcpyHtoD",
      g_per_thread ? "cuMemcpyHtoD_v2_ptds" : "cuMemcpyHtoD_v2", g_per_thread);
  api.dtoh = get<decltype(api.dtoh)>(
      "cuMemcpyDtoH",
      g_per_thread ? "cuMemcpyDtoH_v2_ptds" : "cuMemcpyDtoH_v2", g_per_thread);
  api.dtod = get<decltype(api.dtod)>(
      "cuMemcpyDtoD",
      g_per_thread ? "cuMemcpyDtoD_v2_ptds" : "cuMemcpyDtoD_v2", g_per_thread);
  api.mem_info = get<decltype(api.mem_info)>("cuMemGetInfo", "cuMemGetInfo_v2");
  api.alloc = get<decltype(api.alloc)>("cuMemAlloc", "cuMemAlloc_v2");
  api.free = get<decltype(api.free)>("cuMemFree", "cuMemFree_v2");

  CUresult r = api.init(0);
  if (r != CUDA_SUCCESS) {
    std::printf("INIT_FAILED %d\n", r);
    return 3;
  }
  CUdevice dev = 0;
  CUcontext ctx = nullptr;
  must(api.device_get(&dev, 0), "cuDeviceGet");
  must(api.primary_ctx(&ctx, dev), "cuDevicePrimaryCtxRetain");
  must(api.ctx_set(ctx), "cuCtxSetCurrent");
  std::printf("CLIENT %lld\n", now_ms());

  if (scenario == "policy") return run_policy();
  if (scenario == "c2d") return run_c2d();
  if (scenario == "hostalloc") return run_hostalloc();
  if (scenario == "passthru") return run_passthru();
  if (scenario == "untracked") return run_untracked();
  if (scenario == "capture") return run_capture();
  if (!scenario.empty()) {
    std::fprintf(stderr, "unknown scenario %s\n", scenario.c_str());
    return 2;
  }

  CUstream stream = nullptr;  // the legacy (or per-thread) default stream
  if (stream_kind == "created") must(api.stream_create(&stream, 0), "stream");
  CUdeviceptr buf = 0;
  float host[64] = {0};
  must(api.alloc(&buf, sizeof(host)), "alloc");
  must(api.htod(buf, host, sizeof(host)), "htod");  // gated
  std::printf("H2D %lld\n", now_ms());
  for (int i = 0; i < n; i++) {
    must(launch_on(stream), "launch");  // gated, window-fenced
    std::printf("EXEC %d %lld\n", i, now_ms());
  }
  float out[64];
  must(api.dtoh(out, buf, sizeof(out)), "dtoh");  // gated
  std::printf("D2H %lld\n", now_ms());
  size_t free_b = 0, total = 0;
  if (api.mem_info(&free_b, &total) == CUDA_SUCCESS)
    std::printf("MEMLIMIT %lld\nMEMFREE %lld\n", (long long)total,
                (long long)free_b);
  must(api.free(buf), "free");
  print_mock_counters();
  std::printf("DONE %lld\n", now_ms());
  return 0;
}
