// libtpushare_cuda.so — the out-of-process interposer on the CUDA driver API.
//
// The port's counterpart of src/hook.cpp (libtpushare.so, the PJRT
// interposer), in the reference's own form: an LD_PRELOAD library that
// stands between an unmodified program (and the CUDA runtime inside it)
// and the real libcuda.so.1 (grgalex/nvshare src/hook.c). It:
//
//   * interposes `dlsym` (at both glibc versions, hook.c:432-508,974-975),
//     `cuGetProcAddress` and `cuGetProcAddress_v2` (hook.c:529-643), and
//     exports every wrapped entry point under its real name. The CUDA 12
//     runtime reaches the driver through cuGetProcAddress_v2, so a lookup
//     is answered by the real driver first and the pointer it returns is
//     swapped for the wrapper of that exact variant (matched by address
//     against the real library's own symbols, never by name);
//   * gates every launch (cuLaunchKernel, cuLaunchKernelEx,
//     cuLaunchCooperativeKernel, cuGraphLaunch), copy (the cuMemcpy*
//     family) and memset (cuMemsetD*), with their per-thread-stream
//     variants, on the scheduler's lock (tpushare_continue_with_lock);
//   * bounds the work in flight with an adaptive pending-launch window
//     fenced by events (≙ after_submit_window / fence_all in src/hook.cpp,
//     hook.c:46-48,782-838), bounded on a wedged device;
//   * reports device memory less a reserve through cuMemGetInfo_v2 and
//     applies the base-mode allocation policy to cuMemAlloc_v2
//     (hook.c:662-670,698-746).
//
// Paging under the hook (TPUSHARE_CVMEM=1, src/hook_vmem.cpp's part) is
// not implemented here: the variable is refused, and the allocation
// routes only paging would take (stream-ordered pools, the VMM API,
// managed memory) fail loudly instead of escaping the count.
//
// At exit the library prints one `tpushare-cuda-hook:` line on stderr
// with what it gated (launches, copies, memsets, fences, fences timed
// out, the largest window, allocated bytes, when the first gated call
// passed the gate and how long gated calls waited there, and the launches
// by the object that called the driver).

#include <dlfcn.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <utility>
#include <vector>

#include "client.hpp"
#include "common.hpp"
#include "cuda_defs.h"

// Every entry point the library exports, by its exact symbol name.
#define TS_WRAPPED(X)                                                     \
  X(cuInit) X(cuGetProcAddress) X(cuGetProcAddress_v2)                    \
  X(cuLaunchKernel) X(cuLaunchKernel_ptsz)                                \
  X(cuLaunchKernelEx) X(cuLaunchKernelEx_ptsz)                            \
  X(cuLaunchCooperativeKernel) X(cuLaunchCooperativeKernel_ptsz)          \
  X(cuGraphLaunch) X(cuGraphLaunch_ptsz)                                  \
  X(cuMemcpy) X(cuMemcpy_ptds) X(cuMemcpyAsync) X(cuMemcpyAsync_ptsz)     \
  X(cuMemcpyHtoD_v2) X(cuMemcpyHtoD_v2_ptds)                              \
  X(cuMemcpyDtoH_v2) X(cuMemcpyDtoH_v2_ptds)                              \
  X(cuMemcpyDtoD_v2) X(cuMemcpyDtoD_v2_ptds)                              \
  X(cuMemcpyHtoDAsync_v2) X(cuMemcpyHtoDAsync_v2_ptsz)                    \
  X(cuMemcpyDtoHAsync_v2) X(cuMemcpyDtoHAsync_v2_ptsz)                    \
  X(cuMemcpyDtoDAsync_v2) X(cuMemcpyDtoDAsync_v2_ptsz)                    \
  X(cuMemcpy2D_v2) X(cuMemcpy2D_v2_ptds)                                  \
  X(cuMemcpy2DAsync_v2) X(cuMemcpy2DAsync_v2_ptsz)                        \
  X(cuMemcpy3D_v2) X(cuMemcpy3D_v2_ptds)                                  \
  X(cuMemcpy3DAsync_v2) X(cuMemcpy3DAsync_v2_ptsz)                        \
  X(cuMemsetD8_v2) X(cuMemsetD8_v2_ptds) X(cuMemsetD16_v2)                \
  X(cuMemsetD16_v2_ptds) X(cuMemsetD32_v2) X(cuMemsetD32_v2_ptds)         \
  X(cuMemsetD8Async) X(cuMemsetD8Async_ptsz) X(cuMemsetD16Async)          \
  X(cuMemsetD16Async_ptsz) X(cuMemsetD32Async) X(cuMemsetD32Async_ptsz)   \
  X(cuMemGetInfo_v2) X(cuMemAlloc_v2) X(cuMemAllocPitch_v2)               \
  X(cuMemFree_v2) X(cuMemAllocAsync) X(cuMemAllocAsync_ptsz)              \
  X(cuMemAllocFromPoolAsync) X(cuMemAllocFromPoolAsync_ptsz)              \
  X(cuMemCreate) X(cuMemAllocManaged)                                     \
  X(cuStreamDestroy) X(cuStreamDestroy_v2)

namespace {

using namespace tpushare;

constexpr const char* kTag = "cuda-hook";

// Adaptive pending-launch window, the reference's bounds for kernels
// (hook.c:46-48): 1 to 2048 launches between fences, halved when a fence
// takes over 1 s and collapsed to 1 over 10 s. This deviates from
// src/hook.cpp, whose cap is 256 because each of its submissions is a
// whole fused XLA program; here each is one kernel, and a PyTorch step
// launches thousands.
constexpr int64_t kWindowMin = 1;
constexpr int64_t kWindowMax = 2048;
constexpr int64_t kSyncBusyMs = 1000;
constexpr int64_t kSyncSlowMs = 10000;
// A tracked event that has had its whole fence budget is waited for only
// this long by later fences (src/hook.cpp kWedgedRetryMs).
constexpr int64_t kWedgedRetryMs = 1000;
// fence_all's answer when the budget ran out with work in flight.
constexpr int64_t kFenceTimedOut = INT64_MAX;

enum SymId {
#define TS_ID(name) k_##name,
  TS_WRAPPED(TS_ID)
#undef TS_ID
  kNumSyms
};
const char* const kSymNames[kNumSyms] = {
#define TS_NAME(name) #name,
    TS_WRAPPED(TS_NAME)
#undef TS_NAME
};
// The wrappers' own addresses, filled in by fill_wrappers() (at the end of
// the file, after the wrappers are defined) when the real driver loads.
void* g_wrappers[kNumSyms] = {};
void fill_wrappers();

// The real driver: its handle, the real pointer of every wrapped symbol,
// and the entry points the hook calls for itself (never through a
// wrapper, so that the hook's own fences are never gated or counted).
void* g_libcuda = nullptr;
void* g_real[kNumSyms] = {};
std::unordered_map<void*, void*>* g_wrapper_of = nullptr;  // real -> ours
std::unordered_set<std::string>* g_wrapped_bases = nullptr;
struct Helpers {
  CUresult (*ctx_get_current)(CUcontext*) = nullptr;
  CUresult (*ctx_set_current)(CUcontext) = nullptr;
  CUresult (*event_create)(CUevent*, unsigned int) = nullptr;
  CUresult (*event_record)(CUevent, CUstream) = nullptr;
  CUresult (*event_query)(CUevent) = nullptr;
  CUresult (*event_destroy)(CUevent) = nullptr;
  CUresult (*stream_is_capturing)(CUstream, CUstreamCaptureStatus*) = nullptr;
  CUresult (*stream_is_capturing_ptsz)(CUstream,
                                       CUstreamCaptureStatus*) = nullptr;
  CUresult (*exchange_capture_mode)(CUstreamCaptureMode*) = nullptr;
} g_cu;

// Set while this thread loads the real driver: its constructors may look
// symbols up, and those lookups must pass straight through.
thread_local bool t_loading = false;

using DlsymFn = void* (*)(void*, const char*);

// glibc's own dlsym, found by version because this library defines
// `dlsym` itself (hook.c:346-380): GLIBC_2.34 where libc carries it,
// GLIBC_2.2.5 (libdl) before.
DlsymFn real_dlsym() {
  static const DlsymFn fn = [] {
    void* p = ::dlvsym(RTLD_NEXT, "dlsym", "GLIBC_2.34");
    if (p == nullptr) p = ::dlvsym(RTLD_NEXT, "dlsym", "GLIBC_2.2.5");
    if (p == nullptr) {
      ::fprintf(stderr, "tpushare: cannot find glibc's dlsym\n");
      ::abort();
    }
    return reinterpret_cast<DlsymFn>(p);
  }();
  return fn;
}

int sym_id(const char* name) {
  static const std::unordered_map<std::string, int>* ids = [] {
    auto* m = new std::unordered_map<std::string, int>();
    for (int i = 0; i < kNumSyms; i++) m->emplace(kSymNames[i], i);
    return m;
  }();
  auto it = ids->find(name);
  return it == ids->end() ? -1 : it->second;
}

// The symbol's name less its variant suffixes: the name a caller passes
// to cuGetProcAddress.
std::string base_name(std::string name) {
  for (const char* suffix : {"_ptsz", "_ptds", "_v2"}) {
    size_t n = std::strlen(suffix);
    if (name.size() > n && name.compare(name.size() - n, n, suffix) == 0)
      name.resize(name.size() - n);
  }
  return name;
}

// Load the real libcuda.so.1 ($TPUSHARE_REAL_LIBCUDA overrides the name,
// which is how the tests point the hook at the mock driver) and resolve
// every real pointer, once.
bool load_real() {
  static std::once_flag once;
  static bool ok = false;
  std::call_once(once, [] {
    t_loading = true;
    std::string path = env_or("TPUSHARE_REAL_LIBCUDA", "libcuda.so.1");
    g_libcuda = ::dlopen(path.c_str(), RTLD_NOW | RTLD_LOCAL);
    if (g_libcuda == nullptr) {
      ::fprintf(stderr, "tpushare: cannot load the CUDA driver %s: %s\n",
                path.c_str(), ::dlerror());
      t_loading = false;
      return;
    }
    DlsymFn sym = real_dlsym();
    fill_wrappers();
    g_wrapper_of = new std::unordered_map<void*, void*>();
    g_wrapped_bases = new std::unordered_set<std::string>();
    for (int i = 0; i < kNumSyms; i++) {
      g_real[i] = sym(g_libcuda, kSymNames[i]);
      if (g_real[i] != nullptr) g_wrapper_of->emplace(g_real[i], g_wrappers[i]);
      g_wrapped_bases->insert(base_name(kSymNames[i]));
    }
    auto bind = [&](auto& slot, const char* name) {
      slot = reinterpret_cast<std::remove_reference_t<decltype(slot)>>(
          sym(g_libcuda, name));
    };
    bind(g_cu.ctx_get_current, "cuCtxGetCurrent");
    bind(g_cu.ctx_set_current, "cuCtxSetCurrent");
    bind(g_cu.event_create, "cuEventCreate");
    bind(g_cu.event_record, "cuEventRecord");
    bind(g_cu.event_query, "cuEventQuery");
    bind(g_cu.event_destroy, "cuEventDestroy_v2");
    bind(g_cu.stream_is_capturing, "cuStreamIsCapturing");
    bind(g_cu.stream_is_capturing_ptsz, "cuStreamIsCapturing_ptsz");
    bind(g_cu.exchange_capture_mode, "cuThreadExchangeStreamCaptureMode");
    ok = g_cu.ctx_get_current != nullptr && g_cu.ctx_set_current != nullptr &&
         g_cu.event_create != nullptr && g_cu.event_record != nullptr &&
         g_cu.event_query != nullptr && g_cu.event_destroy != nullptr;
    if (!ok)
      ::fprintf(stderr, "tpushare: %s lacks the context and event entry "
                        "points the hook fences with\n", path.c_str());
    TS_DEBUG(kTag, "real driver %s loaded", path.c_str());
    t_loading = false;
  });
  return ok;
}

void* wrapper_of(void* real) {
  auto it = g_wrapper_of->find(real);
  return it == g_wrapper_of->end() ? real : it->second;
}

// ------------------------------------------------------------ counters --

std::atomic<uint64_t> g_launches{0}, g_copies{0}, g_memsets{0};
std::atomic<uint64_t> g_fences{0}, g_fence_timeouts{0}, g_refused{0};
std::atomic<int64_t> g_window_max{kWindowMin};
// When the first gated call passed the gate (Unix ms, 0 before), and the
// time gated calls spent waiting at it.
std::atomic<int64_t> g_first_pass_unix_ms{0};
std::atomic<int64_t> g_gate_wait_us{0};

// Launches by the object that called the driver (the caller's return
// address resolved with dladdr, cached): shows whose runtime reached the
// hook, e.g. libcudart.so for PyTorch's kernels and each ctypes-loaded
// kernel library, which carries a static copy of the runtime.
std::mutex g_caller_mu;
std::unordered_map<void*, size_t>* g_caller_obj = nullptr;
std::vector<std::pair<std::string, uint64_t>>* g_objs = nullptr;

void note_caller(void* ret) {
  std::lock_guard<std::mutex> lk(g_caller_mu);
  if (g_caller_obj == nullptr) {
    g_caller_obj = new std::unordered_map<void*, size_t>();
    g_objs = new std::vector<std::pair<std::string, uint64_t>>();
  }
  auto it = g_caller_obj->find(ret);
  if (it == g_caller_obj->end()) {
    Dl_info info;
    std::string name = "?";
    if (::dladdr(ret, &info) != 0 && info.dli_fname != nullptr) {
      name = info.dli_fname;
      size_t slash = name.rfind('/');
      if (slash != std::string::npos) name = name.substr(slash + 1);
    }
    size_t idx = 0;
    while (idx < g_objs->size() && (*g_objs)[idx].first != name) idx++;
    if (idx == g_objs->size()) g_objs->emplace_back(name, 0);
    it = g_caller_obj->emplace(ret, idx).first;
  }
  (*g_objs)[it->second].second++;
}

// ------------------------------------------------------ context, capture --

// The context of the first gated call: the scheduler's DROP_LOCK arrives
// on the client's message thread, which has no current context, and the
// fence's event calls need one.
std::atomic<CUcontext> g_ctx{nullptr};

void note_ctx() {
  if (g_ctx.load(std::memory_order_relaxed) != nullptr) return;
  CUcontext cur = nullptr;
  if (g_cu.ctx_get_current(&cur) == CUDA_SUCCESS && cur != nullptr) {
    CUcontext none = nullptr;
    g_ctx.compare_exchange_strong(none, cur);
  }
}

bool ensure_thread_ctx() {
  CUcontext cur = nullptr;
  if (g_cu.ctx_get_current(&cur) == CUDA_SUCCESS && cur != nullptr)
    return true;
  CUcontext ctx = g_ctx.load();
  return ctx != nullptr && g_cu.ctx_set_current(ctx) == CUDA_SUCCESS;
}

// A stream that is capturing executes nothing: its launches are neither
// gated nor fenced (an event query beside a capture invalidates it). The
// graph is gated when it is launched.
bool capturing(CUstream s, bool ptsz) {
  auto fn = ptsz ? g_cu.stream_is_capturing_ptsz : g_cu.stream_is_capturing;
  if (fn == nullptr) return false;
  CUstreamCaptureStatus st = CU_STREAM_CAPTURE_STATUS_NONE;
  return fn(s, &st) == CUDA_SUCCESS && st != CU_STREAM_CAPTURE_STATUS_NONE;
}

// The hook's own event calls run in relaxed capture mode, so that they
// never count as unsafe calls beside another thread's global capture.
class RelaxedCapture {
 public:
  RelaxedCapture() {
    if (g_cu.exchange_capture_mode == nullptr) return;
    mode_ = CU_STREAM_CAPTURE_MODE_RELAXED;
    set_ = g_cu.exchange_capture_mode(&mode_) == CUDA_SUCCESS;
  }
  ~RelaxedCapture() {
    if (set_) g_cu.exchange_capture_mode(&mode_);
  }

 private:
  CUstreamCaptureMode mode_ = CU_STREAM_CAPTURE_MODE_RELAXED;
  bool set_ = false;
};

// ------------------------------------------------------------- fences --

// Streams launched on since the last fence, and the events that fences
// (and per-thread-stream launches) recorded and have not yet seen
// complete. One event a stream: work on a stream completes in order, so
// its newest event covers the older ones; `since_ms` keeps the time the
// stream was first found busy, which gives each stuck stream one full
// budget in all (src/hook.cpp's per-event age).
struct Pending {
  CUevent ev = nullptr;
  int64_t since_ms = 0;
  uint64_t gen = 0;           // bumped at every record
  bool thread_event = false;  // a per-thread stream's event, kept for reuse
};
std::mutex g_mu;
std::unordered_set<CUstream>* g_touched = nullptr;
std::unordered_map<void*, Pending>* g_pending = nullptr;
std::vector<CUevent>* g_free_events = nullptr;
std::mutex g_fence_mu;  // one fence at a time

int64_t fence_budget_ms() {
  static const int64_t v = [] {
    int64_t ms = env_int_or("TPUSHARE_FENCE_TIMEOUT_MS", 60000);
    if (ms <= 0) return int64_t{60000};
    return std::min<int64_t>(ms, 86400000);
  }();
  return v;
}

void init_tracking_locked() {
  if (g_touched != nullptr) return;
  g_touched = new std::unordered_set<CUstream>();
  g_pending = new std::unordered_map<void*, Pending>();
  g_free_events = new std::vector<CUevent>();
}

CUevent take_event_locked() {
  if (!g_free_events->empty()) {
    CUevent ev = g_free_events->back();
    g_free_events->pop_back();
    return ev;
  }
  CUevent ev = nullptr;
  if (g_cu.event_create(&ev, CU_EVENT_DISABLE_TIMING) != CUDA_SUCCESS)
    return nullptr;
  return ev;
}

// A launch on the calling thread's per-thread default stream cannot be
// fenced from another thread, so its event is recorded here, at launch.
thread_local CUevent t_thread_ev = nullptr;

void record_thread_stream() {
  std::lock_guard<std::mutex> lk(g_mu);
  init_tracking_locked();
  if (t_thread_ev == nullptr) {
    t_thread_ev = take_event_locked();
    if (t_thread_ev == nullptr) {
      TS_WARN(kTag, "cannot create an event for a per-thread stream; its "
                    "launches are not fenced");
      return;
    }
  }
  if (g_cu.event_record(t_thread_ev, CU_STREAM_PER_THREAD) != CUDA_SUCCESS)
    return;
  Pending& p = (*g_pending)[t_thread_ev];
  if (p.ev == nullptr) p = Pending{t_thread_ev, monotonic_ms(), 0, true};
  p.gen++;
}

void note_stream(CUstream s, bool ptsz) {
  if (s == CU_STREAM_PER_THREAD || (ptsz && s == nullptr)) {
    record_thread_stream();
    return;
  }
  if (s == nullptr) s = CU_STREAM_LEGACY;
  std::lock_guard<std::mutex> lk(g_mu);
  init_tracking_locked();
  g_touched->insert(s);
}

// Record an event on every stream launched on since the last fence;
// returns a snapshot of what is pending. Caller holds g_mu.
std::vector<std::pair<void*, Pending>> record_touched_locked(int64_t now) {
  init_tracking_locked();
  for (CUstream s : *g_touched) {
    if (capturing(s, false)) continue;
    auto it = g_pending->find(s);
    bool fresh = it == g_pending->end();
    CUevent ev = fresh ? take_event_locked() : it->second.ev;
    if (ev == nullptr) continue;
    if (g_cu.event_record(ev, s) != CUDA_SUCCESS) {
      TS_WARN(kTag, "cannot record a fence event on stream %p",
              static_cast<void*>(s));
      if (fresh) g_free_events->push_back(ev);
      continue;
    }
    if (fresh) it = g_pending->emplace(s, Pending{ev, now, 0, false}).first;
    it->second.gen++;
  }
  g_touched->clear();
  return {g_pending->begin(), g_pending->end()};
}

void retire_locked(void* key, const Pending& seen) {
  auto it = g_pending->find(key);
  if (it == g_pending->end() || it->second.gen != seen.gen) return;
  if (!it->second.thread_event) g_free_events->push_back(it->second.ev);
  g_pending->erase(it);
}

// Wait for every stream launched on since the last fence. Returns the
// wall ms, or kFenceTimedOut when the budget ran out first (the pending
// events stay tracked for the next fence, and a WARN records the wedge).
// ≙ src/hook.cpp fence_all, with cuEventQuery polling in place of
// PJRT_Event OnReady.
int64_t fence_all() {
  if (!load_real()) return 0;
  std::lock_guard<std::mutex> fl(g_fence_mu);
  const int64_t t0 = monotonic_ms();
  if (!ensure_thread_ctx()) return 0;  // nothing launched yet
  RelaxedCapture relaxed;
  g_fences++;
  std::vector<std::pair<void*, Pending>> snap;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    snap = record_touched_locked(t0);
  }
  if (snap.empty()) return monotonic_ms() - t0;
  const int64_t budget = fence_budget_ms();
  int64_t deadline = t0 + budget;
  for (const auto& kv : snap)
    deadline = std::min(deadline, kv.second.since_ms + budget);
  deadline = std::max(deadline, t0 + std::min(kWedgedRetryMs, budget));
  std::vector<bool> done(snap.size(), false);
  size_t left = snap.size();
  int64_t nap_us = 20;
  bool timed_out = false;
  while (true) {
    for (size_t i = 0; i < snap.size(); i++) {
      if (done[i]) continue;
      CUresult q = g_cu.event_query(snap[i].second.ev);
      if (q == CUDA_ERROR_NOT_READY) continue;
      if (q != CUDA_SUCCESS)
        TS_WARN(kTag, "fence event query failed (%d); dropping the event",
                q);
      done[i] = true;
      left--;
    }
    if (left == 0) break;
    if (monotonic_ms() >= deadline) {
      timed_out = true;
      break;
    }
    std::this_thread::sleep_for(std::chrono::microseconds(nap_us));
    nap_us = std::min<int64_t>(nap_us * 2, 1000);
  }
  {
    std::lock_guard<std::mutex> lk(g_mu);
    for (size_t i = 0; i < snap.size(); i++)
      if (done[i]) retire_locked(snap[i].first, snap[i].second);
  }
  if (timed_out) {
    g_fence_timeouts++;
    TS_WARN(kTag,
            "fence timed out after %lld ms with %zu stream(s) still busy — "
            "device wedged? Releasing the lock anyway",
            static_cast<long long>(monotonic_ms() - t0), left);
    return kFenceTimedOut;
  }
  return monotonic_ms() - t0;
}

// Early-release idle probe: 1 while any recorded event is pending, 0 when
// every one has completed, -1 when nothing is tracked (the client then
// falls back to a timed fence). ≙ src/hook.cpp busy_probe.
int busy_probe() {
  if (!load_real()) return -1;
  std::unique_lock<std::mutex> fl(g_fence_mu, std::try_to_lock);
  if (!fl.owns_lock()) return 1;  // a fence is waiting on the device
  if (!ensure_thread_ctx()) return -1;
  RelaxedCapture relaxed;
  std::vector<std::pair<void*, Pending>> snap;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    snap = record_touched_locked(monotonic_ms());
  }
  if (snap.empty()) return -1;
  bool busy = false;
  std::vector<bool> done(snap.size(), false);
  for (size_t i = 0; i < snap.size(); i++) {
    CUresult q = g_cu.event_query(snap[i].second.ev);
    if (q == CUDA_ERROR_NOT_READY)
      busy = true;
    else
      done[i] = true;
  }
  std::lock_guard<std::mutex> lk(g_mu);
  for (size_t i = 0; i < snap.size(); i++)
    if (done[i]) retire_locked(snap[i].first, snap[i].second);
  return busy ? 1 : 0;
}

// ≙ src/hook.cpp after_submit_window.
std::mutex g_win_mu;
int64_t g_window = kWindowMin;
int64_t g_since_sync = 0;

void after_submit_window() {
  bool due;
  {
    std::lock_guard<std::mutex> lk(g_win_mu);
    g_since_sync++;
    due = g_since_sync >= g_window;
  }
  if (!due) return;
  int64_t ms = fence_all();
  std::lock_guard<std::mutex> lk(g_win_mu);
  g_since_sync = 0;
  if (ms >= kSyncSlowMs)
    g_window = kWindowMin;
  else if (ms >= kSyncBusyMs)
    g_window = std::max<int64_t>(g_window / 2, kWindowMin);
  else
    g_window = std::min<int64_t>(g_window * 2, kWindowMax);
  if (g_window > g_window_max.load()) g_window_max = g_window;
}

// -------------------------------------------------------------- client --

void sync_and_evict(void*) {
  // Nothing is paged in this library (TPUSHARE_CVMEM=1 is refused), so
  // the hand-off's obligation is the fence alone.
  fence_all();
}

// CUDA_SUCCESS once the client runs (or runs unmanaged without a
// scheduler); otherwise the error every gated call returns.
CUresult ensure_client() {
  static std::once_flag once;
  static CUresult err = CUDA_SUCCESS;
  std::call_once(once, [] {
    if (env_int_or("TPUSHARE_CVMEM", 0) != 0) {
      ::fprintf(stderr,
                "tpushare: TPUSHARE_CVMEM=1 (paging under the hook) is not "
                "implemented by libtpushare_cuda.so; refusing to run\n");
      err = CUDA_ERROR_NOT_SUPPORTED;
      return;
    }
    tpushare_client_callbacks cbs;
    std::memset(&cbs, 0, sizeof(cbs));
    cbs.sync_and_evict = sync_and_evict;
    cbs.prefetch = [](void*) {};  // nothing was paged out at the hand-off
    cbs.busy_probe = [](void*) { return busy_probe(); };
    cbs.timed_sync_ms = [](void*) -> int64_t { return fence_all(); };
    if (tpushare_client_init(&cbs) != 0) {
      ::fprintf(stderr, "tpushare: the scheduler is required "
                        "(TPUSHARE_REQUIRE_SCHEDULER=1) but unreachable\n");
      err = CUDA_ERROR_NOT_INITIALIZED;
    }
  });
  return err;
}

enum class Kind { kLaunch, kCopy, kDevCopy, kMemset };

// The gate before a launch, copy or memset. Returns the error to hand
// back, or CUDA_SUCCESS; `*track` says whether the call was gated (a
// capturing stream's are not).
CUresult gate_enter(CUstream s, bool ptsz, bool* track) {
  *track = false;
  if (!load_real()) return CUDA_ERROR_NOT_INITIALIZED;
  if (capturing(s, ptsz)) return CUDA_SUCCESS;
  if (CUresult e = ensure_client()) return e;
  const auto t0 = std::chrono::steady_clock::now();
  tpushare_continue_with_lock();
  g_gate_wait_us += std::chrono::duration_cast<std::chrono::microseconds>(
                        std::chrono::steady_clock::now() - t0)
                        .count();
  if (g_first_pass_unix_ms.load(std::memory_order_relaxed) == 0) {
    int64_t none = 0;
    g_first_pass_unix_ms.compare_exchange_strong(
        none, std::chrono::duration_cast<std::chrono::milliseconds>(
                  std::chrono::system_clock::now().time_since_epoch())
                  .count());
  }
  note_ctx();
  *track = true;
  return CUDA_SUCCESS;
}

void gate_leave(Kind k, CUstream s, bool ptsz, bool track, CUresult r,
                void* caller) {
  if (!track || r != CUDA_SUCCESS) return;
  switch (k) {
    case Kind::kLaunch:
      g_launches++;
      note_caller(caller);
      break;
    case Kind::kCopy:
    case Kind::kDevCopy:
      g_copies++;
      break;
    case Kind::kMemset:
      g_memsets++;
      break;
  }
  note_stream(s, ptsz);
  // Device-side work fills the window (≙ Execute and CopyToDevice in
  // src/hook.cpp); host transfers and memsets are fenced but do not.
  if (k == Kind::kLaunch || k == Kind::kDevCopy) after_submit_window();
}

// -------------------------------------------------- allocation policy --
// Base-mode single-process oversubscription policy (≙ hook.c:662-670,
// src/hook.cpp refuse_if_over): the process's device allocations are
// counted, and one that would take the total past (capacity − reserve)
// fails with CUDA_ERROR_OUT_OF_MEMORY unless
// TPUSHARE_ENABLE_SINGLE_OVERSUB=1. Pinned host memory is not charged.

std::mutex g_alloc_mu;
std::unordered_map<CUdeviceptr, int64_t>* g_allocs = nullptr;
int64_t g_alloc_total = 0;
int64_t g_alloc_peak = 0;
int64_t g_allocatable = -2;  // -2: not yet learned; -1: unknowable

int64_t reserve_bytes() {
  return env_bytes_or("TPUSHARE_RESERVE_BYTES", 1536ll << 20);
}

int64_t allocatable_locked() {
  if (g_allocatable != -2) return g_allocatable;
  size_t free_b = 0, total = 0;
  auto real = reinterpret_cast<CUresult (*)(size_t*, size_t*)>(
      g_real[k_cuMemGetInfo_v2]);
  if (real == nullptr || real(&free_b, &total) != CUDA_SUCCESS || total == 0)
    return -1;  // unknowable this call; asked again at the next
  const int64_t cap = static_cast<int64_t>(total);
  g_allocatable = std::max(cap - reserve_bytes(), cap / 16);
  TS_INFO(kTag, "allocatable device memory learned: %lld MiB",
          static_cast<long long>(g_allocatable >> 20));
  return g_allocatable;
}

CUresult refuse_if_over(int64_t est) {
  static const bool oversub_ok =
      env_int_or("TPUSHARE_ENABLE_SINGLE_OVERSUB", 0) != 0;
  std::lock_guard<std::mutex> lk(g_alloc_mu);
  int64_t cap = allocatable_locked();
  if (cap < 0 || g_alloc_total + est <= cap) return CUDA_SUCCESS;
  if (oversub_ok) {
    TS_WARN(kTag,
            "allocation overshoots device memory (%lld + %lld > %lld MiB) "
            "— TPUSHARE_ENABLE_SINGLE_OVERSUB=1, proceeding",
            static_cast<long long>(g_alloc_total >> 20),
            static_cast<long long>(est >> 20),
            static_cast<long long>(cap >> 20));
    return CUDA_SUCCESS;
  }
  g_refused++;
  TS_WARN(kTag,
          "tpushare: refusing allocation: %lld MiB allocated + %lld MiB "
          "requested > %lld MiB allocatable (set "
          "TPUSHARE_ENABLE_SINGLE_OVERSUB=1 to oversubscribe)",
          static_cast<long long>(g_alloc_total >> 20),
          static_cast<long long>(est >> 20),
          static_cast<long long>(cap >> 20));
  return CUDA_ERROR_OUT_OF_MEMORY;
}

void track_alloc(CUdeviceptr p, int64_t bytes) {
  std::lock_guard<std::mutex> lk(g_alloc_mu);
  if (g_allocs == nullptr)
    g_allocs = new std::unordered_map<CUdeviceptr, int64_t>();
  auto [it, fresh] = g_allocs->emplace(p, bytes);
  if (!fresh) return;
  g_alloc_total += bytes;
  g_alloc_peak = std::max(g_alloc_peak, g_alloc_total);
}

void untrack_alloc(CUdeviceptr p) {
  std::lock_guard<std::mutex> lk(g_alloc_mu);
  if (g_allocs == nullptr) return;
  auto it = g_allocs->find(p);
  if (it == g_allocs->end()) return;
  g_alloc_total -= it->second;
  g_allocs->erase(it);
}

CUresult refuse_untracked(const char* route) {
  g_refused++;
  ::fprintf(stderr,
            "tpushare: %s is an allocation route libtpushare_cuda.so does "
            "not count; refusing it (paging under the hook is not "
            "implemented)\n",
            route);
  return CUDA_ERROR_NOT_SUPPORTED;
}

// ---------------------------------------------------------- interposing --

void* hook_dlsym(void* handle, const char* name) {
  void* r = real_dlsym()(handle, name);
  if (r == nullptr || name == nullptr || name[0] != 'c' || name[1] != 'u' ||
      t_loading)
    return r;
  int id = sym_id(name);
  if (id < 0 || !load_real()) return r;
  // Only a lookup that would reach the real driver's own symbol is
  // answered with the wrapper; any other passes through as it is.
  return r == g_real[id] ? g_wrappers[id] : r;
}

// A cuGetProcAddress answer that the hook does not know, for a name it
// wraps: reported once per name, since its calls would run ungated.
void warn_unknown_variant(const char* symbol) {
  static std::mutex mu;
  static std::unordered_set<std::string>* seen =
      new std::unordered_set<std::string>();
  if (g_wrapped_bases->count(symbol) == 0) return;
  std::lock_guard<std::mutex> lk(mu);
  if (seen->insert(symbol).second)
    TS_WARN(kTag, "cuGetProcAddress(%s) returned an entry point the hook "
                  "does not know; calls through it are not gated", symbol);
}

void answer_proc_address(const char* symbol, void** pfn) {
  void* got = wrapper_of(*pfn);
  if (got == *pfn) warn_unknown_variant(symbol);
  *pfn = got;
}

std::string callers_field() {
  std::lock_guard<std::mutex> lk(g_caller_mu);
  std::string out;
  if (g_objs == nullptr) return "-";
  for (const auto& [name, n] : *g_objs) {
    if (!out.empty()) out += ",";
    out += name + ":" + std::to_string(n);
  }
  return out;
}

__attribute__((constructor)) void announce() {
  ::fprintf(stderr, "tpushare-cuda-hook: preloaded (pid %d)\n", ::getpid());
}

__attribute__((destructor)) void report() {
  int64_t total, peak;
  {
    std::lock_guard<std::mutex> lk(g_alloc_mu);
    total = g_alloc_total;
    peak = g_alloc_peak;
  }
  ::fprintf(stderr,
            "tpushare-cuda-hook: pid=%d launches=%llu copies=%llu "
            "memsets=%llu fences=%llu fence_timeouts=%llu window_max=%lld "
            "allocated_bytes=%lld peak_allocated_bytes=%lld refused=%llu "
            "first_gated_unix_ms=%lld gate_wait_ms=%lld callers=%s\n",
            ::getpid(), static_cast<unsigned long long>(g_launches.load()),
            static_cast<unsigned long long>(g_copies.load()),
            static_cast<unsigned long long>(g_memsets.load()),
            static_cast<unsigned long long>(g_fences.load()),
            static_cast<unsigned long long>(g_fence_timeouts.load()),
            static_cast<long long>(g_window_max.load()),
            static_cast<long long>(total), static_cast<long long>(peak),
            static_cast<unsigned long long>(g_refused.load()),
            static_cast<long long>(g_first_pass_unix_ms.load()),
            static_cast<long long>(g_gate_wait_us.load() / 1000),
            callers_field().c_str());
}

}  // namespace

// The real pointer of a wrapped symbol, typed as the wrapper; a symbol the
// real driver lacks answers CUDA_ERROR_NOT_FOUND.
#define TS_REAL(name) reinterpret_cast<decltype(&::name)>(g_real[k_##name])
#define TS_REAL_OR_FAIL(name)                                    \
  if (!load_real()) return CUDA_ERROR_NOT_INITIALIZED;           \
  if (g_real[k_##name] == nullptr) return CUDA_ERROR_NOT_FOUND

// A gated entry point: the gate, the real call, then the bookkeeping.
#define TS_GATED(kind, name, params, args, stream, ptsz)          \
  CUresult name params {                                          \
    void* caller = __builtin_return_address(0);                   \
    TS_REAL_OR_FAIL(name);                                        \
    bool track = false;                                           \
    if (CUresult e = gate_enter(stream, ptsz, &track)) return e;  \
    CUresult r = TS_REAL(name) args;                              \
    gate_leave(kind, stream, ptsz, track, r, caller);             \
    return r;                                                     \
  }

extern "C" {

// dlsym at both glibc versions (src/hook.c:974-975 and the version
// script): programs linked against glibc < 2.34 bind dlsym@GLIBC_2.2.5,
// newer ones dlsym@@GLIBC_2.34.
void* tpushare_dlsym_225(void* handle, const char* name) {
  return hook_dlsym(handle, name);
}
void* tpushare_dlsym_234(void* handle, const char* name) {
  return hook_dlsym(handle, name);
}
__asm__(".symver tpushare_dlsym_225,dlsym@GLIBC_2.2.5");
__asm__(".symver tpushare_dlsym_234,dlsym@@GLIBC_2.34");

CUresult cuInit(unsigned int flags) {
  TS_REAL_OR_FAIL(cuInit);
  CUresult r = TS_REAL(cuInit)(flags);
  if (r != CUDA_SUCCESS) return r;
  return ensure_client();  // ≙ the cuInit-time initialize_client
}

CUresult cuGetProcAddress(const char* symbol, void** pfn, int cuda_version,
                          cuuint64_t flags) {
  TS_REAL_OR_FAIL(cuGetProcAddress);
  CUresult r = TS_REAL(cuGetProcAddress)(symbol, pfn, cuda_version, flags);
  if (r == CUDA_SUCCESS && pfn != nullptr && *pfn != nullptr)
    answer_proc_address(symbol, pfn);
  return r;
}

CUresult cuGetProcAddress_v2(const char* symbol, void** pfn,
                             int cuda_version, cuuint64_t flags,
                             CUdriverProcAddressQueryResult* status) {
  TS_REAL_OR_FAIL(cuGetProcAddress_v2);
  CUresult r = TS_REAL(cuGetProcAddress_v2)(symbol, pfn, cuda_version,
                                            flags, status);
  if (r == CUDA_SUCCESS && pfn != nullptr && *pfn != nullptr)
    answer_proc_address(symbol, pfn);
  return r;
}

#define TS_LAUNCH_PARAMS                                                  \
  CUfunction f, unsigned int gx, unsigned int gy, unsigned int gz,        \
      unsigned int bx, unsigned int by, unsigned int bz,                  \
      unsigned int shmem, CUstream stream, void** params, void** extra
#define TS_COOP_PARAMS                                                    \
  CUfunction f, unsigned int gx, unsigned int gy, unsigned int gz,        \
      unsigned int bx, unsigned int by, unsigned int bz,                  \
      unsigned int shmem, CUstream stream, void** params
#define TS_LAUNCH_ARGS (f, gx, gy, gz, bx, by, bz, shmem, stream, params, extra)
#define TS_COOP_ARGS (f, gx, gy, gz, bx, by, bz, shmem, stream, params)
TS_GATED(Kind::kLaunch, cuLaunchKernel, (TS_LAUNCH_PARAMS), TS_LAUNCH_ARGS,
         stream, false)
TS_GATED(Kind::kLaunch, cuLaunchKernel_ptsz, (TS_LAUNCH_PARAMS),
         TS_LAUNCH_ARGS, stream, true)
TS_GATED(Kind::kLaunch, cuLaunchKernelEx,
         (const CUlaunchConfig* config, CUfunction f, void** params,
          void** extra),
         (config, f, params, extra),
         config != nullptr ? config->hStream : nullptr, false)
TS_GATED(Kind::kLaunch, cuLaunchKernelEx_ptsz,
         (const CUlaunchConfig* config, CUfunction f, void** params,
          void** extra),
         (config, f, params, extra),
         config != nullptr ? config->hStream : nullptr, true)
TS_GATED(Kind::kLaunch, cuLaunchCooperativeKernel, (TS_COOP_PARAMS),
         TS_COOP_ARGS, stream, false)
TS_GATED(Kind::kLaunch, cuLaunchCooperativeKernel_ptsz, (TS_COOP_PARAMS),
         TS_COOP_ARGS, stream, true)
TS_GATED(Kind::kLaunch, cuGraphLaunch, (CUgraphExec exec, CUstream stream),
         (exec, stream), stream, false)
TS_GATED(Kind::kLaunch, cuGraphLaunch_ptsz,
         (CUgraphExec exec, CUstream stream), (exec, stream), stream, true)

#define TS_DD_PARAMS (CUdeviceptr dst, CUdeviceptr src, size_t n)
#define TS_DD_ASYNC (CUdeviceptr dst, CUdeviceptr src, size_t n, CUstream stream)
// cuMemcpy and cuMemcpyAsync take unified addresses in either direction.
TS_GATED(Kind::kCopy, cuMemcpy, TS_DD_PARAMS, (dst, src, n), nullptr, false)
TS_GATED(Kind::kCopy, cuMemcpy_ptds, TS_DD_PARAMS, (dst, src, n), nullptr,
         true)
TS_GATED(Kind::kCopy, cuMemcpyAsync, TS_DD_ASYNC, (dst, src, n, stream),
         stream, false)
TS_GATED(Kind::kCopy, cuMemcpyAsync_ptsz, TS_DD_ASYNC, (dst, src, n, stream),
         stream, true)
TS_GATED(Kind::kCopy, cuMemcpyHtoD_v2,
         (CUdeviceptr dst, const void* src, size_t n), (dst, src, n), nullptr,
         false)
TS_GATED(Kind::kCopy, cuMemcpyHtoD_v2_ptds,
         (CUdeviceptr dst, const void* src, size_t n), (dst, src, n), nullptr,
         true)
TS_GATED(Kind::kCopy, cuMemcpyDtoH_v2, (void* dst, CUdeviceptr src, size_t n),
         (dst, src, n), nullptr, false)
TS_GATED(Kind::kCopy, cuMemcpyDtoH_v2_ptds,
         (void* dst, CUdeviceptr src, size_t n), (dst, src, n), nullptr, true)
TS_GATED(Kind::kDevCopy, cuMemcpyDtoD_v2, TS_DD_PARAMS, (dst, src, n),
         nullptr, false)
TS_GATED(Kind::kDevCopy, cuMemcpyDtoD_v2_ptds, TS_DD_PARAMS, (dst, src, n),
         nullptr, true)
TS_GATED(Kind::kCopy, cuMemcpyHtoDAsync_v2,
         (CUdeviceptr dst, const void* src, size_t n, CUstream stream),
         (dst, src, n, stream), stream, false)
TS_GATED(Kind::kCopy, cuMemcpyHtoDAsync_v2_ptsz,
         (CUdeviceptr dst, const void* src, size_t n, CUstream stream),
         (dst, src, n, stream), stream, true)
TS_GATED(Kind::kCopy, cuMemcpyDtoHAsync_v2,
         (void* dst, CUdeviceptr src, size_t n, CUstream stream),
         (dst, src, n, stream), stream, false)
TS_GATED(Kind::kCopy, cuMemcpyDtoHAsync_v2_ptsz,
         (void* dst, CUdeviceptr src, size_t n, CUstream stream),
         (dst, src, n, stream), stream, true)
TS_GATED(Kind::kDevCopy, cuMemcpyDtoDAsync_v2, TS_DD_ASYNC,
         (dst, src, n, stream), stream, false)
TS_GATED(Kind::kDevCopy, cuMemcpyDtoDAsync_v2_ptsz, TS_DD_ASYNC,
         (dst, src, n, stream), stream, true)
TS_GATED(Kind::kCopy, cuMemcpy2D_v2, (const CUDA_MEMCPY2D* copy), (copy),
         nullptr, false)
TS_GATED(Kind::kCopy, cuMemcpy2D_v2_ptds, (const CUDA_MEMCPY2D* copy), (copy),
         nullptr, true)
TS_GATED(Kind::kCopy, cuMemcpy2DAsync_v2,
         (const CUDA_MEMCPY2D* copy, CUstream stream), (copy, stream), stream,
         false)
TS_GATED(Kind::kCopy, cuMemcpy2DAsync_v2_ptsz,
         (const CUDA_MEMCPY2D* copy, CUstream stream), (copy, stream), stream,
         true)
TS_GATED(Kind::kCopy, cuMemcpy3D_v2, (const CUDA_MEMCPY3D* copy), (copy),
         nullptr, false)
TS_GATED(Kind::kCopy, cuMemcpy3D_v2_ptds, (const CUDA_MEMCPY3D* copy), (copy),
         nullptr, true)
TS_GATED(Kind::kCopy, cuMemcpy3DAsync_v2,
         (const CUDA_MEMCPY3D* copy, CUstream stream), (copy, stream), stream,
         false)
TS_GATED(Kind::kCopy, cuMemcpy3DAsync_v2_ptsz,
         (const CUDA_MEMCPY3D* copy, CUstream stream), (copy, stream), stream,
         true)

#define TS_MEMSET(bits, type)                                              \
  TS_GATED(Kind::kMemset, cuMemsetD##bits##_v2,                            \
           (CUdeviceptr dst, type v, size_t n), (dst, v, n), nullptr, false) \
  TS_GATED(Kind::kMemset, cuMemsetD##bits##_v2_ptds,                       \
           (CUdeviceptr dst, type v, size_t n), (dst, v, n), nullptr, true)  \
  TS_GATED(Kind::kMemset, cuMemsetD##bits##Async,                          \
           (CUdeviceptr dst, type v, size_t n, CUstream stream),           \
           (dst, v, n, stream), stream, false)                             \
  TS_GATED(Kind::kMemset, cuMemsetD##bits##Async_ptsz,                     \
           (CUdeviceptr dst, type v, size_t n, CUstream stream),           \
           (dst, v, n, stream), stream, true)
TS_MEMSET(8, unsigned char)
TS_MEMSET(16, unsigned short)
TS_MEMSET(32, unsigned int)

// Capacity less the reserve, so tenants leave room for one another's
// contexts (≙ the cuMemGetInfo lie, hook.c:45,740-741; src/hook.cpp
// hook_memory_stats).
CUresult cuMemGetInfo_v2(size_t* free_bytes, size_t* total_bytes) {
  TS_REAL_OR_FAIL(cuMemGetInfo_v2);
  CUresult r = TS_REAL(cuMemGetInfo_v2)(free_bytes, total_bytes);
  if (r != CUDA_SUCCESS || free_bytes == nullptr || total_bytes == nullptr)
    return r;
  const size_t reserve = static_cast<size_t>(reserve_bytes());
  const size_t total = *total_bytes;
  *total_bytes = std::max(total > reserve ? total - reserve : 0, total / 16);
  *free_bytes = std::min(*free_bytes > reserve ? *free_bytes - reserve : 0,
                         *total_bytes);
  return r;
}

// Allocation is counted and capped, not serialized (≙ hook.c:646-682).
CUresult cuMemAlloc_v2(CUdeviceptr* dptr, size_t bytes) {
  TS_REAL_OR_FAIL(cuMemAlloc_v2);
  if (CUresult e = refuse_if_over(static_cast<int64_t>(bytes))) return e;
  CUresult r = TS_REAL(cuMemAlloc_v2)(dptr, bytes);
  if (r == CUDA_SUCCESS) track_alloc(*dptr, static_cast<int64_t>(bytes));
  return r;
}

CUresult cuMemAllocPitch_v2(CUdeviceptr* dptr, size_t* pitch, size_t width,
                            size_t height, unsigned int elem_bytes) {
  TS_REAL_OR_FAIL(cuMemAllocPitch_v2);
  if (CUresult e = refuse_if_over(static_cast<int64_t>(width * height)))
    return e;
  CUresult r =
      TS_REAL(cuMemAllocPitch_v2)(dptr, pitch, width, height, elem_bytes);
  if (r == CUDA_SUCCESS)
    track_alloc(*dptr, static_cast<int64_t>(*pitch * height));
  return r;
}

CUresult cuMemFree_v2(CUdeviceptr dptr) {
  TS_REAL_OR_FAIL(cuMemFree_v2);
  CUresult r = TS_REAL(cuMemFree_v2)(dptr);
  if (r == CUDA_SUCCESS) untrack_alloc(dptr);
  return r;
}

CUresult cuMemAllocAsync(CUdeviceptr*, size_t, CUstream) {
  return refuse_untracked("cuMemAllocAsync");
}
CUresult cuMemAllocAsync_ptsz(CUdeviceptr*, size_t, CUstream) {
  return refuse_untracked("cuMemAllocAsync");
}
CUresult cuMemAllocFromPoolAsync(CUdeviceptr*, size_t, CUmemoryPool,
                                 CUstream) {
  return refuse_untracked("cuMemAllocFromPoolAsync");
}
CUresult cuMemAllocFromPoolAsync_ptsz(CUdeviceptr*, size_t, CUmemoryPool,
                                      CUstream) {
  return refuse_untracked("cuMemAllocFromPoolAsync");
}
CUresult cuMemCreate(CUmemGenericAllocationHandle*, size_t,
                     const CUmemAllocationProp*, unsigned long long) {
  return refuse_untracked("cuMemCreate");
}
CUresult cuMemAllocManaged(CUdeviceptr*, size_t, unsigned int) {
  return refuse_untracked("cuMemAllocManaged");
}

// A destroyed stream leaves the fence's set before its handle can be
// reused.
static void forget_stream(CUstream stream) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (g_touched == nullptr) return;
  g_touched->erase(stream);
  auto it = g_pending->find(stream);
  if (it != g_pending->end()) {
    g_free_events->push_back(it->second.ev);
    g_pending->erase(it);
  }
}

CUresult cuStreamDestroy(CUstream stream) {
  TS_REAL_OR_FAIL(cuStreamDestroy);
  forget_stream(stream);
  return TS_REAL(cuStreamDestroy)(stream);
}

CUresult cuStreamDestroy_v2(CUstream stream) {
  TS_REAL_OR_FAIL(cuStreamDestroy_v2);
  forget_stream(stream);
  return TS_REAL(cuStreamDestroy_v2)(stream);
}

}  // extern "C"

namespace {

void fill_wrappers() {
#define TS_WRAP(name) g_wrappers[k_##name] = reinterpret_cast<void*>(&::name);
  TS_WRAPPED(TS_WRAP)
#undef TS_WRAP
}

}  // namespace
