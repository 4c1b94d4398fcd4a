"""Virtual device memory — software paging for CUDA device memory.

The port of ``nvshare_tpu/vmem.py``:

  * every managed array (:class:`VArray`) has a host shadow (pinned host
    memory on a CUDA arena, a plain CPU tensor on a CPU arena) and an
    optional device copy;
  * an arena (:class:`VirtualHBM`) tracks residency against a *budget* =
    the card's memory (``torch.cuda.mem_get_info``) minus a reserve
    (``$TPUSHARE_RESERVE_BYTES``, default 1536 MiB), or
    ``$TPUSHARE_HBM_BYTES`` on a CPU arena;
  * computations run through :func:`vop`, which pages operands in
    (evicting least-recently-used arrays as needed), runs the function
    under the device lock, and tracks its outputs; operands and outputs
    may be nested dicts, lists and tuples (a parameter tree, a KV cache);
  * on lock hand-off the whole resident set is fenced and evicted
    (DROP_LOCK) and bulk-prefetched back on LOCK_OK;
  * :func:`mem_info` reports the virtual capacity, not the physical one;
  * a proactive pager (:mod:`nvshare_tpu_torch.pager`) may take over the
    policy half of the handoff hooks: background writeback, on-deck
    prefetch and, with ``$TPUSHARE_PAGER_FIRST_TOUCH=1``, map-on-fault
    page-in and chunk-granular dirty tracking;
  * serving-phase hints: while the tenant decodes, arrays tagged ``"kv"``
    are evicted last under pressure, and arrays tagged ``"act"`` leave the
    hot set at the handoff.

Differences from the JAX arena, all forced by eager PyTorch:

  * Completion is tracked with CUDA events recorded after each submission
    (the JAX arena awaits its output arrays); :meth:`VirtualHBM.fence`
    synchronizes them, under the same adaptive window.
  * PyTorch has no buffer donation. A donated operand is *consumed*: the
    function may update it in place and return it, and :func:`vop`
    returns the donated bytes to the arena's accounting before it adopts
    the outputs. A function must not update an operand it does not
    donate.
  * Output bytes are reserved from shapes by running the function once on
    ``meta`` tensors (PyTorch has no ``eval_shape``).
  * Page-outs are pipelined: every device-to-host copy into the array's
    pinned shadow (allocated on its first page-out) is issued, then one
    event is synchronized.
  * Buffers are not immutable: a donated operand may be updated in place
    on the device. Each output therefore carries the event of the
    submission that produced it (``VArray._ready``), and the pager's side
    streams wait on it before they copy; what a side stream copies is
    published only if the array is still the same live, dirty one once
    the copy has finished.
"""

from __future__ import annotations

import threading
import time
import types
import weakref
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from nvshare_tpu_torch import telemetry
from nvshare_tpu_torch.device import DeviceLike, generator, resolve_device
from nvshare_tpu_torch.telemetry import events as tev
from nvshare_tpu_torch.utils import env_bool, env_bytes, env_int, get_logger

log = get_logger("vmem")


def _debug_counters() -> bool:
    """$TPUSHARE_DEBUG_COUNTERS=1 arms the counter-invariant assertions
    on the paging paths (read per-call so tests can toggle it)."""
    return env_bool("TPUSHARE_DEBUG_COUNTERS")


def first_touch_enabled() -> bool:
    """$TPUSHARE_PAGER_FIRST_TOUCH=1 switches arenas (and the pager, which
    rides the arena's flag) to first-touch residency: map-on-fault page-in
    and chunk-granular dirty bits. The single definition —
    :mod:`nvshare_tpu_torch.pager` re-exports it."""
    return env_bool("TPUSHARE_PAGER_FIRST_TOUCH", False)


#: compat key in the legacy ``stats`` view -> registry counter metadata
#: (the JAX arena's names, so one tool reads both packages).
_STAT_METRICS = {
    "page_in": ("tpushare_page_faults_total",
                "demand page-ins of managed arrays (host->device)"),
    "page_out": ("tpushare_page_outs_total",
                 "dirty writebacks of managed arrays (device->host)"),
    "evictions": ("tpushare_evictions_total",
                  "device copies dropped (LRU pressure or handoff)"),
    "handoff_evicts": ("tpushare_handoff_evictions_total",
                       "arrays evicted by DROP_LOCK handoffs"),
    "prefetches": ("tpushare_prefetches_total",
                   "arrays bulk-prefetched on LOCK_OK"),
    "oom_refusals": ("tpushare_oom_refusals_total",
                     "strict-oversubscription allocation refusals"),
}

_DEFAULT_PAGER_CHUNK = 4 << 20  # first-touch dirty-bit granularity

_arena_names = threading.Lock()  # guards the name bookkeeping
# Labels ever handed out. Process-lifetime on purpose: a NEW arena
# re-using a dead arena's label would inherit its counter children.
_used_names: set = set()
# Live arenas, read at scrape time by the residency-gauge collector.
_live_arenas: "weakref.WeakSet[VirtualHBM]" = weakref.WeakSet()


def _collect_arena_gauges() -> None:
    # Never raise: a collector that raises gets dropped by
    # Registry.collect for the life of the registry, while
    # _ensure_gauge_collector's installed flag would still read True —
    # the residency gauges would silently vanish. Swallow and log so a
    # transient failure self-heals on the next scrape.
    try:
        _collect_arena_gauges_inner()
    except Exception:
        log.debug("arena gauge collection failed this scrape",
                  exc_info=True)


def _collect_arena_gauges_inner() -> None:
    reg = telemetry.registry()
    resident = reg.gauge("tpushare_resident_bytes",
                         "bytes of managed arrays resident on device",
                         ["client"])
    tracked = reg.gauge("tpushare_tracked_bytes",
                        "bytes of managed arrays tracked by the arena",
                        ["client"])
    budget = reg.gauge("tpushare_budget_bytes",
                       "virtual HBM capacity the arena enforces",
                       ["client"])
    # Snapshot the WeakSet defensively: concurrent arena construction or
    # a GC-driven weakref callback can mutate it mid-iteration.
    for _ in range(4):
        try:
            arenas = list(_live_arenas)
            break
        except RuntimeError:
            continue
    else:
        return  # churn storm; gauges refresh on the next scrape
    for a in arenas:
        try:
            resident.labels(client=a.name).set(a.resident_bytes)
            tracked.labels(client=a.name).set(a.tracked_bytes)
            budget.labels(client=a.name).set(a.budget)
        except AttributeError:
            continue  # arena mid-construction; next scrape sees it whole
    # Prune series whose arena is gone: a closed tenant's gauges drop out
    # of the exposition instead of freezing at their last value.
    live = {a.name for a in arenas}
    for fam in (resident, tracked, budget):
        for key, _ in fam.samples():
            if key and key[0] not in live:
                fam.remove(*key)


def _ensure_gauge_collector() -> None:
    # Re-armed per registry instance so reset_registry() in tests does not
    # silently lose the residency gauges.
    reg = telemetry.registry()
    if getattr(reg, "_vmem_collector_installed", False):
        return
    reg._vmem_collector_installed = True
    reg.add_collector(_collect_arena_gauges)


_DEFAULT_HBM_BYTES = 16 << 30          # CPU arenas without $TPUSHARE_HBM_BYTES
_DEFAULT_RESERVE_BYTES = 1536 << 20    # ≙ MEMINFO_RESERVE_MIB, hook.c:45

# Adaptive pending-execution window (≙ hook.c:46-48).
_WINDOW_MIN = 1
_WINDOW_MAX = 256
_SYNC_SLOW_S = 10.0   # ≙ NVSHARE_*_THRESHOLD 10 s: collapse window to 1
_SYNC_BUSY_S = 1.0    # ≙ 1 s: halve window


class TpuShareOOM(MemoryError):
    """Raised when the strict (reference-parity) oversubscription policy is
    enabled and a process exceeds the virtual capacity by itself."""


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _nbytes(shape, dtype: torch.dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * _itemsize(dtype)


def _torch_dtype(dtype) -> Optional[torch.dtype]:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


class PhysicalPool:
    """Shared physical-capacity model for several in-process tenants on one
    device: a tenant paging its working set in can evict another tenant's
    cold arrays. All pooled arenas share ONE lock (``self.lock``), which
    makes cross-arena eviction safe without inter-arena lock ordering."""

    def __init__(self, capacity_bytes: int):
        self.capacity = int(capacity_bytes)
        self.lock = threading.RLock()
        self.arenas: list["VirtualHBM"] = []
        self.clock = 0

    def resident_bytes(self) -> int:
        return sum(a.resident_bytes for a in self.arenas)


class VArray:
    """A managed array: host shadow + optional device copy.

    Not a tensor subclass on purpose — the device copy is *revocable*.
    Operands of :func:`vop` functions are paged in automatically
    (:meth:`pinned` holds one in place outside an op); :meth:`numpy` reads
    results.
    """

    __slots__ = ("_arena", "shape", "dtype", "nbytes", "_dev", "_host",
                 "_dirty", "_dirty_chunks", "_last_touch", "_pin", "_acct",
                 "_phase_hint", "_ready", "_in_ev", "__weakref__")

    def __init__(self, arena: "VirtualHBM", host: Optional[torch.Tensor],
                 dev: Optional[torch.Tensor], dirty: bool):
        self._arena = arena
        src = dev if dev is not None else host
        self.shape = tuple(src.shape)
        self.dtype = src.dtype
        self.nbytes = src.numel() * src.element_size()
        self._host = host
        self._dev = dev
        self._dirty = dirty          # device copy newer than host shadow
        # First-touch mode only: WHICH chunks differ from the host shadow
        # (None = whole-array dirty tracking). Set by VirtualHBM._adopt and
        # drained chunk by chunk by the pager's writeback streams.
        self._dirty_chunks: Optional[set] = None
        self._last_touch = 0
        # Serving-phase residency hint (None = untagged): "kv" is evicted
        # last while the tenant decodes, "act" leaves the hot set at the
        # handoff (see VirtualHBM.set_phase).
        self._phase_hint: Optional[str] = None
        # CUDA event of the submission that produced the device copy (None
        # for a copy paged in from the host shadow): the pager's readiness
        # test, and what a side stream waits on before it reads the copy.
        self._ready = None
        # CUDA event of the last page-in from the host shadow: a side
        # stream writing into the shadow waits on it.
        self._in_ev = None
        self._pin = 0                # >0 while an op is using the device copy
        # Shared with the GC finalizer (which cannot touch the dead VArray):
        # tracks whether this array still occupies device residency.
        self._acct = {"resident": dev is not None, "live": True}

    @property
    def resident(self) -> bool:
        return self._dev is not None

    @property
    def phase_hint(self) -> Optional[str]:
        """The serving-phase residency tag (``None``/``"kv"``/``"act"``)."""
        return self._phase_hint

    @phase_hint.setter
    def phase_hint(self, hint: Optional[str]) -> None:
        if hint not in (None, "kv", "act"):
            raise ValueError(
                f"phase_hint must be None, 'kv' or 'act' (got {hint!r})")
        self._phase_hint = hint

    def pinned(self):
        """Context manager: page in and hold a pin so LRU pressure cannot
        evict this array while the block runs (a scheduler hand-off still
        evicts it)."""
        return _Pinned(self)

    def host(self) -> torch.Tensor:
        """The host shadow holding the current value (fences the device if
        dirty). Shared, not copied: do not write into it."""
        self._arena._raise_pager_error()
        with self._arena._lock:
            if self._dev is not None and self._dirty:
                self._arena._writeback(self)
            return self._host

    def numpy(self) -> np.ndarray:
        """Host copy of the current value as numpy (bfloat16, which numpy
        lacks, is widened to float32)."""
        h = self.host()
        if h.dtype == torch.bfloat16:
            return h.float().numpy()
        return h.numpy()

    def delete(self) -> None:
        self._arena._discard(self)

    def __repr__(self):
        where = "dev" if self.resident else "host"
        return (f"VArray({self.shape}, {self.dtype}, "
                f"{self.nbytes >> 20} MiB, {where})")


class _Pinned:
    def __init__(self, va: VArray):
        self.va = va

    def __enter__(self) -> torch.Tensor:
        with self.va._arena._lock:
            self.va._arena.ensure([self.va])
            self.va._pin += 1
        return self.va._dev

    def __exit__(self, *exc):
        with self.va._arena._lock:
            self.va._pin -= 1


class VirtualHBM:
    """Residency manager for one device. Process-global singleton via
    :func:`arena`; in-process tenants each own one."""

    def __init__(self, device: DeviceLike = None,
                 budget_bytes: Optional[int] = None,
                 pool: Optional[PhysicalPool] = None,
                 name: Optional[str] = None):
        self.device = resolve_device(device)
        if name is None:
            from nvshare_tpu_torch.runtime.protocol import default_job_name

            name = default_job_name()
        with _arena_names:
            if name in _used_names:  # labels must never alias tenants
                i = 2
                while f"{name}-{i}" in _used_names:
                    i += 1
                name = f"{name}-{i}"
            _used_names.add(name)
            self.name = name
            _live_arenas.add(self)
        self.pool = pool
        if pool is not None:
            self._lock = pool.lock  # pool-wide serialization
            pool.arenas.append(self)
        else:
            self._lock = threading.RLock()
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            physical = torch.cuda.mem_get_info(self.device)[1]
        else:
            physical = env_bytes("TPUSHARE_HBM_BYTES", _DEFAULT_HBM_BYTES)
        reserve = env_bytes("TPUSHARE_RESERVE_BYTES", _DEFAULT_RESERVE_BYTES)
        if budget_bytes is None:
            budget_bytes = max(physical - reserve, physical // 16)
        self.physical = int(physical)
        self.budget = int(budget_bytes)
        self.single_oversub_ok = env_bool("TPUSHARE_ENABLE_SINGLE_OVERSUB",
                                          True)
        # First-touch paging ($TPUSHARE_PAGER_FIRST_TOUCH=1): residency is
        # map-on-fault and dirtiness is tracked per chunk of
        # $TPUSHARE_PAGER_CHUNK_BYTES, which the pager's streams drain
        # while the tenant computes. Off, _dirty_chunks stays None.
        self.first_touch = first_touch_enabled()
        self.chunk_bytes = max(
            1 << 16, env_bytes("TPUSHARE_PAGER_CHUNK_BYTES",
                               _DEFAULT_PAGER_CHUNK))

        self._live: "weakref.WeakSet[VArray]" = weakref.WeakSet()
        self._clock = 0
        self.resident_bytes = 0
        self.tracked_bytes = 0
        self._pending: list[Any] = []     # CUDA events of un-fenced work
        self._busy_depth = 0              # threads inside a vop right now
        self._hot: list[weakref.ref] = []  # evicted-at-handoff set
        self._handoff_seq = 0
        reg = telemetry.registry()
        self._m = {key: reg.counter(mname, mhelp, ["client"])
                   .labels(client=self.name)
                   for key, (mname, mhelp) in _STAT_METRICS.items()}
        self._m_bytes_out = reg.counter(
            "tpushare_page_out_bytes_total",
            "bytes actually moved device->host by writebacks "
            "(dirty-chunk granular under first-touch paging; whole "
            "arrays otherwise)",
            ["client"]).labels(client=self.name)
        self._m_handoff_s = reg.histogram(
            "tpushare_handoff_seconds",
            "DROP_LOCK handoff latency: fence + whole-working-set evict",
            ["client"]).labels(client=self.name)
        self._m_clean_ratio = reg.gauge(
            "tpushare_clean_at_handoff_ratio",
            "fraction of the resident set already clean when the last "
            "handoff evicted it (1.0 = the async writeback trickle fully "
            "converged; ~0 on the synchronous path)",
            ["client"]).labels(client=self.name)
        # Proactive pager (nvshare_tpu_torch.pager): when attached it takes
        # over the POLICY half of the handoff hooks (prefetch_hot delegates
        # to its plan, _touch feeds its ordering policy); the MECHANISM
        # (writeback, evict, ensure and their accounting) stays here.
        self.pager = None
        # Tenant serving phase (None until set_phase): only consulted when
        # set, so phase-less tenants keep every eviction order unchanged.
        self.phase: Optional[str] = None
        _ensure_gauge_collector()
        telemetry.maybe_start_from_env()

        win = env_int("TPUSHARE_WINDOW_MAX", _WINDOW_MAX)
        self._window_max = max(win, _WINDOW_MIN)
        self._window = _WINDOW_MIN
        self._since_sync = 0

    # -- allocation -------------------------------------------------------

    def _new_host(self, shape, dtype: torch.dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self.cuda)

    def array(self, value, dtype=None) -> VArray:
        """Adopt ``value`` (numpy array, tensor or scalar) as a managed
        array, host-resident by default. The value is copied into a host
        shadow the arena owns."""
        if isinstance(value, VArray):
            return value
        if isinstance(value, torch.Tensor):
            src = value.detach().to("cpu")
        else:
            src = torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
        dt = _torch_dtype(dtype)
        if dt is not None:
            src = src.to(dt)
        host = self._new_host(src.shape, src.dtype)
        host.copy_(src)
        with self._lock:
            self._check_capacity(host.numel() * host.element_size())
            va = VArray(self, host, None, dirty=False)
            self._adopt(va)
        return va

    def device_array(self, shape, dtype, seed: int = 0) -> VArray:
        """Allocate a managed array generated ON the device (uniform random
        from a generator seeded with ``seed``; integers in [0, 128)). The
        host shadow materializes lazily on first eviction. Gated and
        budgeted like any other device work. The bits differ from the JAX
        package's ``jax.random`` draw for the same seed."""
        from nvshare_tpu_torch import interpose

        dtype = _torch_dtype(dtype)
        shape = tuple(int(d) for d in shape)
        nbytes = _nbytes(shape, dtype)
        interpose.gate()
        self._raise_pager_error()
        with self._lock:
            self._busy_depth += 1
        try:
            with self._lock, interpose.critical_section():
                self._check_capacity(nbytes)
                self._evict_lru_until(nbytes)
                gen = generator(self.device, seed)
                if dtype.is_floating_point:
                    arr = torch.rand(shape, generator=gen, dtype=dtype,
                                     device=self.device)
                else:
                    arr = torch.randint(0, 128, shape, generator=gen,
                                        dtype=dtype, device=self.device)
                va = VArray(self, None, arr, dirty=True)
                self._adopt(va)
                va._ready = self._record_pending()
            self.after_submit()
            return va
        finally:
            with self._lock:
                self._busy_depth -= 1

    def _adopt(self, va: VArray) -> None:
        if self.first_touch and va._dirty:
            # A new device value differs from its (not yet made) host
            # shadow everywhere: every chunk starts dirty. This is the only
            # clean->dirty site — a donated output is a new VArray even
            # where it sits on its operand's storage, so no clean chunk of
            # the operand carries over.
            va._dirty_chunks = set(range(self._chunk_count(va)))
        self._live.add(va)
        self.tracked_bytes += va.nbytes
        if va._dev is not None:
            self.resident_bytes += va.nbytes
        self._touch(va)
        # Keep the books straight when the app drops its last reference.
        weakref.finalize(va, self._finalize_acct, va.nbytes, va._acct)

    def _finalize_acct(self, nbytes: int, acct: dict) -> None:
        with self._lock:
            if not acct.get("live"):
                return
            acct["live"] = False
            self.tracked_bytes -= nbytes
            if acct.get("resident"):
                acct["resident"] = False
                self.resident_bytes -= nbytes

    def _check_capacity(self, nbytes: int) -> None:
        if self.tracked_bytes + nbytes <= self.budget:
            return
        if not self.single_oversub_ok:
            self._m["oom_refusals"].inc()
            tev.record(tev.OOM_RETRY, self.name, nbytes=int(nbytes),
                       tracked=self.tracked_bytes, budget=self.budget,
                       reason="strict-oversub-refusal")
            raise TpuShareOOM(
                f"allocation of {nbytes} B exceeds virtual HBM capacity "
                f"({self.tracked_bytes}/{self.budget} B in use) and "
                "TPUSHARE_ENABLE_SINGLE_OVERSUB=0"
            )
        if not getattr(self, "_warned_oversub", False):  # warn once
            self._warned_oversub = True
            log.warning(
                "process working set (%.2f GiB) exceeds virtual HBM "
                "capacity (%.2f GiB) — paging engaged",
                (self.tracked_bytes + nbytes) / 2**30, self.budget / 2**30)

    def _discard(self, va: VArray) -> None:
        with self._lock:
            if va not in self._live:
                return
            self._live.discard(va)
            va._acct["live"] = False
            va._acct["resident"] = False
            self.tracked_bytes -= va.nbytes
            if va._dev is not None:
                self.resident_bytes -= va.nbytes
                va._dev = None
            # Release the shadow: a pinned block goes back to PyTorch's
            # host cache, where the next writeback of this size reuses it.
            va._host = None

    def close(self) -> None:
        """Retire this arena: fence pending work, discard every live
        array (freeing its device residency), and detach from the
        physical pool. Idempotent."""
        # Stop the proactive pager FIRST: its threads take this arena's
        # lock, and retiring the arena under a live trickle would race the
        # discard loop below.
        pager = self.pager
        if pager is not None:
            pager.close()
        # Fence BEFORE taking the (possibly pool-shared) lock, so a slow
        # device stalls only this tenant.
        self.fence()
        _live_arenas.discard(self)  # stop exporting this arena's gauges
        with self._lock:
            for va in list(self._live):
                self._discard(va)
            self._hot.clear()
            if self.pool is not None:
                try:
                    self.pool.arenas.remove(self)
                except ValueError:
                    pass  # already detached
                self.pool = None
                self._lock = threading.RLock()

    # -- residency --------------------------------------------------------

    def set_phase(self, phase: Optional[str]) -> None:
        """Declare the tenant's serving phase (``"idle"``/``"prefill"``/
        ``"decode"``/None). While decoding, KV-class arrays (tagged or
        detected by the wss policy) are evicted last under LRU pressure:
        the cache is read by every token, so paging it out mid-decode
        costs a page-in on the next one."""
        if phase not in (None, "idle", "prefill", "decode"):
            raise ValueError(f"unknown phase {phase!r}")
        self.phase = phase

    def _kv_protected(self, va: VArray) -> bool:
        """Is ``va`` KV-cache-class for eviction ordering right now? Only
        mid-decode: a ``phase_hint="kv"`` tag, or the wss policy's
        cross-quantum inter-touch detection (lock held)."""
        if self.phase != "decode":
            return False
        if va._phase_hint == "kv":
            return True
        pager = self.pager
        if pager is not None:
            try:
                return bool(pager.policy.kv_resident(va))
            except Exception:  # policy bugs must not break eviction
                return False
        return False

    def _touch(self, va: VArray) -> None:
        # Pooled arenas share one recency clock so cross-tenant LRU is a
        # meaningful global ordering.
        if self.pool is not None:
            self.pool.clock += 1
            va._last_touch = self.pool.clock
        else:
            self._clock += 1
            va._last_touch = self._clock
        pager = self.pager
        if pager is not None:
            try:
                pager.policy.on_touch(va)
            except Exception:  # policy bugs must not break paging
                log.debug("pager policy on_touch failed", exc_info=True)

    def _raise_pager_error(self) -> None:
        """Fail the tenant's thread with the pager's error: a device error
        in a writeback or prefetch stops the pager, and the tenant must not
        carry on as if paging still ran."""
        pager = self.pager
        if pager is not None and pager.error is not None:
            raise RuntimeError(
                f"the proactive pager of {self.name} failed") from pager.error

    # -- first-touch chunk geometry (lock held for all of these) ----------

    def _chunk_elems(self, va: VArray) -> int:
        """Elements per dirty-bit chunk (chunk_bytes rounded down to the
        dtype's itemsize; at least one element)."""
        return max(1, self.chunk_bytes // _itemsize(va.dtype))

    def _chunk_count(self, va: VArray) -> int:
        total = va.nbytes // _itemsize(va.dtype)
        return max(0, -(-total // self._chunk_elems(va)))

    def _chunk_bounds(self, va: VArray, chunk: int) -> tuple:
        """Flat element range [lo, hi) of ``chunk``."""
        total = va.nbytes // _itemsize(va.dtype)
        per = self._chunk_elems(va)
        lo = chunk * per
        return lo, min(total, lo + per)

    def _host_flat_writable(self, va: VArray) -> torch.Tensor:
        """A flat view of the host shadow for in-place chunk publication,
        made on first use for a device-born array (every chunk is dirty
        then, so a partial write never exposes garbage). The port's
        shadows are its own contiguous tensors, always writable."""
        if va._host is None:
            va._host = self._new_host(va.shape, va.dtype)
        return va._host.view(-1)

    def _writeback_batch(self, vas: Sequence[VArray]) -> None:
        """device -> host shadows, pipelined: issue every copy first, then
        synchronize once — the handoff-latency hot path. The copies run on
        the current stream after the fence the callers take, so they follow
        the tenant's work, and after the pager's side streams.

        A dirty array moves whole, into its shadow if the pager's streams
        already made one (first-touch mode), else into a new one. The JAX
        arena does the same on every platform with a pinned-host memory
        space (its chunk-residual branch needs a platform without one), so
        under first-touch the two packages move the same bytes."""
        dirty = [va for va in vas if va._dev is not None and va._dirty]
        if not dirty:
            return
        if _debug_counters():
            seen: set = set()
            for va in dirty:
                assert id(va) not in seen, \
                    f"{va!r} listed twice in one writeback batch"
                seen.add(id(va))
        if self.cuda and self.pager is not None:
            cur = torch.cuda.current_stream(self.device)
            for s in self.pager.streams:
                cur.wait_stream(s)
        for va in dirty:
            host = va._host
            if host is None:
                host = self._new_host(va.shape, va.dtype)
            host.copy_(va._dev, non_blocking=self.cuda)
            va._host = host
        if self.cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()
        # Single counting site: page_out advances exactly on the
        # dirty->clean transition.
        for va in dirty:
            if _debug_counters():
                assert va._dirty, \
                    f"{va!r} went clean mid-writeback (double-count risk)"
            va._dirty = False
            va._dirty_chunks = None
        self._m["page_out"].inc(len(dirty))
        self._m_bytes_out.inc(sum(va.nbytes for va in dirty))

    def _writeback(self, va: VArray) -> None:
        self._writeback_batch([va])

    def _evict_batch(self, vas: Sequence[VArray]) -> None:
        self._writeback_batch(vas)
        n_evicted = 0
        bytes_evicted = 0
        for va in vas:
            if va._dev is None:
                continue
            # Dropping the last reference returns the block to PyTorch's
            # caching allocator (stream-ordered, so queued work using it
            # finishes first).
            va._dev = None
            va._acct["resident"] = False
            self.resident_bytes -= va.nbytes
            n_evicted += 1
            bytes_evicted += va.nbytes
        if n_evicted:
            self._m["evictions"].inc(n_evicted)
            tev.record(tev.EVICT, self.name, n=n_evicted,
                       bytes=bytes_evicted)
        if _debug_counters():
            self._debug_assert_accounting()

    def _evict_lru_until(self, needed: int) -> None:
        if self.resident_bytes + needed > self.budget:
            # Mid-decode, KV-class arrays sort AFTER everything else; when
            # only they remain they do evict (no OOM from protection).
            # Phase-less tenants keep the exact LRU order.
            cands = sorted(
                (va for va in self._live
                 if va._dev is not None and va._pin == 0),
                key=lambda va: (self._kv_protected(va), va._last_touch))
            victims, freed = [], 0
            over = self.resident_bytes + needed - self.budget
            for va in cands:
                if freed >= over:
                    break
                victims.append(va)
                freed += va.nbytes
            self._evict_batch(victims)
            if self.resident_bytes + needed > self.budget:
                # The pinned working set alone exceeds the budget: a single
                # op whose operands exceed capacity, which no paging scheme
                # can split.
                log.warning(
                    "op working set %.2f GiB exceeds virtual capacity "
                    "%.2f GiB",
                    (self.resident_bytes + needed) / 2**30,
                    self.budget / 2**30)
        self._evict_pool_until(needed)

    def _evict_pool_until(self, needed: int) -> None:
        """Physical-pool pressure: evict the pool-wide coldest arrays (any
        tenant's) until ``needed`` more bytes fit in the shared capacity."""
        if self.pool is None:
            return
        over = self.pool.resident_bytes() + needed - self.pool.capacity
        if over <= 0:
            return
        cands = sorted(
            ((va, a) for a in self.pool.arenas for va in a._live
             if va._dev is not None and va._pin == 0),
            key=lambda p: (p[1]._kv_protected(p[0]), p[0]._last_touch))
        by_owner: dict = {}
        freed = 0
        for va, owner in cands:
            if freed >= over:
                break
            by_owner.setdefault(id(owner), (owner, []))[1].append(va)
            freed += va.nbytes
        for owner, victims in by_owner.values():
            owner._evict_batch(victims)

    def ensure(self, vas: Sequence[VArray], extra_bytes: int = 0) -> None:
        """Page in ``vas`` (and reserve ``extra_bytes`` for outputs)."""
        with self._lock:
            need = extra_bytes + sum(
                va.nbytes for va in vas if va._dev is None)
            for va in vas:
                va._pin += 1
            try:
                self._evict_lru_until(need)
                faulted = []
                for va in vas:
                    if va._dev is None:
                        if self.cuda:
                            va._dev = va._host.to(self.device,
                                                  non_blocking=True)
                        else:
                            va._dev = va._host.clone()
                        va._ready = None
                        va._acct["resident"] = True
                        self.resident_bytes += va.nbytes
                        faulted.append(va)
                    self._touch(va)
                if faulted:
                    if self.cuda:
                        ev = torch.cuda.Event()
                        ev.record(torch.cuda.current_stream(self.device))
                        for va in faulted:
                            va._in_ev = ev
                    self._m["page_in"].inc(len(faulted))
                    tev.record(tev.FAULT, self.name, n=len(faulted),
                               bytes=sum(va.nbytes for va in faulted))
            finally:
                for va in vas:
                    va._pin -= 1

    # -- execution --------------------------------------------------------

    def _record_pending(self):
        """Record completion of the work just submitted (lock held); returns
        the CUDA event (None on a CPU arena)."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._pending.append(ev)
        return ev

    def note_outputs(self, outs: Sequence[torch.Tensor], ready=None) -> list:
        """Adopt computed outputs as device-resident dirty VArrays;
        ``ready`` is the event recorded after the work that produced
        them."""
        wrapped = []
        with self._lock:
            for o in outs:
                va = VArray(self, None, o, dirty=True)
                self._check_capacity(va.nbytes)
                self._adopt(va)
                va._ready = ready
                wrapped.append(va)
        return wrapped

    def fence(self) -> float:
        """Block until all un-fenced submitted work completes; returns the
        wait in seconds (the control signal for the adaptive window and for
        idle detection, ≙ timed cuCtxSynchronize, hook.c:804-832). Counts
        as busy for the idle probe while it waits."""
        with self._lock:
            pending, self._pending = self._pending, []
            if pending:
                self._busy_depth += 1
        t0 = time.perf_counter()
        try:
            for ev in pending:
                ev.synchronize()
        finally:
            if pending:
                with self._lock:
                    self._busy_depth -= 1
        return time.perf_counter() - t0

    def after_submit(self) -> None:
        """Adaptive pending-window bookkeeping; call once per submission."""
        with self._lock:
            self._since_sync += 1
            due = self._since_sync >= self._window
        if not due:
            return
        sync_s = self.fence()
        with self._lock:
            self._since_sync = 0
            if sync_s >= _SYNC_SLOW_S:
                self._window = _WINDOW_MIN
            elif sync_s >= _SYNC_BUSY_S:
                self._window = max(self._window // 2, _WINDOW_MIN)
            else:
                self._window = min(self._window * 2, self._window_max)
        # Observed step latency feeds the pager's writeback rate limiter.
        pager = self.pager
        if pager is not None:
            try:
                pager.note_step_latency(sync_s)
            except Exception:  # pager bugs must not break submission
                log.debug("pager step-latency hook failed", exc_info=True)
        self._raise_pager_error()

    # -- lock hand-off hooks (wired to the client runtime) ----------------

    def sync_and_evict_all(self) -> None:
        """DROP_LOCK path: fence everything, then page the whole resident
        set out so the next tenant gets clean device memory. Runs on the
        client's message thread; the fence orders it after the tenant's
        submitted work."""
        t0 = time.perf_counter()
        self.fence()
        with self._lock:
            pager = self.pager
            if pager is not None:
                # The pager issues its side-stream copies under this lock,
                # so every one is on its streams now: wait for them before
                # any device memory goes back to the allocator.
                pager.quiesce()
            resident = [va for va in self._live if va._dev is not None]
            # Prefill activations (tagged "act") are consumed by this
            # handoff: they leave the hot set, so the next grant never
            # pages dead activations back in.
            self._hot = [weakref.ref(va) for va in resident
                         if va._phase_hint != "act"]
            handoff_bytes = sum(va.nbytes for va in resident)
            moved_before = int(self._m_bytes_out.value)
            clean_n = sum(1 for va in resident if not va._dirty)
            self._evict_batch(resident)  # pipelined writebacks
            moved = int(self._m_bytes_out.value) - moved_before
            self._m["handoff_evicts"].inc(len(resident))
            self._handoff_seq += 1
            hseq = self._handoff_seq
        dt = time.perf_counter() - t0
        self._m_handoff_s.observe(dt)
        if resident:
            self._m_clean_ratio.set(clean_n / len(resident))
        tev.record(tev.HANDOFF, self.name, n=len(resident),
                   bytes=handoff_bytes, clean=clean_n, moved=moved,
                   seconds=round(dt, 6), hseq=hseq)
        log.debug("handoff eviction done (%d arrays, %d clean)",
                  len(self._hot), clean_n)

    def prefetch_hot(self) -> None:
        """LOCK_OK path: bulk-page the last working set back in (with a
        proactive pager attached: its planned, chunked prefetch)."""
        pager = self.pager
        if pager is not None:
            pager.prefetch_on_grant()
            return
        with self._lock:
            hot = [r() for r in self._hot]
            self._hot = []
        vas = [va for va in hot if va is not None and va._acct["live"]]
        if vas:
            # Re-page largest-first within budget; later ops fix the rest.
            vas.sort(key=lambda va: -va.nbytes)
            take, acc = [], 0
            for va in vas:
                if acc + va.nbytes > self.budget:
                    continue
                take.append(va)
                acc += va.nbytes
            self.ensure(take)
            self._m["prefetches"].inc(len(take))
            tev.record(tev.PREFETCH, self.name, n=len(take), bytes=acc)

    def timed_sync_ms(self) -> int:
        return int(self.fence() * 1000)

    def busy_probe(self) -> int:
        """1 = an op/paging is in flight right now; -1 = unknown (let the
        caller fall back to the timed-fence heuristic)."""
        return 1 if self._busy_depth > 0 else -1

    # -- reporting --------------------------------------------------------

    @property
    def stats(self) -> types.MappingProxyType:
        """Read-only view of the paging counters (legacy stats keys)."""
        return types.MappingProxyType(self.telemetry_snapshot())

    def telemetry_snapshot(self) -> dict:
        """This arena's counters as a plain dict (legacy stats keys)."""
        return {key: int(child.value) for key, child in self._m.items()}

    def _debug_assert_accounting(self) -> None:
        """$TPUSHARE_DEBUG_COUNTERS invariant: the byte counters equal the
        ground truth recomputed from the live set (lock held)."""
        resident = sum(va.nbytes for va in self._live
                       if va._dev is not None)
        assert resident == self.resident_bytes, (
            f"resident_bytes drift: counter {self.resident_bytes} vs "
            f"actual {resident}")

    def mem_info(self) -> tuple[int, int]:
        """(free, total) of the *virtual* capacity (≙ cuMemGetInfo lie)."""
        with self._lock:
            return max(self.budget - self.resident_bytes, 0), self.budget


_arena: Optional[VirtualHBM] = None
_arena_lock = threading.Lock()


def arena(device: DeviceLike = None) -> VirtualHBM:
    """The process-global arena, created on first use on ``device``
    (default ``cuda``; later calls return it whatever they pass)."""
    global _arena
    with _arena_lock:
        if _arena is None:
            _arena = VirtualHBM(device=device)
        return _arena


def reset_arena() -> None:
    """Testing hook: drop the singleton (does not free existing VArrays)."""
    global _arena
    with _arena_lock:
        _arena = None


def array(value, dtype=None) -> VArray:
    return arena().array(value, dtype=dtype)


def _tree_map(fn: Callable, tree):
    """``fn`` over the leaves of nested dicts, lists and tuples (the
    containers a parameter tree, a KV cache or a step's result is made
    of); the structure is rebuilt around the results."""
    if type(tree) is dict:
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if type(tree) in (list, tuple):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree) -> list:
    leaves: list = []
    _tree_map(leaves.append, tree)
    return leaves


def tree_array(tree, arena: Optional[VirtualHBM] = None):
    """Adopt every leaf of a tree (nested dicts, lists, tuples) as a
    managed VArray of ``arena`` (default: the process arena); VArray
    leaves stay as they are."""
    a = arena if arena is not None else _process_arena()
    return _tree_map(
        lambda leaf: leaf if isinstance(leaf, VArray) else a.array(leaf),
        tree)


def tree_numpy(tree):
    """Read every VArray leaf of a tree back to numpy (fenced)."""
    return _tree_map(
        lambda leaf: leaf.numpy() if isinstance(leaf, VArray) else leaf,
        tree)


_process_arena = arena


def mem_info() -> tuple[int, int]:
    return arena().mem_info()


def _as_meta(x):
    """A dynamic argument as the meta pass sees it: arrays become meta
    tensors of their shape, and a device names the meta device, so a
    function that creates its outputs on a device it is given (a model's
    parameters, a cache) allocates nothing in the meta pass."""
    if isinstance(x, (VArray, torch.Tensor)):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    if isinstance(x, torch.device):
        return torch.device("meta")
    return x


def _signature(tree):
    """What the output sizes of a vop function may depend on, for its
    dynamic arguments: the containers, each array's shape and dtype, and
    the type of any other leaf. As under ``jax.jit``, which traces such
    arguments, a Python scalar in a dynamic position must not set the
    shape of an output; pass it in ``static_argnums`` if it does."""
    if type(tree) is dict:
        return ("dict", tuple((k, _signature(v)) for k, v in tree.items()))
    if type(tree) in (list, tuple):
        return (type(tree).__name__, tuple(_signature(v) for v in tree))
    if isinstance(tree, (VArray, torch.Tensor)):
        return (tuple(tree.shape), tree.dtype)
    return type(tree)


def _output_leaves(out) -> list:
    leaves = _tree_leaves(out)
    bad = [type(o).__name__ for o in leaves
           if not isinstance(o, torch.Tensor)]
    if bad:
        raise TypeError("a vop function returns a tensor or nested dicts, "
                        f"lists or tuples of tensors, not {bad[0]}")
    return leaves


def vop(fn: Callable, *, static_argnums=(), donate_argnums=()) -> Callable:
    """Wrap ``fn`` so it computes over :class:`VArray` operands with paging
    and device-lock gating.

    The returned callable takes positional arguments that are VArrays,
    plain values (tensors, Python scalars, a device) or nested dicts,
    lists and tuples of them (a parameter tree, a KV cache). Every VArray
    leaf is paged in (evicting LRU arrays when over budget), ``fn`` runs on
    the device tensors under the device lock, and its result, a tensor or
    nested dicts, lists and tuples of tensors, comes back with the same
    structure of device-resident VArrays.

    ``static_argnums``: those arguments (a model config, a Python
    option) reach ``fn`` as they are, in the meta pass that sizes the
    outputs as in the real call. The meta pass runs once per signature
    (the static values, and the shapes and dtypes of the dynamic arrays;
    see :func:`_signature`), as ``jax.jit`` traces once: PyTorch runs meta
    tensors through Python reference implementations, slower than the
    real call.

    ``donate_argnums``: every VArray leaf under those positions is
    CONSUMED — ``fn`` may update it in place (and return it as an output),
    and it is discarded from the arena, so callers rebind the name:
    ``cache = step(cache)``. ``fn`` must not update an operand it does not
    donate.
    """
    static = ((static_argnums,) if isinstance(static_argnums, int)
              else tuple(static_argnums))
    donate = ((donate_argnums,) if isinstance(donate_argnums, int)
              else tuple(donate_argnums))

    sized: dict = {}  # signature -> output bytes

    def out_size(args, sset) -> int:
        try:
            key = tuple(args[i] if i in sset else _signature(args[i])
                        for i in range(len(args)))
            hash(key)
        except TypeError:  # an unhashable static argument: size each call
            key = None
        if key is None or key not in sized:
            meta_out = _output_leaves(fn(*[
                x if i in sset else _tree_map(_as_meta, x)
                for i, x in enumerate(args)]))
            nbytes = sum(o.numel() * o.element_size() for o in meta_out)
            if key is None:
                return nbytes
            if len(sized) >= 256:
                sized.clear()
            sized[key] = nbytes
        return sized[key]

    def run(*args):
        from nvshare_tpu_torch import interpose  # late: avoids import cycle

        n = len(args)
        sset = {i % n for i in static} if n else set()
        dset = {i % n for i in donate} if n else set()
        dynamic = [args[i] for i in range(n) if i not in sset]
        vas = [x for x in _tree_leaves(dynamic) if isinstance(x, VArray)]
        # Operate in the operands' arena; mixing arenas in one op would
        # corrupt both sides' residency accounting — refuse loudly.
        if vas:
            a = vas[0]._arena
            if any(v._arena is not a for v in vas):
                raise ValueError(
                    "vop operands span multiple arenas (tenants); keep "
                    "each tenant's arrays in its own arena")
        else:
            a = interpose.current_arena()
        # Output-size reservation from shapes: a run on meta tensors.
        out_bytes = out_size(args, sset)
        donated = [x for i in sorted(dset - sset)
                   for x in _tree_leaves(args[i]) if isinstance(x, VArray)]
        out_bytes = max(0, out_bytes - sum(d.nbytes for d in donated))

        interpose.gate()
        a._raise_pager_error()
        with a._lock:
            a._busy_depth += 1
        try:
            # Page-in and submission are one critical section: a DROP_LOCK
            # arriving in between must not evict the freshly paged-in
            # operands before the function has queued its work. The gate
            # itself stays OUTSIDE the lock — a blocked gate holding the
            # arena lock would deadlock the eviction callback.
            with a._lock, interpose.critical_section():
                a.ensure(vas, extra_bytes=out_bytes)
                dev_args = [
                    x if i in sset else _tree_map(
                        lambda v: v._dev if isinstance(v, VArray) else v, x)
                    for i, x in enumerate(args)]
                donated_ids = {id(d) for d in donated}
                kept = {v._dev.untyped_storage().data_ptr() for v in vas
                        if id(v) not in donated_ids}
                out_tree = fn(*dev_args)
                outs = _output_leaves(out_tree)
                del dev_args
                # Retire donated operands FIRST: their storage may now back
                # outputs, and adopting the outputs before releasing the
                # donated bytes would double-count them.
                for d in donated:
                    if d._acct["resident"]:
                        d._acct["resident"] = False
                        a.resident_bytes -= d.nbytes
                    d._dev = None
                    a._discard(d)
                # An output on a kept operand's storage (the operand itself,
                # or a view of it) gets its own copy, so two VArrays never
                # share (and double-count) one buffer.
                outs = [o.clone() if o.untyped_storage().data_ptr() in kept
                        else o for o in outs]
                wrapped = iter(a.note_outputs(outs, a._record_pending()))
                result = _tree_map(lambda _o: next(wrapped), out_tree)
                del out_tree, outs
            a.after_submit()
            return result
        finally:
            with a._lock:
                a._busy_depth -= 1

    run.__name__ = getattr(fn, "__name__", "vop")
    return run
