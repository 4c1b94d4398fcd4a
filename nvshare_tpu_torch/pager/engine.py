"""Proactive paging engine: background writeback + scheduler-coordinated
on-deck prefetch.

The port of ``nvshare_tpu/pager/engine.py``. The synchronous arena pays
all paging on the lock transitions: DROP_LOCK pays fence + write back
everything + evict, LOCK_OK a bulk page-in before the first gated op.
This engine takes over the *policy* half of
:class:`~nvshare_tpu_torch.vmem.VirtualHBM` and moves both costs off
that path:

  * a background **writeback daemon** trickles dirty resident arrays to
    their host shadows while this tenant holds the lock and computes
    (``$TPUSHARE_WRITEBACK_CHUNK_BYTES`` per
    ``$TPUSHARE_WRITEBACK_INTERVAL_S``; outputs whose producer has not
    finished and pinned operands are never touched), so a handoff mostly
    finds clean arrays and shrinks to fence + delete;
  * the scheduler's **LOCK_NEXT** advisory lets this tenant plan its
    prefetch before LOCK_OK: the policy orders the evicted hot set,
    clipped to ``$TPUSHARE_PREFETCH_BUDGET_BYTES``; on the grant only the
    first ``$TPUSHARE_PREFETCH_CHUNK_BYTES`` page in at once and the
    daemon streams the rest in behind the tenant's compute;
  * with ``$TPUSHARE_PAGER_FIRST_TOUCH=1``, a grant pages nothing in (the
    first ops fault what they touch), and ``$TPUSHARE_WRITEBACK_STREAMS``
    worker threads drain dirty arrays chunk by chunk under one token
    bucket whose rate backs off when the step latency rises;
  * the orderings are pluggable (``$TPUSHARE_PAGER_POLICY=lru|lfu|wss``,
    :mod:`nvshare_tpu_torch.pager.policy`).

On a CUDA arena every writeback copy runs on one of the pager's own CUDA
streams (one per writeback stream), after the event of the array's
producer, into the array's pinned shadow. The copies are issued under the
arena lock, and the arena's handoff waits for the streams under the same
lock before it frees any device memory. A copy's result is published only
if the array is still the same live, dirty array once the copy has
finished: a donated operand may be rewritten in place, and then its copy
is dropped. A device error in a writeback or a prefetch stops the pager
and fails the tenant's next operation; nothing falls back to the
synchronous path. Paging only re-orders and re-times transfers, so results
are identical with the pager on or off.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import weakref
from typing import Optional

import torch

from nvshare_tpu_torch import telemetry
from nvshare_tpu_torch.pager.policy import PagerPolicy, make_policy
from nvshare_tpu_torch.telemetry import events as tev
from nvshare_tpu_torch.utils import (
    env_bool,
    env_bytes,
    env_float,
    env_int,
    get_logger,
)
from nvshare_tpu_torch.vmem import first_touch_enabled  # noqa: F401

log = get_logger("pager")

_DEFAULT_WB_INTERVAL_S = 0.02
_DEFAULT_WB_CHUNK = 32 << 20       # ≈1.6 GB/s trickle ceiling at 20 ms
_DEFAULT_PF_CHUNK = 64 << 20       # synchronous slice of a grant prefetch
_DEFAULT_WB_STREAMS = 2            # first-touch writeback worker streams
_BACKOFF_MULT = 1.5                # step-latency rise that triggers backoff
_BACKOFF_FLOOR = 0.125             # rate factor never drops below this


def pager_enabled() -> bool:
    """$TPUSHARE_PAGER=1 switches the proactive engine on (default off:
    the synchronous handoff)."""
    return env_bool("TPUSHARE_PAGER", False)


class _TokenBucket:
    """Byte-rate limiter shared by every writeback stream.

    Refills at ``rate * factor`` bytes/second where ``factor`` in (0, 1]
    is the adaptive backoff knob (halved when the step latency rises,
    recovered once it settles). ``take`` blocks until the bytes are
    available or ``stop`` fires, so N streams together never exceed the
    configured rate."""

    def __init__(self, rate_bytes_s: float, burst_bytes: float):
        self.rate = max(float(rate_bytes_s), 1.0)
        self.burst = max(float(burst_bytes), 1.0)
        self.factor = 1.0
        self._tokens = self.burst
        self._t = time.monotonic()
        self._mu = threading.Lock()

    def take(self, nbytes: int, stop: threading.Event) -> bool:
        need = min(float(nbytes), self.burst)  # one chunk always fits
        while not stop.is_set():
            with self._mu:
                now = time.monotonic()
                rate = self.rate * max(self.factor, _BACKOFF_FLOOR)
                self._tokens = min(self.burst,
                                   self._tokens + (now - self._t) * rate)
                self._t = now
                if self._tokens >= need:
                    self._tokens -= need
                    return True
                wait_s = (need - self._tokens) / rate
            stop.wait(min(wait_s, 0.05))
        return False


def _ready(va) -> bool:
    """Has the submission that produced ``va``'s device copy finished?
    Never blocks (a copy paged in from the host shadow is ready)."""
    ev = va._ready
    return ev is None or ev.query()


class Pager:
    """One proactive paging engine bound to one arena (one tenant).

    Lifecycle: construct → :meth:`bind_client` (which starts the threads)
    → the client runtime drives :meth:`sync_and_evict` /
    :meth:`prefetch_on_grant` / :meth:`on_lock_next`; :meth:`close`
    stops the threads. Attaching sets ``arena.pager``.

    ``start=True`` (the default) starts the threads at once and is ONLY
    for arenas no scheduler arbitrates: with no bound client the daemon
    assumes this tenant always holds the lock. Managed wiring (interpose,
    colocate) constructs with ``start=False`` and lets :meth:`bind_client`
    start them, so no transfer runs in another tenant's quantum while the
    client is still registering.
    """

    def __init__(self, arena, policy: Optional[PagerPolicy] = None,
                 start: bool = True):
        self.arena = arena
        self.policy = policy if policy is not None else make_policy(
            os.environ.get("TPUSHARE_PAGER_POLICY", "lru"), arena.name)
        self.writeback_interval_s = env_float(
            "TPUSHARE_WRITEBACK_INTERVAL_S", _DEFAULT_WB_INTERVAL_S)
        self.writeback_chunk_bytes = env_bytes(
            "TPUSHARE_WRITEBACK_CHUNK_BYTES", _DEFAULT_WB_CHUNK)
        self.prefetch_budget_bytes = env_bytes(
            "TPUSHARE_PREFETCH_BUDGET_BYTES", 0) or arena.budget
        self.prefetch_chunk_bytes = env_bytes(
            "TPUSHARE_PREFETCH_CHUNK_BYTES", _DEFAULT_PF_CHUNK)
        self._client = None
        self._mu = threading.Lock()       # guards _plan/_bg_plan swaps
        # Plans hold WEAKREFS: a planned array the application drops
        # between advisory and grant must be collectable.
        self._plan: Optional[list] = None   # built on LOCK_NEXT
        self._bg_plan: list = []            # grant remainder, daemon-fed
        # Plan generation token: every cancellation bumps it, and the
        # daemon pages a background chunk in UNDER ``_mu`` against the
        # generation it was planned for. A DROP_LOCK landing mid-chunk
        # either bumps the token first (the stale chunk is dropped before
        # any transfer) or waits on ``_mu`` for the bounded in-flight
        # chunk, whose pages the handoff then evicts.
        self._gen = 0
        self._bg_gen = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # First-touch mode rides the ARENA's flag, so engine and mechanism
        # never disagree about chunk tracking.
        self.first_touch = bool(getattr(arena, "first_touch", False))
        self.writeback_streams = max(
            1, env_int("TPUSHARE_WRITEBACK_STREAMS", _DEFAULT_WB_STREAMS))
        # The CUDA streams the writeback copies run on: stream 0 carries
        # the daemon's whole-array trickle, stream i the i-th first-touch
        # worker. A CPU arena copies synchronously and has none.
        self.streams: list = ([torch.cuda.Stream(device=arena.device)
                               for _ in range(self.writeback_streams)]
                              if arena.cuda else [])
        # Each stream contributes one trickle ceiling (chunk bytes per
        # interval) of refill rate; the factor backs it off when the step
        # latency says compute is paying for it.
        self._bucket = _TokenBucket(
            self.writeback_streams * self.writeback_chunk_bytes
            / max(self.writeback_interval_s, 1e-3),
            2.0 * self.writeback_chunk_bytes)
        self._stream_threads: list = []
        self._claimed: set = set()   # id(va) claimed by a stream (arena lock)
        self._step_ewma: Optional[float] = None
        self._step_floor: Optional[float] = None
        # The first device error of a pager thread; the arena raises it in
        # the tenant's thread (VirtualHBM._raise_pager_error).
        self.error: Optional[BaseException] = None
        reg = telemetry.registry()
        self._m_wb = reg.counter(
            "tpushare_writeback_total",
            "async-writeback batches trickled by the pager daemon",
            ["client"]).labels(client=arena.name)
        self._m_wb_bytes = reg.counter(
            "tpushare_writeback_bytes_total",
            "bytes trickled device->host by the pager daemon",
            ["client"]).labels(client=arena.name)
        self._m_staged = reg.counter(
            "tpushare_horizon_staged_total",
            "grant-horizon advisories that produced a staged prefetch "
            "plan", ["client"]).labels(client=arena.name)
        self._m_staged_bytes = reg.counter(
            "tpushare_horizon_staged_bytes_total",
            "bytes of prefetch plan staged against the published grant "
            "horizon (depth-proportional budgets)",
            ["client"]).labels(client=arena.name)
        # Observed working-set EWMA gauge: exported only when the policy
        # computes one (the `wss` policy); the fleet streamer rides it
        # into the k=MET push as the optional wss= token.
        self._g_wss = None
        self._wss_next_s = 0.0       # next wss gauge refresh (throttle)
        if hasattr(self.policy, "wss_ewma_bytes"):
            self._g_wss = reg.gauge(
                "tpushare_wss_bytes",
                "observed working-set EWMA from the wss pager policy "
                "(rides k=MET as wss= for tighter co-admission)",
                ["client"]).labels(client=arena.name)
        arena.pager = self
        if start:
            self.start()

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._daemon_loop, daemon=True,
            name=f"tpushare-pager-{self.arena.name}")
        self._thread.start()
        if self.first_touch:
            # Sharded writeback: N workers draining dirty CHUNKS under the
            # shared token bucket (the daemon keeps the background
            # prefetch; its whole-array trickle is off).
            self._stream_threads = [
                threading.Thread(
                    target=self._stream_loop, args=(i,), daemon=True,
                    name=f"tpushare-wb{i}-{self.arena.name}")
                for i in range(self.writeback_streams)]
            for t in self._stream_threads:
                t.start()
        log.info("proactive pager up for %s (policy=%s, trickle %d MiB / "
                 "%.0f ms%s)", self.arena.name, self.policy.name,
                 self.writeback_chunk_bytes >> 20,
                 self.writeback_interval_s * 1000,
                 f", first-touch x{self.writeback_streams} streams"
                 if self.first_touch else "")

    def close(self) -> None:
        """Stop the threads, wait for the streams and detach from the
        arena. Idempotent."""
        self._stop.set()
        threads = [self._thread] + list(self._stream_threads)
        for t in threads:
            if (t is not None and t.is_alive()
                    and t is not threading.current_thread()):
                t.join(timeout=10)
        self.quiesce()
        if getattr(self.arena, "pager", None) is self:
            self.arena.pager = None

    def bind_client(self, client) -> None:
        """Tell the pager which client runtime arbitrates its lock — the
        threads only move data while that client holds the lock (or runs
        unmanaged). Starts them if the pager was built with
        ``start=False``."""
        self._client = client
        self.start()

    def quiesce(self) -> None:
        """Block until every copy issued on the pager's streams is done."""
        for s in self.streams:
            s.synchronize()

    def _on_device(self):
        """A pager thread's device context: a new thread does not inherit
        the current CUDA device."""
        if self.arena.cuda:
            return torch.cuda.device(self.arena.device)
        return contextlib.nullcontext()

    def _fail(self, exc: BaseException) -> None:
        """A pager thread hit an error: keep the first, stop every thread
        (no fallback path), and leave it for the tenant's next op."""
        log.error("pager of %s failed; stopping it", self.arena.name,
                  exc_info=exc)
        if self.error is None:
            self.error = exc
        self._stop.set()

    # -- client-runtime callbacks -----------------------------------------

    def sync_and_evict(self) -> None:
        """DROP_LOCK / idle-release path: cancel in-flight proactive work,
        then run the arena's handoff (whose eviction now mostly finds clean
        arrays)."""
        with self._mu:
            self._gen += 1  # invalidate any chunk planned before the drop
            self._plan = None
            self._bg_plan = []
        self.arena.sync_and_evict_all()

    def _build_plan(self, budget_bytes: int) -> tuple:
        """Order the evicted hot set and clip to ``budget_bytes`` (a hard
        cap). Host-side only."""
        a = self.arena
        with a._lock:
            candidates = [va for va in (r() for r in a._hot)
                          if va is not None and va._dev is None]
        plan, acc = [], 0
        for va in self.policy.prefetch_order(candidates):
            if acc + va.nbytes > budget_bytes:
                continue
            plan.append(weakref.ref(va))
            acc += va.nbytes
        return plan, acc

    def on_lock_next(self, remain_ms: int = 0) -> None:
        """LOCK_NEXT advisory: build the prefetch plan before the grant.
        The lock is NOT held, so nothing touches the device; the evicted
        set's shadows already exist, so staging is ordering + clipping."""
        plan, acc = self._build_plan(self.prefetch_budget_bytes)
        with self._mu:
            self._plan = plan
        log.debug("%s on deck: planned %d arrays / %d MiB (%d ms left)",
                  self.arena.name, len(plan), acc >> 20, remain_ms)

    def on_horizon(self, depth: int, total: int, eta_ms: int = 0) -> None:
        """GRANT_HORIZON advisory: position 1 plans its full budget,
        position k stages budget/k; d=0 (dropped out) cancels the plan."""
        if depth <= 0:
            with self._mu:
                self._plan = None
            log.debug("%s left the grant horizon: staging canceled",
                      self.arena.name)
            return
        budget = max(self.prefetch_chunk_bytes,
                     self.prefetch_budget_bytes // depth)
        plan, acc = self._build_plan(budget)
        with self._mu:
            self._plan = plan
        self._m_staged.inc()
        self._m_staged_bytes.inc(acc)
        log.debug("%s staged at horizon d=%d/%d: %d arrays / %d MiB "
                  "(eta %d ms)", self.arena.name, depth, total, len(plan),
                  acc >> 20, eta_ms)

    def prefetch_on_grant(self) -> None:
        """LOCK_OK path: execute the on-deck plan (or build one now if no
        LOCK_NEXT preceded this grant). Only the first chunk pages in at
        once; the daemon streams the rest behind the tenant's compute. A
        device error here fails the tenant's next op instead of the
        client's message thread."""
        try:
            self._prefetch_on_grant()
        except Exception as e:  # re-raised in the tenant's thread
            self._fail(e)

    def _prefetch_on_grant(self) -> None:
        with self._mu:
            plan = self._plan
            self._plan = None
        if plan is None:
            self.on_lock_next()
            with self._mu:
                plan, self._plan = self._plan or [], None
        a = self.arena
        with a._lock:
            a._hot = []  # the plan supersedes the arena's own hot snapshot
        if self.first_touch:
            # Map-on-fault: NOTHING pages in here — the first gated ops
            # fault exactly what they touch and the daemon streams the
            # staged plan behind compute.
            with self._mu:
                self._bg_plan = list(plan)
                self._bg_gen = self._gen
            return
        now, acc = [], 0
        rest = []
        for ref in plan:
            va = ref()
            if va is None:
                continue  # dropped between advisory and grant
            if acc < self.prefetch_chunk_bytes:
                now.append(va)
                acc += va.nbytes
            else:
                rest.append(ref)
        if now:
            self._page_in(now)
        with self._mu:
            self._bg_plan = rest
            self._bg_gen = self._gen  # the remainder belongs to this grant

    # -- daemon -----------------------------------------------------------

    def _daemon_loop(self) -> None:
        with self._on_device():
            while not self._stop.wait(self.writeback_interval_s):
                try:
                    self._update_wss_gauge()
                    if not self._holder_phase():
                        continue
                    self._bg_prefetch_tick()
                    # First-touch mode moves writeback to the stream
                    # workers; the whole-array trickle would move those
                    # bytes twice.
                    if not self.first_touch:
                        self._writeback_tick()
                except Exception as e:  # re-raised in the tenant's thread
                    self._fail(e)

    def _update_wss_gauge(self) -> None:
        if self._g_wss is None:
            return
        # Throttled to the fleet push cadence: recomputing the EWMA walks
        # the whole wss access history, and its only consumer (the k=MET
        # push) samples at ~0.25 s.
        now = time.monotonic()
        if now < self._wss_next_s:
            return
        self._wss_next_s = now + 0.25
        try:
            self._g_wss.set(int(self.policy.wss_ewma_bytes()))
        except Exception:  # policy bugs must not kill the daemon
            log.debug("wss gauge update failed", exc_info=True)

    # -- adaptive writeback rate (first-touch streams) --------------------

    @property
    def writeback_rate_factor(self) -> float:
        """Live backoff factor of the shared token bucket (1.0 = full
        rate)."""
        return self._bucket.factor

    def note_step_latency(self, seconds: float) -> None:
        """Observed step/fence latency from the arena's submit path: a
        smoothed rise above the best observed latency halves the refill
        rate; it recovers gradually once the latency settles."""
        try:
            s = float(seconds)
        except (TypeError, ValueError):
            return
        if s < 0:
            return
        if self._step_ewma is None:
            self._step_ewma = s
            self._step_floor = s
            return
        self._step_ewma = 0.7 * self._step_ewma + 0.3 * s
        # The floor moves DOWN smoothly toward faster samples (30% a
        # sample) and decays UP slowly (5% a sample), so one fast outlier
        # cannot pin it and a slower phase re-baselines in ~15 steps.
        self._step_floor = min(self._step_floor * 1.05,
                               0.7 * self._step_floor + 0.3 * s,
                               max(self._step_ewma, 1e-6))
        if self._step_ewma > _BACKOFF_MULT * max(self._step_floor, 1e-4):
            self._bucket.factor = max(_BACKOFF_FLOOR,
                                      self._bucket.factor * 0.5)
        else:
            self._bucket.factor = min(1.0, self._bucket.factor * 1.25)

    # -- copies -----------------------------------------------------------

    def _issue(self, stream, va, dev: torch.Tensor, dst: torch.Tensor,
               span: Optional[tuple] = None):
        """Copy ``va``'s device copy ``dev`` (flat elements ``span`` =
        (lo, hi) of it, or all of it) into ``dst`` (its pinned shadow, or
        that span of it) on ``stream``, after ``va``'s producer and its
        last page-in from the shadow; returns the event that marks the
        copy done (None on a CPU arena, which copies at once). Arena lock
        held."""
        if stream is None:
            dst.copy_(dev if span is None else dev.reshape(-1)[slice(*span)])
            return None
        with torch.cuda.stream(stream):
            if va._ready is not None:
                stream.wait_event(va._ready)
            if va._in_ev is not None:
                stream.wait_event(va._in_ev)
            src = dev if span is None else dev.reshape(-1)[slice(*span)]
            dst.copy_(src, non_blocking=True)
            # The caching allocator must not hand dev's block to another
            # tensor (after an eviction or a donation) until this copy
            # has read it.
            dev.record_stream(stream)
            return stream.record_event()

    # -- sharded multi-stream writeback (first-touch mode) ----------------

    def _stream_loop(self, index: int) -> None:
        stream = self.streams[index] if self.streams else None
        with self._on_device():
            while not self._stop.is_set():
                try:
                    if not (self.first_touch and self._holder_phase()):
                        self._stop.wait(self.writeback_interval_s)
                        continue
                    work = self._claim_stream_work()
                    if work is None:
                        self._stop.wait(self.writeback_interval_s)
                        continue
                    self._stream_writeback(*work, stream=stream)
                except Exception as e:  # re-raised in the tenant's thread
                    self._fail(e)

    def _claim_stream_work(self):
        """Claim ONE dirty array for a stream (arena lock held): the claim
        set keeps two streams off one array, the pin shields it from LRU
        eviction, and readiness keeps unfinished outputs off-limits. The
        port's shadows always take in-place chunk writes."""
        a = self.arena
        with a._lock:
            # _dirty_chunks is NON-empty for claimable arrays: an empty
            # set would publish nothing and never clear _dirty.
            cands = [va for va in a._live
                     if va._dev is not None and va._dirty and va._pin == 0
                     and va._dirty_chunks
                     and id(va) not in self._claimed and _ready(va)]
            if not cands:
                return None
            va = self.policy.writeback_order(cands)[0]
            self._claimed.add(id(va))
            va._pin += 1
            return va, va._dev, sorted(va._dirty_chunks)

    def _stream_writeback(self, va, dev, chunks, stream=None) -> None:
        """Drain ``va``'s dirty chunks: each chunk is token-bucketed, its
        copy issued under the arena lock straight into the shadow, waited
        for outside it and published under it. A handoff racing this
        waited for the copy, wrote the array back whole and evicted it,
        which ends the drain; a donation discarded it, likewise."""
        a = self.arena
        itemsize = dev.element_size()
        moved, cleaned = 0, 0
        try:
            if va._host is None:
                # Make the shadow outside the lock (a pinned allocation
                # can take milliseconds); _host_flat_writable adopts it.
                spare = a._new_host(va.shape, va.dtype)
                with a._lock:
                    if va._host is None and va._dev is dev:
                        va._host = spare
            for c in chunks:
                lo, hi = a._chunk_bounds(va, c)
                if hi <= lo:
                    continue
                if not self._bucket.take((hi - lo) * itemsize, self._stop):
                    break  # shutting down
                with a._lock:
                    if va._dev is not dev or not va._dirty:
                        break  # written back by a handoff, or discarded
                    if c not in va._dirty_chunks:
                        continue  # someone else drained this chunk
                    host_flat = a._host_flat_writable(va)
                    done = self._issue(stream, va, dev, host_flat[lo:hi],
                                       (lo, hi))
                if done is not None:
                    done.synchronize()
                with a._lock:
                    if va._dev is not dev or not va._dirty:
                        break
                    if c not in va._dirty_chunks:
                        continue
                    nb = (hi - lo) * itemsize
                    moved += nb
                    a._m_bytes_out.inc(nb)
                    va._dirty_chunks.discard(c)
                    if not va._dirty_chunks:
                        # The single counting site per dirty->clean
                        # transition, as in the arena's batch writeback.
                        va._dirty = False
                        cleaned += 1
                        a._m["page_out"].inc()
        finally:
            with a._lock:
                va._pin -= 1
                self._claimed.discard(id(va))
        if moved:
            self._m_wb.inc()
            self._m_wb_bytes.inc(moved)
            tev.record(tev.WRITEBACK, a.name, n=cleaned, bytes=moved,
                       ft=True)

    def _holder_phase(self) -> bool:
        """True while this tenant may touch the device: it holds the lock,
        or no scheduler arbitrates it (unmanaged = always the holder)."""
        c = self._client
        if c is None:
            return True
        if not getattr(c, "managed", False):
            return True
        return bool(c.owns_lock)

    def _writeback_tick(self) -> None:
        a = self.arena
        with a._lock:
            # Only arrays whose producer has finished (a copy would wait
            # for the compute otherwise) and that no op has pinned.
            dirty = [va for va in a._live
                     if va._dev is not None and va._dirty and va._pin == 0
                     and _ready(va)]
            if not dirty:
                return
            batch, acc = [], 0
            for va in self.policy.writeback_order(dirty):
                if batch and acc + va.nbytes > self.writeback_chunk_bytes:
                    break
                batch.append(va)
                acc += va.nbytes
            # Pin the batch (shields it from LRU eviction) and capture the
            # device buffers; the copies complete OUTSIDE the lock, so the
            # holder's gated ops are not serialized behind them.
            for va in batch:
                va._pin += 1
            bufs = [(va, va._dev) for va in batch]
        copied = []
        try:
            # Shadows are allocated outside the lock (a pinned allocation
            # can take milliseconds).
            hosts = [a._new_host(va.shape, va.dtype) for va, _ in bufs]
            stream = self.streams[0] if self.streams else None
            issued = []
            with a._lock:
                for (va, dev), h in zip(bufs, hosts):
                    if va._dev is not dev or not va._dirty:
                        continue  # a handoff wrote it back meanwhile
                    issued.append((va, h))
                    done = self._issue(stream, va, dev, h)
            if issued and done is not None:
                done.synchronize()
            copied = issued
        finally:
            n_clean, bytes_clean = 0, 0
            with a._lock:
                for va in batch:
                    va._pin -= 1
                for va, h in copied:
                    # Publish only arrays still dirty and resident: a
                    # handoff already wrote back (and counted) the rest,
                    # and a donated one was discarded. page_out advances
                    # exactly on the dirty->clean transition.
                    if va._dev is None or not va._dirty:
                        continue
                    va._host = h
                    va._dirty = False
                    n_clean += 1
                    bytes_clean += va.nbytes
                if n_clean:
                    a._m["page_out"].inc(n_clean)
                    a._m_bytes_out.inc(bytes_clean)
        if n_clean:
            self._m_wb.inc()
            self._m_wb_bytes.inc(bytes_clean)
            tev.record(tev.WRITEBACK, a.name, n=n_clean,
                       bytes=bytes_clean)

    def _bg_prefetch_tick(self) -> None:
        with self._mu:
            if not self._bg_plan or self._bg_gen != self._gen:
                self._bg_plan = []  # stale remainder: a drop superseded it
                return
            chunk, acc = [], 0
            while self._bg_plan and acc < self.prefetch_chunk_bytes:
                va = self._bg_plan.pop(0)()
                if va is None:
                    continue  # dropped while queued for prefetch
                chunk.append(va)
                acc += va.nbytes
            if chunk:
                # Page in while still holding ``_mu``: sync_and_evict's
                # generation bump serializes behind this bounded chunk, so
                # the handoff that follows evicts these pages.
                self._page_in(chunk, gen=self._bg_gen)

    def _page_in(self, vas: list, gen: Optional[int] = None) -> None:
        a = self.arena
        # Under the arena lock: a donation on the tenant's thread discards
        # its operand (no device copy, no shadow) under the same lock.
        with a._lock:
            vas = [va for va in vas if va._dev is None and va._acct["live"]]
            if not vas:
                return
            nbytes = sum(va.nbytes for va in vas)
            a.ensure(vas)  # counts page_in/FAULT, evicts LRU if over budget
        a._m["prefetches"].inc(len(vas))
        tev.record(tev.PREFETCH, a.name, n=len(vas), bytes=nbytes,
                   proactive=True,
                   gen=self._gen if gen is None else gen)


def client_callbacks(arena, pager: Optional[Pager] = None) -> dict:
    """The callback set a client runtime is built with — the one wiring
    site shared by :func:`nvshare_tpu_torch.interpose.client` and
    :class:`nvshare_tpu_torch.colocate.Tenant`. With a pager, DROP_LOCK
    cancels its in-flight work first, LOCK_OK runs its planned chunked
    prefetch and LOCK_NEXT plans that prefetch ahead of the grant; without
    one, the arena's synchronous hooks run."""
    callbacks = dict(
        sync_and_evict=arena.sync_and_evict_all,
        prefetch=arena.prefetch_hot,
        busy_probe=arena.busy_probe,
        timed_sync_ms=arena.timed_sync_ms,
    )
    if pager is not None:
        callbacks.update(
            sync_and_evict=pager.sync_and_evict,
            prefetch=pager.prefetch_on_grant,
            on_deck=pager.on_lock_next,
        )
        if pager.first_touch:
            # Horizon staging rides first-touch mode only: installing the
            # consumer is what makes the runtime declare CAP_HORIZON, so
            # without it the wire exchange carries no GRANT_HORIZON frame.
            callbacks["on_horizon"] = pager.on_horizon
    return callbacks


def maybe_attach_pager(arena, client=None,
                       enabled: Optional[bool] = None) -> Optional[Pager]:
    """Build and attach a :class:`Pager` for ``arena``, gated on
    ``enabled`` ($TPUSHARE_PAGER when None). Returns None when disabled,
    else the arena's pager. The threads stay DOWN until
    :meth:`Pager.bind_client` (called here when ``client`` is given)."""
    if not (enabled if enabled is not None else pager_enabled()):
        return None
    existing = getattr(arena, "pager", None)
    if existing is not None:
        if client is not None:
            existing.bind_client(client)
        return existing
    pager = Pager(arena, start=False)
    if client is not None:
        pager.bind_client(client)
    return pager
