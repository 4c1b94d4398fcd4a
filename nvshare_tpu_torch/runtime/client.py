"""The client runtimes, the port's copy of the JAX package's
``runtime/client.py``.

Both register with the per-host ``tpushare-scheduler``, block gated work
until the device lock is held, honor DROP_LOCK by running the arena's
fence + evict callback, and release early when idle:

  * :class:`NativeClient` — ctypes over ``libtpushare_client.so`` (the C++
    state machine in ``src/client.cpp``), one per process; the default of
    :func:`make_client`. Its callbacks run on the native runtime's own
    threads.
  * :class:`PurePythonClient` — the same surface on
    :class:`SchedulerLink`, one registration per instance, so several
    in-process tenants each hold their own.

Both carry the QoS declaration (``qos=`` / ``$TPUSHARE_QOS``), start the
fleet telemetry streamer (``$TPUSHARE_FLEET=1``) and the metrics exporter
(``$TPUSHARE_METRICS_PORT`` / ``_TEXTFILE``).
"""

from __future__ import annotations

import ctypes
import os
import threading
import time
from pathlib import Path
from typing import Callable, Optional

from nvshare_tpu_torch import telemetry
from nvshare_tpu_torch.runtime.protocol import (
    CAP_HORIZON,
    CAP_LOCK_NEXT,
    CAP_PHASE,
    PHASE_IDLE,
    PHASE_IDS,
    SCHED_CAP_PHASE,
    SCHED_CAP_WARM_RESTART,
    MsgType,
    SchedulerLink,
    default_job_name,
    parse_grant_epoch,
    parse_horizon,
)
from nvshare_tpu_torch.telemetry import events as tev
from nvshare_tpu_torch.utils.log import get_logger

log = get_logger("client")

#: Seconds ``PurePythonClient.shutdown`` waits for each of its threads.
SHUTDOWN_JOIN_S = 30.0


def _lock_metrics(client_name: str) -> dict:
    """The lock-transition metric children for one client, labeled by
    job name (shared by both runtime flavors)."""
    reg = telemetry.registry()
    return {
        "acquires": reg.counter(
            "tpushare_lock_acquires_total",
            "device-lock grants received", ["client"])
        .labels(client=client_name),
        "drops": reg.counter(
            "tpushare_lock_drops_total",
            "DROP_LOCK preemptions received", ["client"])
        .labels(client=client_name),
        "releases": reg.counter(
            "tpushare_lock_releases_total",
            "lock releases sent, by reason (drop|idle|explicit|native)",
            ["client", "reason"]),
        "hold": reg.histogram(
            "tpushare_lock_hold_seconds",
            "device-lock hold duration per grant", ["client"])
        .labels(client=client_name),
        "gate_wait": reg.histogram(
            "tpushare_gate_wait_seconds",
            "time gated work blocked waiting for the device lock",
            ["client"])
        .labels(client=client_name),
        "on_deck": reg.counter(
            "tpushare_on_deck_total",
            "LOCK_NEXT advisories received (next in line for the lock)",
            ["client"])
        .labels(client=client_name),
        "horizon": reg.counter(
            "tpushare_horizon_total",
            "GRANT_HORIZON advisories received (published schedule "
            "position updates, cancels included)",
            ["client"])
        .labels(client=client_name),
    }


_CB_VOID = ctypes.CFUNCTYPE(None, ctypes.c_void_p)
_CB_INT = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)
_CB_I64 = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.c_void_p)
_CB_ONDECK = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_int64)
_CB_HORIZON = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_int64)
_CB_MET = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                           ctypes.POINTER(ctypes.c_int64),
                           ctypes.POINTER(ctypes.c_int64))

# The native runtime's threads live for the whole process and keep calling
# through these trampolines; pinning them here (not on the instance) means a
# dropped NativeClient can never leave the native side with dangling
# function pointers.
_CALLBACK_KEEPALIVE: list = []


class _Callbacks(ctypes.Structure):
    # Mirrors tpushare_client_callbacks in src/client.hpp — field ORDER is
    # the ABI; keep the two in lockstep.
    _fields_ = [
        ("sync_and_evict", _CB_VOID),
        ("prefetch", _CB_VOID),
        ("busy_probe", _CB_INT),
        ("timed_sync_ms", _CB_I64),
        ("on_deck", _CB_ONDECK),
        ("on_horizon", _CB_HORIZON),
        ("met_probe", _CB_MET),  # left null: no k=MET instants
        ("user_data", ctypes.c_void_p),
    ]


def _default_lib_path() -> Path:
    env = os.environ.get("TPUSHARE_LIB_DIR")
    if env:
        return Path(env) / "libtpushare_client.so"
    return (
        Path(__file__).resolve().parent.parent.parent
        / "src" / "build" / "libtpushare_client.so"
    )


class NativeClient:
    """ctypes wrapper over the singleton native client runtime.

    One per process (the native library holds process-global state). Its
    callbacks run on the runtime's own threads, which PyTorch has not
    seen before: each starts on the default CUDA stream of device 0, and
    the arena's hooks take its lock from there.

    Unlike the JAX package's wrapper, an exception inside a callback is
    not left to ctypes (which prints it and returns as if the callback
    had succeeded): the first one is kept, the trampoline returns the
    runtime's "unknown" value, and :meth:`continue_with_lock` and
    :meth:`release_now` raise it in the tenant's own thread, so a CUDA
    error during a handoff fails the tenant instead of running on.
    """

    def __init__(
        self,
        sync_and_evict: Optional[Callable[[], None]] = None,
        prefetch: Optional[Callable[[], None]] = None,
        busy_probe: Optional[Callable[[], int]] = None,
        timed_sync_ms: Optional[Callable[[], int]] = None,
        on_deck: Optional[Callable[[int], None]] = None,
        on_horizon: Optional[Callable[[int, int, int], None]] = None,
        lib_path: Optional[os.PathLike] = None,
    ):
        self.job_name = default_job_name()
        self._m = _lock_metrics(self.job_name)
        self._grant_t: Optional[float] = None
        #: The first exception a callback raised (re-raised at the gate).
        self.error: Optional[Exception] = None
        telemetry.maybe_start_from_env()
        # The native runtime releases the lock right after running the
        # sync_and_evict callback (DROP_LOCK and idle early-release both
        # funnel through it) — that callback edge is the only
        # Python-visible release, so hook it here to close the trace
        # span and observe the hold histogram.
        orig_sync = sync_and_evict

        def _traced_sync_and_evict():
            if orig_sync is not None:
                orig_sync()
            args: dict = {"reason": "native"}
            t0, self._grant_t = self._grant_t, None
            if t0 is not None:
                held_s = time.monotonic() - t0
                self._m["hold"].observe(held_s)
                args["seconds"] = round(held_s, 6)
            self._m["releases"].labels(
                client=self.job_name, reason="native").inc()
            tev.record(tev.LOCK_RELEASE, self.job_name, **args)

        orig_on_horizon = on_horizon

        def _traced_on_horizon(depth: int, total: int,
                               eta_ms: int) -> None:
            # Advisory only, like on_deck: count + trace the published
            # schedule position.
            self._m["horizon"].inc()
            tev.record(tev.HORIZON, self.job_name, d=int(depth),
                       n=int(total), eta_ms=int(eta_ms))
            if orig_on_horizon is not None:
                orig_on_horizon(int(depth), int(total), int(eta_ms))

        orig_on_deck = on_deck

        def _traced_on_deck(remain_ms: int) -> None:
            # Advisory only — never touches lock state; count + trace it.
            self._m["on_deck"].inc()
            tev.record(tev.ON_DECK, self.job_name,
                       remain_ms=int(remain_ms))
            if orig_on_deck is not None:
                orig_on_deck(int(remain_ms))

        path = Path(lib_path) if lib_path else _default_lib_path()
        self._lib = ctypes.CDLL(str(path))
        self._lib.tpushare_client_init.argtypes = [
            ctypes.POINTER(_Callbacks)
        ]
        self._lib.tpushare_client_init.restype = ctypes.c_int
        self._lib.tpushare_client_id.restype = ctypes.c_uint64
        self._lib.tpushare_client_set_phase.argtypes = [ctypes.c_int64]

        guard = self._guard
        cb_kwargs = dict(
            sync_and_evict=_CB_VOID(guard(
                lambda _ud: _traced_sync_and_evict(), None)),
            prefetch=_CB_VOID(guard(
                (lambda _ud: prefetch()) if prefetch
                else (lambda _ud: None), None)),
            busy_probe=_CB_INT(guard(
                (lambda _ud: busy_probe()) if busy_probe
                else (lambda _ud: -1), -1)),
            timed_sync_ms=_CB_I64(guard(
                (lambda _ud: timed_sync_ms()) if timed_sync_ms
                else (lambda _ud: -1), -1)),
            user_data=None,
        )
        if orig_on_deck is not None:
            # Only a real consumer installs the trampoline: a null
            # on_deck keeps the native runtime from declaring the
            # LOCK_NEXT capability (no advisory frames).
            cb_kwargs["on_deck"] = _CB_ONDECK(guard(
                lambda _ud, ms: _traced_on_deck(ms), None))
        if orig_on_horizon is not None:
            # Same gating for the horizon cap: no consumer, no
            # trampoline, no kCapHorizon — zero GRANT_HORIZON frames.
            cb_kwargs["on_horizon"] = _CB_HORIZON(guard(
                lambda _ud, d, n, eta: _traced_on_horizon(d, n, eta), None))
        self._cb_refs = _Callbacks(**cb_kwargs)
        _CALLBACK_KEEPALIVE.append(self._cb_refs)
        rc = self._lib.tpushare_client_init(ctypes.byref(self._cb_refs))
        if rc != 0:
            raise RuntimeError(
                "tpushare client init failed (scheduler required but "
                "unreachable)"
            )
        # Fleet plane ($TPUSHARE_FLEET=1): the native runtime owns its
        # control socket in C++, so the streamer rides a dedicated
        # observer-only connection — one per process. Disabled (the
        # default) this is a no-op.
        from nvshare_tpu_torch.telemetry.fleet import maybe_start_streamer

        maybe_start_streamer(job_name=self.job_name)
        # The native runtime's threads call back INTO Python; a callback
        # firing after interpreter finalization is a segfault.
        # tpushare_client_shutdown joins the native threads; ctypes
        # releases the GIL around the call, so an in-flight callback can
        # complete rather than deadlock.
        import atexit

        atexit.register(self._lib.tpushare_client_shutdown)

    def _guard(self, fn, fallback):
        """``fn`` for a ctypes trampoline: an exception is kept in
        :attr:`error` (the first one) and ``fallback`` returned."""
        def call(*args):
            try:
                return fn(*args)
            except Exception as e:  # kept for the tenant's thread
                if self.error is None:
                    self.error = e
                log.error("native client callback failed: %r", e)
                return fallback
        return call

    def _raise_error(self) -> None:
        if self.error is not None:
            raise RuntimeError(
                "a callback of the native client failed on its thread"
            ) from self.error

    def _record_acquire(self, waited_from: float) -> None:
        now = time.monotonic()
        self._grant_t = now
        self._m["acquires"].inc()
        waited_s = now - waited_from
        self._m["gate_wait"].observe(waited_s)
        # The exact wait sample, into the event ring: the fleet trace
        # carries it to the QoS report's per-class percentiles.
        tev.record(tev.GATE_WAIT, self.job_name,
                   seconds=round(waited_s, 6))
        tev.record(tev.LOCK_ACQUIRE, self.job_name, runtime="native")

    def continue_with_lock(self) -> None:
        self._raise_error()
        # Hot path (already holding): exactly the native call plus two
        # owns_lock probes. Lock transitions happen inside the native
        # runtime, so the False->True edge across this call is the only
        # Python-visible acquire to count/trace.
        if self.owns_lock:
            t0 = time.monotonic()
            self._lib.tpushare_continue_with_lock()
            # An async DROP_LOCK can land INSIDE the call: the release
            # hook nulled _grant_t and the call blocked for a re-grant.
            # Count that grant here (still holding + no open grant ==
            # re-granted); t0 slightly overstates the wait.
            if self._grant_t is None and self.owns_lock:
                self._record_acquire(t0)
            self._raise_error()
            return
        t0 = time.monotonic()
        self._lib.tpushare_continue_with_lock()
        if self.owns_lock:
            self._record_acquire(t0)
        self._raise_error()

    @property
    def owns_lock(self) -> bool:
        return bool(self._lib.tpushare_client_owns_lock())

    @property
    def scheduler_on(self) -> bool:
        return bool(self._lib.tpushare_client_scheduler_on())

    @property
    def managed(self) -> bool:
        return bool(self._lib.tpushare_client_managed())

    @property
    def client_id(self) -> int:
        return int(self._lib.tpushare_client_id())

    def release_now(self) -> None:
        self._lib.tpushare_client_release_now()
        self._raise_error()

    def mark_activity(self) -> None:
        self._lib.tpushare_client_mark_activity()

    def set_phase(self, phase) -> None:
        """Declare the serving phase (``"idle"``/``"prefill"``/
        ``"decode"`` or a ``PHASE_*`` id); advisory — see
        :meth:`PurePythonClient.set_phase`."""
        if isinstance(phase, str):
            phase = PHASE_IDS.get(phase.strip().lower(), PHASE_IDLE)
        self._lib.tpushare_client_set_phase(int(phase))

    def shutdown(self) -> None:
        self._lib.tpushare_client_shutdown()


class PurePythonClient:
    """Same surface as :class:`NativeClient`, implemented on
    :class:`SchedulerLink`: one registration per instance, so several
    in-process tenants each hold their own."""

    def __init__(
        self,
        sync_and_evict: Optional[Callable[[], None]] = None,
        prefetch: Optional[Callable[[], None]] = None,
        busy_probe: Optional[Callable[[], int]] = None,
        timed_sync_ms: Optional[Callable[[], int]] = None,
        on_deck: Optional[Callable[[int], None]] = None,
        on_horizon: Optional[Callable[[int, int, int], None]] = None,
        job_name: Optional[str] = None,
        qos=None,
    ):
        self._sync_and_evict = sync_and_evict or (lambda: None)
        self._prefetch = prefetch or (lambda: None)
        self._on_deck = on_deck
        self._on_horizon = on_horizon
        self._busy_probe = busy_probe
        self._timed_sync_ms = timed_sync_ms
        self.job_name = job_name or default_job_name()
        self._m = _lock_metrics(self.job_name)
        self._grant_t: Optional[float] = None
        telemetry.maybe_start_from_env()
        try:
            self.priority = int(os.environ.get("TPUSHARE_PRIORITY", "0"))
        except ValueError:  # garbage value: match the C runtime's fallback
            self.priority = 0
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._own_lock = False
        self._need_lock = False
        self._did_work = False
        # Fencing epoch of the live grant (LOCK_OK "epoch=N"; 0 from a
        # pre-lease scheduler), echoed in LOCK_RELEASED so the scheduler
        # can discard a stale release after revoking us.
        self._grant_epoch = 0
        # The epoch we still HELD when the link last died (0 = clean
        # rejoin). Echoed once as REHOLD_INFO after the next successful
        # re-register — only to a daemon advertising
        # SCHED_CAP_WARM_RESTART — so a warm-restarted scheduler can
        # tell died-mid-hold from clean rejoin (docs/ROBUSTNESS.md).
        self._last_held_epoch = 0
        # Lost-frame insurance (chaos/fault-injection runs): re-send
        # REQ_LOCK after this many seconds blocked at the gate. The
        # scheduler dedupes duplicate requests, so retrying is wire-safe;
        # 0 (the default) keeps the exact one-request-per-episode
        # reference behavior.
        try:
            self._req_retry_s = float(
                os.environ.get("TPUSHARE_REQ_RETRY_S", "0"))
        except ValueError:
            self._req_retry_s = 0.0
        #: REQ_LOCKs sent again within one gate wait (by that insurance,
        #: or after a reconnect), for a run's report.
        self.req_resends = 0
        self._in_callback = threading.local()
        self.managed = False
        self.scheduler_on = True
        self.client_id = 0
        self._stop = False
        # Set by a REVOKED frame (monotonic seconds): the link death that
        # follows blocks at the gate and re-queues (bounded forced
        # reconnect) instead of free-running the revoked window.
        self._revoked_at: Optional[float] = None
        # Declare the LOCK_NEXT capability only when something consumes
        # the advisory: a pager-less client (TPUSHARE_PAGER=0) keeps the
        # byte-for-byte reference wire behavior — no advisory frames at
        # all, not just ignored ones.
        self._caps = CAP_LOCK_NEXT if self._on_deck is not None else 0
        # Same degradation story for the published grant horizon: only a
        # real consumer (the first-touch pager's staging hook) declares
        # the capability, so everyone else keeps the exact pre-horizon
        # wire exchange — zero GRANT_HORIZON frames.
        if self._on_horizon is not None:
            self._caps |= CAP_HORIZON
        # Serving-phase advisories ($TPUSHARE_PHASE=1): declare the
        # capability only when armed, and send PHASE_INFO only to a
        # daemon that advertised SCHED_CAP_PHASE — unset keeps the
        # byte-for-byte pre-phase exchange (zero new frames, zero new
        # REGISTER bits). The last declared phase is remembered so a
        # reconnect re-declares it (the advisory is per-connection
        # state scheduler-side).
        self._phase = PHASE_IDLE
        if os.environ.get("TPUSHARE_PHASE") == "1":
            self._caps |= CAP_PHASE
        # QoS declaration: an explicit `qos` (spec string or QosSpec —
        # in-process co-located tenants carry per-tenant specs) or the
        # process-wide $TPUSHARE_QOS. None/unset adds no bits: the exact
        # reference REGISTER arg, same degradation story as LOCK_NEXT.
        from nvshare_tpu_torch.qos import spec as qos_spec

        self.qos = (qos_spec.coerce(qos) if qos is not None
                    else qos_spec.from_env())
        if self.qos is not None:
            self._caps |= self.qos.to_caps()
        try:
            self._link = SchedulerLink(job_name=job_name)
            self.client_id, self.scheduler_on = self._link.register(
                caps=self._caps)
            self.managed = True
            self._declare_gang()
            # Fleet plane ($TPUSHARE_FLEET=1): process-wide streamer on
            # its own observer-only connection (the client state machine
            # stays untouched; in-process co-located tenants share one
            # streamer). Off by default — zero TELEMETRY_PUSH frames.
            from nvshare_tpu_torch.telemetry.fleet import (
                maybe_start_streamer,
            )

            maybe_start_streamer(job_name=self.job_name)
        except OSError:
            if os.environ.get("TPUSHARE_REQUIRE_SCHEDULER") == "1":
                raise RuntimeError("scheduler required but unreachable")
            log.warning("no scheduler — running unmanaged")
            return
        self._msg_thread = threading.Thread(
            target=self._msg_loop, daemon=True, name="tpushare-client"
        )
        self._msg_thread.start()
        self._rel_thread = threading.Thread(
            target=self._release_loop, daemon=True, name="tpushare-release"
        )
        self._rel_thread.start()
        # Daemon threads are killed at arbitrary points during
        # interpreter finalization; the release checker may be INSIDE a
        # CUDA call (its timed-sync idle probe) at that moment. Shut down
        # and JOIN the threads while the interpreter is still whole.
        import atexit

        atexit.register(self.shutdown)

    # -- internals ---------------------------------------------------------

    def _declare_gang(self) -> None:
        """Mirror of the C runtime's gang declaration: if this process is a
        member of a multi-host gang ($TPUSHARE_GANG_ID / $TPUSHARE_GANG_WORLD
        = number of hosts), tell the scheduler right after registration so
        lock requests escalate to the gang coordinator."""
        gang = os.environ.get("TPUSHARE_GANG_ID", "")
        if not gang:
            return
        try:
            world = max(1, int(os.environ.get("TPUSHARE_GANG_WORLD", "1")))
        except ValueError:
            world = 1
        try:
            self._link.send(MsgType.GANG_INFO, arg=world, job_name=gang)
            log.info("gang member: %s (world %d)", gang, world)
        except OSError:
            with self._cv:  # _link_down notifies; the condvar must be held
                self._link_down()

    def _send_phase(self, phase: int) -> None:
        """Send one PHASE_INFO advisory (idle included — an explicit
        idle transition must REVERT the scheduler's re-class) — only
        when $TPUSHARE_PHASE armed the capability and the daemon
        advertised SCHED_CAP_PHASE (an old daemon treats type 25 as a
        fatal unknown). Best-effort: droppable by contract."""
        if not (self._caps & CAP_PHASE):
            return
        if not (self._link.sched_caps & SCHED_CAP_PHASE):
            return
        try:
            self._link.send(MsgType.PHASE_INFO, arg=phase)
        except OSError:
            pass  # the message loop owns the dead-link path

    def _declare_phase(self) -> None:
        """Reconnect path: re-declare the stored phase on the fresh
        session. A fresh registration is already idle scheduler-side, so
        only a live prefill/decode phase needs a frame."""
        if self._phase != PHASE_IDLE:
            self._send_phase(self._phase)

    def set_phase(self, phase) -> None:
        """Declare this tenant's serving phase (``"idle"``/``"prefill"``/
        ``"decode"`` or a ``PHASE_*`` id). Purely advisory: with
        ``TPUSHARE_PHASE`` unset (or a phase-less daemon) nothing is
        sent — zero wire bytes — and the scheduler side only ever
        RE-CLASSES (decode ≙ interactive, prefill ≙ batch; idle restores
        the declared class; declared weight untouched), so a lost frame
        degrades to "never sent"."""
        if isinstance(phase, str):
            phase = PHASE_IDS.get(phase.strip().lower(), PHASE_IDLE)
        phase = int(phase)
        if phase not in (0, 1, 2):
            phase = PHASE_IDLE
        with self._cv:
            self._phase = phase
            if not self.managed:
                return
        self._send_phase(phase)

    def _run_cb(self, fn) -> None:
        self._in_callback.active = True
        try:
            fn()
        finally:
            self._in_callback.active = False

    def _send(self, mtype: MsgType, arg: int = 0) -> None:
        try:
            self._link.send(mtype, arg=arg)
        except OSError:
            self._link_down()

    def _link_down(self) -> None:
        log.warning("scheduler connection lost — running unmanaged")
        self.managed = False
        self._own_lock = False
        self._need_lock = False
        self._grant_epoch = 0  # that grant is over; never echo it again
        self._grant_t = None  # no LOCK_RELEASE will close this grant
        self._cv.notify_all()

    def _evict_and_release(self, reason: str = "drop",
                           best_effort_send: bool = False) -> None:
        """Called with self._cv HELD and _own_lock already cleared: run the
        (slow: fence + whole-working-set evict) callback with the condvar
        RELEASED — submitter threads must be able to reach their wait, and
        callbacks take the arena lock (holding both risks lock-order
        inversions) — then hand the lock back and wake waiters so they
        re-request. ``reason`` labels the release in telemetry:
        drop (preempted), idle (early release), explicit (release_now),
        revoked (lease revoked). ``best_effort_send`` (revocation path):
        the scheduler is about to retire this fd anyway, so a failed
        release send must NOT run _link_down — that would wake waiters
        into free-run and skip the rejoin the REVOKED frame exists for
        (mirrors the C++ runtime's raw send_msg there)."""
        self._cv.release()
        try:
            self._run_cb(self._sync_and_evict)
        finally:
            self._cv.acquire()
        # Record the release BEFORE sending LOCK_RELEASED: the instant
        # the send lands, the scheduler may grant the peer, whose
        # LOCK_ACQUIRE would then be timestamped before our release —
        # a phantom overlap in the trace. Recording first shaves the
        # span by microseconds (conservative) instead.
        held_args: dict = {"reason": reason}
        if self._grant_t is not None:
            held_s = time.monotonic() - self._grant_t
            self._grant_t = None
            self._m["hold"].observe(held_s)
            held_args["seconds"] = round(held_s, 6)
        self._m["releases"].labels(
            client=self.job_name, reason=reason).inc()
        tev.record(tev.LOCK_RELEASE, self.job_name, **held_args)
        # Echo the grant's fencing epoch (0 from a pre-lease scheduler);
        # the epoch is consumed by this release.
        epoch, self._grant_epoch = self._grant_epoch, 0
        if best_effort_send:
            try:
                self._link.send(MsgType.LOCK_RELEASED, arg=epoch)
            except OSError:
                pass  # fd already retired; the rejoin path handles it
        else:
            self._send(MsgType.LOCK_RELEASED, epoch)
        self._need_lock = False
        self._cv.notify_all()

    def _try_reconnect(self, force: bool = False,
                       deadline: Optional[float] = None) -> bool:
        """Opt-in recovery from a scheduler restart or a lease revocation
        (the reference has none — SURVEY §5.3: a daemon restart
        permanently orphans clients). With TPUSHARE_RECONNECT=1 the
        message loop retries and re-registers, restoring managed
        arbitration transparently: first attempt immediately (the fastest
        path back into arbitration is right now), then exponential
        backoff with ±25% jitter capped at TPUSHARE_RECONNECT_MAX_S — a
        dead daemon must not be hammered at a fixed rate forever by every
        orphaned tenant on the host.

        ``force`` (revocation-aware fail-open): attempt regardless of the
        env — the daemon just revoked us, so it is reachable — bounded by
        ``deadline`` (monotonic seconds), past which the caller falls
        back to the authoritative fd-close policy."""
        if not force and os.environ.get("TPUSHARE_RECONNECT") != "1":
            return False
        import random

        try:
            base = max(1.0, float(os.environ.get("TPUSHARE_RECONNECT_S",
                                                 "5")))
        except ValueError:
            base = 5.0
        try:
            cap = max(base, float(os.environ.get(
                "TPUSHARE_RECONNECT_MAX_S", "60")))
        except ValueError:
            cap = max(base, 60.0)
        rng = random.Random()
        delay = 0.0  # canonical (unjittered) backoff; 0 = attempt now
        while not self._stop:
            if deadline is not None and time.monotonic() >= deadline:
                return False
            if delay > 0:
                # Sliced sleep: shutdown() must never wait out a backoff.
                wake = time.monotonic() + delay * (0.75 +
                                                   0.5 * rng.random())
                while not self._stop and time.monotonic() < wake:
                    time.sleep(0.05)
            if self._stop:
                return False
            delay = base if delay <= 0 else min(delay * 2, cap)
            try:
                link = SchedulerLink(job_name=self._link.job_name)
                cid, on = link.register(caps=self._caps)
            except Exception:
                continue
            with self._cv:
                if self._stop:
                    link.close()
                    return False
                self._link = link
                self.client_id = cid
                self.scheduler_on = on
                self.managed = True
                self._own_lock = False
                self._need_lock = False
                log.info("reconnected to scheduler (id %x)", cid)
                self._cv.notify_all()
            self._declare_gang()  # fresh session: re-declare membership
            # Re-declare the serving phase: a reconnected decode tenant
            # must not silently arbitrate as idle.
            self._declare_phase()
            # Warm-restart rejoin: echo the epoch we held when the old
            # link died — once, and only to a daemon that advertised the
            # capability (an old daemon treats type 24 as fatal).
            # Cleared either way: it describes THAT crash, not a later
            # one.
            held_epoch, self._last_held_epoch = self._last_held_epoch, 0
            if held_epoch:
                if self._link.sched_caps & SCHED_CAP_WARM_RESTART:
                    try:
                        self._link.send(MsgType.REHOLD_INFO,
                                        arg=held_epoch)
                    except OSError:
                        pass  # the message loop handles the dead link
            return True
        return False

    def _msg_loop(self) -> None:
        while not self._stop:
            try:
                m = self._link.recv(timeout=None)
            except (OSError, ValueError, ConnectionError):
                held = False
                revoked_at = self._revoked_at
                self._revoked_at = None
                with self._cv:
                    if not self._stop:
                        held = self._own_lock
                        # Remember a hold the link death tore down: the
                        # next re-register echoes it as REHOLD_INFO
                        # (warm-restart reconciliation).
                        if held and self._grant_epoch:
                            self._last_held_epoch = self._grant_epoch
                        # Drop the grant but do NOT flip managed/notify
                        # yet: gate waiters must stay parked until the
                        # eviction below finishes, or they would free-run
                        # compute concurrently with it — a concurrency
                        # mode no other eviction path allows.
                        self._own_lock = False
                        self._grant_epoch = 0
                        self._grant_t = None
                if held:
                    # A dead link while holding means the device is no
                    # longer ours — the scheduler revoked the lease or
                    # died and will re-arbitrate from scratch. Evict the
                    # working set BEFORE any reconnect/free-run: a
                    # revoked tenant must never keep computing against a
                    # device it doesn't own. (A fresh gate arrival can
                    # still trip _link_down via its own failed REQ_LOCK
                    # send — the same window the pre-lease code had.)
                    try:
                        self._run_cb(self._sync_and_evict)
                    except Exception:
                        log.warning("evict after link loss failed",
                                    exc_info=True)
                if revoked_at is not None and not self._stop:
                    # Revocation-aware fail-open (a REVOKED frame
                    # preceded this close): the daemon is demonstrably
                    # alive, so BLOCK at the gate and re-queue through a
                    # bounded forced reconnect instead of free-running
                    # the revoked window. _need_lock=True parks gate
                    # waiters (nothing sends on the dead link) until the
                    # reconnect resolves; past the window the
                    # authoritative fd-close policy — _link_down's
                    # fail-open — applies as if the frame never arrived.
                    with self._cv:
                        self._need_lock = True
                    try:
                        rejoin_s = float(os.environ.get(
                            "TPUSHARE_REVOKED_REJOIN_S", "10"))
                    except ValueError:
                        rejoin_s = 10.0
                    if rejoin_s > 0 and self._try_reconnect(
                            force=True, deadline=revoked_at + rejoin_s):
                        continue
                with self._cv:
                    if not self._stop:
                        self._link_down()  # now unblock waiters
                if self._try_reconnect():
                    continue
                return
            if m.type == MsgType.REVOKED:
                # Lease revoked (the scheduler's grace expired with our
                # release still outstanding); its close of this link
                # follows within the near-miss window and stays
                # authoritative. Here we (a) stop computing NOW and hand
                # back a best-effort LOCK_RELEASED — landing inside the
                # scheduler's near-miss window is what widens its
                # adaptive grace — and (b) arm the link-death path above
                # to block-and-requeue instead of free-running.
                log.warning("lease revoked by scheduler (epoch %s)",
                            m.arg)
                with self._cv:
                    self._revoked_at = time.monotonic()
                    self._need_lock = True  # park the gate
                    if self._own_lock:
                        self._own_lock = False
                        self._evict_and_release("revoked",
                                                best_effort_send=True)
                        # _evict_and_release wakes waiters with
                        # _need_lock cleared; re-park before any of them
                        # can reacquire the condvar and send on a link
                        # the scheduler is about to retire.
                        self._need_lock = True
                continue
            if m.type == MsgType.LOCK_NEXT:
                # Advisory: we are first in line for the next grant. No
                # lock state is touched; the pager's planning callback runs
                # outside the condvar (it may take the arena lock, and a
                # DROP_LOCK for the current holder must stay deliverable).
                self._m["on_deck"].inc()
                tev.record(tev.ON_DECK, self.job_name,
                           remain_ms=int(m.arg))
                if self._on_deck is not None:
                    cb, arg = self._on_deck, int(m.arg)
                    try:
                        self._run_cb(lambda: cb(arg))
                    except Exception:
                        # The advisory is best-effort planning: a pager/
                        # policy bug must degrade to "no plan", never
                        # kill the message loop (a dead loop wedges the
                        # tenant at the gate forever).
                        log.warning("on_deck callback failed",
                                    exc_info=True)
                continue
            if m.type == MsgType.GRANT_HORIZON:
                # Advisory: we are one of the next K predicted holders
                # (d=0 = dropped out — cancel staging). Same contract as
                # LOCK_NEXT: no lock state is touched and the staging
                # callback runs outside the condvar.
                depth, total = parse_horizon(m.job_name)
                self._m["horizon"].inc()
                tev.record(tev.HORIZON, self.job_name, d=depth,
                           n=total, eta_ms=int(m.arg))
                if self._on_horizon is not None:
                    cb, d, n, eta = self._on_horizon, depth, total, int(m.arg)
                    try:
                        self._run_cb(lambda: cb(d, n, eta))
                    except Exception:
                        # Best-effort staging: a pager bug degrades to
                        # "no staging", never a dead message loop.
                        log.warning("on_horizon callback failed",
                                    exc_info=True)
                continue
            with self._cv:
                if m.type == MsgType.LOCK_OK:
                    pass  # prefetch below, outside the lock
                elif m.type == MsgType.DROP_LOCK:
                    held = self._own_lock
                    self._own_lock = False
                    self._m["drops"].inc()
                    tev.record(tev.DROP_LOCK, self.job_name, held=held)
                    if held:
                        self._evict_and_release("drop")
                    else:
                        # Early release already in flight; don't send a
                        # second LOCK_RELEASED (it would cancel our own
                        # re-queued request at the scheduler).
                        self._need_lock = False
                        self._cv.notify_all()
                    continue
                elif m.type == MsgType.SCHED_ON:
                    self.scheduler_on = True
                    if self._need_lock:
                        self._send(MsgType.REQ_LOCK, self.priority)
                    self._cv.notify_all()
                    continue
                elif m.type == MsgType.SCHED_OFF:
                    self.scheduler_on = False
                    self._own_lock = False
                    self._need_lock = False
                    self._cv.notify_all()
                    continue
                else:
                    continue
            # LOCK_OK path: prefetch before unblocking submitters.
            # Co-residency note: under TPUSHARE_COADMIT this grant may
            # be CONCURRENT (another tenant also holds). Nothing here
            # needs to know — the fencing epoch is per-hold and a
            # demotion arrives as an ordinary DROP_LOCK — so the
            # runtime stays byte-identical either way.
            self._run_cb(self._prefetch)
            with self._cv:
                self._own_lock = True
                self._grant_epoch = parse_grant_epoch(m.job_name)
                self._grant_t = time.monotonic()
                self._m["acquires"].inc()
                tev.record(tev.LOCK_ACQUIRE, self.job_name,
                           runtime="python")
                self._need_lock = False
                # A grant follows a REQ_LOCK from a thread about to submit;
                # count it as activity so the idle checker cannot fire in
                # the window before that thread's first gated op.
                self._did_work = True
                self._cv.notify_all()

    def _release_loop(self) -> None:
        interval = float(os.environ.get("TPUSHARE_RELEASE_CHECK_S", "5"))
        busy_threshold_ms = 100  # ≙ reference client.c:466
        while not self._stop:
            with self._cv:
                self._cv.wait(timeout=interval)
                if self._stop:
                    return
                if not self.managed:
                    if os.environ.get("TPUSHARE_RECONNECT") == "1":
                        continue  # may come back via reconnect
                    return  # unmanaged is terminal without reconnect
                if not (self.scheduler_on and self._own_lock):
                    continue
                if self._did_work:
                    self._did_work = False
                    continue
            busy = False
            decided = False
            if self._busy_probe is not None:
                b = self._busy_probe()
                if b >= 0:
                    busy, decided = b > 0, True
            if not decided and self._timed_sync_ms is not None:
                ms = self._timed_sync_ms()
                busy = ms < 0 or ms >= busy_threshold_ms
            with self._cv:
                if not busy and self._own_lock and not self._did_work:
                    log.info("idle — releasing lock early")
                    self._own_lock = False
                    self._evict_and_release("idle")

    # -- public surface ----------------------------------------------------

    @property
    def owns_lock(self) -> bool:
        return self._own_lock

    def continue_with_lock(self) -> None:
        if getattr(self._in_callback, "active", False):
            return  # eviction path must not self-deadlock
        with self._cv:
            if not self.managed:
                return
            waited_from = None
            while self.scheduler_on and not self._own_lock and self.managed:
                if not self._need_lock:
                    self._need_lock = True
                    if waited_from is not None:
                        self.req_resends += 1
                    self._send(MsgType.REQ_LOCK, self.priority)
                if waited_from is None:
                    waited_from = time.monotonic()
                if self._req_retry_s > 0:
                    # Lost-frame insurance: the scheduler ignores
                    # duplicate REQ_LOCKs from a queued client, so if the
                    # original was swallowed (chaos drop) the retry
                    # enqueues us and otherwise changes nothing.
                    if not self._cv.wait(timeout=self._req_retry_s):
                        self._need_lock = False
                else:
                    self._cv.wait()
            if waited_from is not None:
                waited_s = time.monotonic() - waited_from
                self._m["gate_wait"].observe(waited_s)
                # The exact wait sample, into the event ring: the fleet
                # trace carries it to the QoS report's per-class
                # gate-wait percentiles.
                tev.record(tev.GATE_WAIT, self.job_name,
                           seconds=round(waited_s, 6))
            self._did_work = True

    def release_now(self) -> None:
        with self._cv:
            if not self.managed or not self._own_lock:
                return
            self._own_lock = False
            self._evict_and_release("explicit")

    def mark_activity(self) -> None:
        with self._cv:
            self._did_work = True

    def shutdown(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self.managed:
            try:
                self._link.sock.shutdown(2)
            except OSError:
                pass
            self._link.close()
        self.managed = False
        # Join the worker threads, each within SHUTDOWN_JOIN_S: only
        # a completed join guarantees no client thread is inside a CUDA
        # call when the interpreter finalizes. Both loops exit promptly
        # on _stop (the cv was notified; the socket was shut down), so
        # the residual wait is at most one in-flight sync/evict
        # callback. The JAX package joins without a bound, so a callback
        # wedged inside a device call hangs its process at exit; here
        # the join gives up, logs, and leaves the daemon thread to the
        # interpreter. Safe to call repeatedly / from atexit; never
        # joins the calling thread.
        for t in (getattr(self, "_msg_thread", None),
                  getattr(self, "_rel_thread", None)):
            if (t is not None and t.is_alive()
                    and t is not threading.current_thread()):
                t.join(timeout=SHUTDOWN_JOIN_S)
                if t.is_alive():
                    log.warning("client thread %s still running %.1f s "
                                "after shutdown; not waiting for it",
                                t.name, SHUTDOWN_JOIN_S)


def make_client(prefer_native: Optional[bool] = None, **callbacks):
    """Build the process's client runtime. Native by default; set
    ``TPUSHARE_PURE_PYTHON=1`` (or ``prefer_native=False``) to force the
    Python client. A missing library falls back to the Python client
    with a warning, as in the JAX package."""
    if prefer_native is None:
        prefer_native = os.environ.get("TPUSHARE_PURE_PYTHON") != "1"
    if prefer_native:
        lib = _default_lib_path()
        if lib.exists():
            return NativeClient(**callbacks)
        log.warning("native client library missing at %s — using the "
                    "pure-Python fallback", lib)
    callbacks.pop("lib_path", None)
    return PurePythonClient(**callbacks)
