"""Deterministic fault injection for the tpushare control plane.

The lease/arbitration story (scheduler revocation, fencing epochs,
reconnect backoff) is only trustworthy if every recovery path is
exercised on purpose. This module provides the three fault layers the
chaos tests compose:

1. **Wire faults** — ``TPUSHARE_CHAOS=drop:p,delay:ms,trunc:p,seed:N``
   wraps every :class:`~nvshare_tpu_torch.runtime.protocol.SchedulerLink`
   socket in a :class:`ChaosSocket` that deterministically (seeded RNG)
   drops, delays, or truncates outgoing frames. Faults apply to the
   client→scheduler direction only (each ``sendall`` is exactly one
   304-byte frame); a truncated frame desyncs the stream and the strict
   scheduler kills the connection — the hard-failure path. With the env
   unset, :func:`maybe_wrap_socket` returns the socket unchanged: zero
   overhead, zero behavior change.

2. **Process wedges** — :func:`wedge` / :func:`unwedge` / :func:`kill`
   SIGSTOP/SIGCONT/SIGKILL a tenant subprocess: the alive-but-wedged
   holder is exactly the failure the scheduler's lease revocation
   (``TPUSHARE_REVOKE_GRACE_S``) exists for.

3. **Scripted tenants** — ``python -m nvshare_tpu_torch.runtime.chaos
   --progress FILE`` runs a minimal gated workload (PurePythonClient, no
   torch import) that appends an auditable event log; tests reconstruct
   hold intervals and progress from it to assert the arbitration
   invariants (at most one holder, bounded starvation, peer progress
   past a wedged holder).

Progress-file line format (wall-clock ``time.time()`` seconds)::

    ID <t> <client_id-hex>   (re)registration observed
    M  <t> <0|1>             managed-state transition
    A  <t>                   lock acquisition observed at the gate
    G  <t0> <t1>             a gate call that actually blocked (>5 ms):
                             the per-tenant gate-wait samples the QoS
                             fairness assertions compute percentiles from
    W  <t0> <t1>             work window with the lock provably held
                             throughout (owned at both edges, no evict
                             between, managed)
    T  <t0> <t1>             work window without a provable hold
    E  <t>                   sync_and_evict ran (drop/idle/revocation)
    DONE <t>                 clean exit
"""

from __future__ import annotations

import contextlib
import os
import signal
import threading
import time
from dataclasses import dataclass
from typing import Optional

_ENV = "TPUSHARE_CHAOS"


@dataclass(frozen=True)
class ChaosConfig:
    """Parsed ``TPUSHARE_CHAOS`` spec. All fields default to inert."""

    drop_p: float = 0.0    # P(outgoing frame silently swallowed)
    delay_ms: float = 0.0  # fixed extra latency per outgoing frame
    trunc_p: float = 0.0   # P(outgoing frame truncated mid-frame)
    seed: int = 0          # RNG seed (deterministic fault schedule)

    @property
    def active(self) -> bool:
        return self.drop_p > 0 or self.delay_ms > 0 or self.trunc_p > 0

    @classmethod
    def parse(cls, spec: str) -> "ChaosConfig":
        """``"drop:0.1,delay:5,trunc:0.01,seed:7"`` → ChaosConfig.

        Unknown keys raise: this is a testing knob and a typo silently
        running the wrong experiment is worse than a crash.
        """
        kw: dict = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            key, _, val = part.partition(":")
            if key == "drop":
                kw["drop_p"] = float(val)
            elif key == "delay":
                kw["delay_ms"] = float(val)
            elif key == "trunc":
                kw["trunc_p"] = float(val)
            elif key == "seed":
                kw["seed"] = int(val)
            else:
                raise ValueError(f"unknown TPUSHARE_CHAOS key {key!r} "
                                 f"in {spec!r}")
        for p in ("drop_p", "trunc_p"):
            if not 0.0 <= kw.get(p, 0.0) <= 1.0:
                raise ValueError(f"TPUSHARE_CHAOS {p} must be in [0, 1]")
        return cls(**kw)

    @classmethod
    def from_env(cls) -> "ChaosConfig":
        spec = os.environ.get(_ENV, "")
        return cls.parse(spec) if spec else cls()


# Wrap ordinal: each ChaosSocket derives its RNG from (seed, ordinal) so
# a multi-connection process gets distinct but reproducible schedules.
_wrap_count = 0
_wrap_mu = threading.Lock()
# The process's fault counts over every link it has wrapped (a reconnect
# replaces the socket, and its stats with it).
_totals = {"links": 0, "sent": 0, "dropped": 0, "delayed": 0,
           "truncated": 0}


def process_stats() -> dict:
    """Frames sent, dropped, delayed and truncated over every chaos link
    this process opened (``links``), for a run's report."""
    with _wrap_mu:
        return dict(_totals)


class ChaosSocket:
    """Fault-injecting proxy over a connected stream socket.

    Only ``sendall`` is intercepted (each call carries one whole wire
    frame); every other attribute delegates to the wrapped socket, so
    the proxy is drop-in wherever a ``socket.socket`` is used.
    """

    def __init__(self, sock, config: ChaosConfig,
                 ordinal: Optional[int] = None):
        import random

        global _wrap_count
        if ordinal is None:
            with _wrap_mu:
                ordinal = _wrap_count
                _wrap_count += 1
        with _wrap_mu:
            _totals["links"] += 1
        self._sock = sock
        self.config = config
        self._rng = random.Random((config.seed << 16) ^ ordinal)
        self.stats = {"sent": 0, "dropped": 0, "delayed": 0,
                      "truncated": 0}

    def _count(self, key: str) -> None:
        self.stats[key] += 1
        with _wrap_mu:
            _totals[key] += 1

    def sendall(self, data: bytes) -> None:
        cfg = self.config
        if cfg.delay_ms > 0:
            self._count("delayed")
            time.sleep(cfg.delay_ms / 1000.0)
        roll = self._rng.random()
        if roll < cfg.drop_p:
            # Swallowed in flight: the peer never learns this frame
            # existed (lost REQ_LOCK → gate retry; lost LOCK_RELEASED →
            # lease revocation reclaims the device).
            self._count("dropped")
            return
        if roll < cfg.drop_p + cfg.trunc_p and len(data) > 1:
            # Mid-frame cut: desyncs the stream; the strict peer treats
            # the partial frame as garbage and kills the connection.
            self._count("truncated")
            self._sock.sendall(data[: len(data) // 2])
            return
        self._count("sent")
        self._sock.sendall(data)

    def __getattr__(self, name):
        return getattr(self._sock, name)


def maybe_wrap_socket(sock):
    """Wrap ``sock`` in a :class:`ChaosSocket` when ``$TPUSHARE_CHAOS``
    names active faults; otherwise return it unchanged."""
    cfg = ChaosConfig.from_env()
    if not cfg.active:
        return sock
    return ChaosSocket(sock, cfg)


@contextlib.contextmanager
def chaos_disabled():
    """Temporarily clear ``$TPUSHARE_CHAOS`` — observers (stats polls,
    collectors) in a chaos test must see the scheduler through a clean
    link or the measurement perturbs the experiment."""
    old = os.environ.pop(_ENV, None)
    try:
        yield
    finally:
        if old is not None:
            os.environ[_ENV] = old


# ------------------------------------------------------- process wedges

def _pid(proc_or_pid) -> int:
    return int(getattr(proc_or_pid, "pid", proc_or_pid))


def wedge(proc_or_pid) -> None:
    """SIGSTOP: alive but unresponsive — the deadlocked-interpreter /
    stuck-fence / paused-pod failure the lease revocation targets."""
    os.kill(_pid(proc_or_pid), signal.SIGSTOP)


def unwedge(proc_or_pid) -> None:
    """SIGCONT: the wedged process resumes — and must discover its lease
    is gone (dead link → evict → reconnect), not keep computing."""
    os.kill(_pid(proc_or_pid), signal.SIGCONT)


def kill(proc_or_pid) -> None:
    """SIGKILL: the classic death path (fd close at the scheduler)."""
    os.kill(_pid(proc_or_pid), signal.SIGKILL)


# ---------------------------------------------------- scripted tenants

def spawn_tenant(name: str, progress: os.PathLike, seconds: float,
                 env: Optional[dict] = None, work_ms: int = 50,
                 python: Optional[str] = None, native: bool = False):
    """Start a scripted tenant subprocess (see module docstring for the
    progress-file format). Returns the ``subprocess.Popen``.

    ``native=True`` runs the tenant on the NATIVE client runtime
    (libtpushare_client.so via ctypes) instead of PurePythonClient, so
    the chaos matrix — wire faults, wedges, scheduler SIGKILL/restart —
    also covers unmodified-app tenants (the C runtime's own
    ``TPUSHARE_CHAOS`` fault layer)."""
    import subprocess
    import sys

    cmd = [python or sys.executable, "-m", "nvshare_tpu_torch.runtime.chaos",
           "--progress", str(progress), "--seconds", str(seconds),
           "--work-ms", str(work_ms), "--name", name]
    if native:
        cmd.append("--native")
    full_env = dict(os.environ)
    full_env.update(env or {})
    return subprocess.Popen(cmd, env=full_env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.STDOUT)


def read_progress(path) -> list:
    """Parse a progress file into ``[(tag, [floats/strs...]), ...]``
    (tolerant of a torn final line from a killed tenant)."""
    out = []
    try:
        text = open(path, "r").read()
    except OSError:
        return out
    for line in text.splitlines():
        parts = line.split()
        if not parts:
            continue
        fields = []
        for p in parts[1:]:
            try:
                fields.append(float(p))
            except ValueError:
                fields.append(p)
        out.append((parts[0], fields))
    return out


def count_ticks(progress) -> int:
    """Work windows (held or not) a tenant has logged — its progress."""
    return sum(1 for tag, _ in read_progress(progress)
               if tag in ("W", "T"))


def gate_waits(progress) -> list:
    """The ``G`` lines as wait durations (seconds) — the exact samples
    behind the per-class gate-wait percentile assertions."""
    return [f[1] - f[0] for tag, f in read_progress(progress)
            if tag == "G" and len(f) >= 2]


def wedge_current_holder(procs: dict, get_summary, retries: int = 3,
                         settle_s: float = 0.3, wait_s: float = 15.0):
    """SIGSTOP the current lock holder among ``procs`` ({name: Popen}).

    The grant rotates every quantum, so the holder read can race the
    SIGSTOP: after freezing, confirm the summary still names the frozen
    tenant (a frozen holder cannot release) and retry the race
    otherwise. ``get_summary`` returns a parsed GET_STATS summary dict.
    Returns ``(holder_name, t_wedge)`` or ``(None, None)``.
    """
    for _ in range(retries):
        deadline = time.monotonic() + wait_s
        cand = None
        while time.monotonic() < deadline:
            s = get_summary()
            if s.get("held") == 1 and s.get("holder") in procs:
                cand = s["holder"]
                break
            time.sleep(0.1)
        if cand is None:
            return None, None
        wedge(procs[cand])
        t_wedge = time.time()
        time.sleep(settle_s)
        s = get_summary()
        if s.get("holder") == cand and s.get("held") == 1:
            return cand, t_wedge
        unwedge(procs[cand])  # raced a handoff; try again
    return None, None


def recovered_after(progress, t_wedge: float) -> bool:
    """True once a revived tenant's log shows the full recovery arc:
    it evicted after the wedge (``E`` line past ``t_wedge``) and
    re-registered (a second ``ID`` line)."""
    ev = read_progress(progress)
    ids = [f for tag, f in ev if tag == "ID" and f]
    evicts = [f[0] for tag, f in ev
              if tag == "E" and f and f[0] > t_wedge]
    return len(ids) >= 2 and bool(evicts)


def hold_windows(events: list) -> list:
    """The ``W`` lines — [(t0, t1), ...] windows the tenant provably
    held the lock through."""
    return [(f[0], f[1]) for tag, f in events
            if tag == "W" and len(f) >= 2]


def windows_overlap(a: list, b: list, tolerance_s: float = 0.05) -> bool:
    """True when any window in ``a`` overlaps any in ``b`` by more than
    ``tolerance_s`` (wall clocks of same-host processes)."""
    for a0, a1 in a:
        for b0, b1 in b:
            if min(a1, b1) - max(a0, b0) > tolerance_s:
                return True
    return False


def _tenant_main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m nvshare_tpu_torch.runtime.chaos",
        description="Scripted chaos-test tenant (gated workload with an "
                    "auditable progress log).")
    ap.add_argument("--progress", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--work-ms", type=int, default=50)
    ap.add_argument("--name", default=None)
    ap.add_argument("--native", action="store_true",
                    help="drive the NATIVE client runtime "
                         "(libtpushare_client.so) instead of the "
                         "pure-Python client — same progress log, so "
                         "the chaos matrix covers unmodified-app "
                         "tenants too")
    args = ap.parse_args(argv)

    from nvshare_tpu_torch.runtime.client import NativeClient, PurePythonClient

    out = open(args.progress, "a", buffering=1)
    mu = threading.Lock()

    def emit(tag: str, *fields) -> None:
        with mu:  # the evict callback fires from the client's msg thread
            out.write(" ".join([tag] + [
                f"{f:.6f}" if isinstance(f, float) else str(f)
                for f in fields]) + "\n")

    evictions = {"n": 0}

    def on_evict() -> None:
        evictions["n"] += 1
        emit("E", time.time())

    if args.native:
        # The native runtime takes its identity from the environment
        # (TPUSHARE_JOB_NAME / HOSTNAME), not a constructor argument.
        if args.name:
            os.environ["TPUSHARE_JOB_NAME"] = args.name
        client = NativeClient(sync_and_evict=on_evict)
    else:
        client = PurePythonClient(sync_and_evict=on_evict,
                                  job_name=args.name)
    emit("ID", time.time(), f"{client.client_id:x}")
    emit("M", time.time(), int(client.managed))
    last_id, last_managed = client.client_id, client.managed
    owned_prev = False
    deadline = time.monotonic() + args.seconds
    try:
        while time.monotonic() < deadline:
            tg0 = time.time()
            client.continue_with_lock()
            tg1 = time.time()
            if tg1 - tg0 > 0.005:  # the gate actually blocked
                emit("G", tg0, tg1)
            owned0 = client.owns_lock
            if owned0 and not owned_prev:
                emit("A", time.time())
            owned_prev = owned0
            n0 = evictions["n"]
            t0 = time.time()
            time.sleep(args.work_ms / 1000.0)  # the "compute" window
            t1 = time.time()
            # Claim the window as a hold only when nothing moved under
            # us: owned at both edges, no evict ran, still managed, AND
            # the window took about as long as it should — a window
            # stretched far past work_ms means we were wedged
            # (SIGSTOP'd) inside it and the edge checks raced the
            # revived message thread; never claim those.
            if (owned0 and client.owns_lock and evictions["n"] == n0
                    and client.managed
                    and (t1 - t0) <= args.work_ms / 1000.0 * 3 + 0.05):
                emit("W", t0, t1)
            else:
                emit("T", t0, t1)
                owned_prev = client.owns_lock
            if client.client_id != last_id:
                last_id = client.client_id
                emit("ID", time.time(), f"{last_id:x}")
            if client.managed != last_managed:
                last_managed = client.managed
                emit("M", time.time(), int(last_managed))
    finally:
        client.shutdown()
        emit("DONE", time.time())
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_tenant_main())
