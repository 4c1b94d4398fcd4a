"""Fixed-size event ring for trace events on the sharing hot paths.

Every lock transition, handoff, fault batch, eviction batch, prefetch and
OOM retry drops one timestamped :class:`Event` into a preallocated ring.
Recording is one lock acquire + one slot write — no allocation beyond the
event tuple itself — so instrumenting the DROP_LOCK/LOCK_OK paths costs
nanoseconds against their millisecond-scale DMA work. When the ring wraps,
the oldest events are overwritten; telemetry is a window, not a log.

A copy of the JAX package's event ring: the same kinds and fields, so a
trace tool reads the events of either package.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

# Event kinds (string constants, not an enum: they go straight into JSON
# and log lines, and adding one must never require a migration).
LOCK_ACQUIRE = "LOCK_ACQUIRE"
LOCK_RELEASE = "LOCK_RELEASE"
DROP_LOCK = "DROP_LOCK"
FAULT = "FAULT"
EVICT = "EVICT"
PREFETCH = "PREFETCH"
HANDOFF = "HANDOFF"
OOM_RETRY = "OOM_RETRY"
#: Proactive pager: one background writeback batch (dirty device arrays
#: trickled to their host shadows during the holder's compute phase).
WRITEBACK = "WRITEBACK"
#: Proactive pager: LOCK_NEXT advisory received — this tenant is first in
#: line for the next grant and staged/planned its prefetch host-side.
ON_DECK = "ON_DECK"
#: Gated work actually blocked waiting for the device lock; ``seconds``
#: carries the wait. Emitted only when the gate really waited (the
#: holding-fast-path is silent), so the fleet trace carries the exact
#: samples the QoS report's per-class gate-wait percentiles replay.
GATE_WAIT = "GATE_WAIT"
#: Published grant horizon: a GRANT_HORIZON advisory received — this
#: tenant is one of the next K predicted holders (``d`` = 1-based
#: position, ``eta_ms`` = best-effort time to its predicted grant) and
#: staged depth-proportionally against the published schedule.
HORIZON = "HORIZON"

KINDS = (LOCK_ACQUIRE, LOCK_RELEASE, DROP_LOCK, FAULT, EVICT, PREFETCH,
         HANDOFF, OOM_RETRY, WRITEBACK, ON_DECK, GATE_WAIT, HORIZON)

_DEFAULT_CAPACITY = 65536


class Event:
    """One trace event. ``ts`` is time.monotonic() (seconds); ``wall`` is
    the matching time.time() so exports can be aligned across processes."""

    __slots__ = ("seq", "ts", "wall", "kind", "who", "args")

    def __init__(self, seq: int, ts: float, wall: float, kind: str,
                 who: str, args: Optional[dict]):
        self.seq = seq
        self.ts = ts
        self.wall = wall
        self.kind = kind
        self.who = who
        self.args = args

    def as_dict(self) -> dict:
        d = {"seq": self.seq, "ts": self.ts, "wall": self.wall,
             "kind": self.kind, "who": self.who}
        if self.args:
            d["args"] = dict(self.args)
        return d

    def __repr__(self):
        return (f"Event({self.seq}, {self.kind}, who={self.who!r}, "
                f"ts={self.ts:.6f})")


class EventRing:
    """Preallocated circular buffer of :class:`Event`."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            try:
                capacity = int(os.environ.get("TPUSHARE_TRACE_EVENTS",
                                              _DEFAULT_CAPACITY))
            except ValueError:
                capacity = _DEFAULT_CAPACITY
        self.capacity = max(int(capacity), 1)
        self._slots: list = [None] * self.capacity
        self._lock = threading.Lock()
        self._seq = 0          # total events ever recorded
        self._dropped = 0      # events overwritten by wraparound

    def record(self, kind: str, who: str = "",
               args: Optional[dict] = None) -> None:
        ts = time.monotonic()
        wall = time.time()
        with self._lock:
            seq = self._seq
            self._seq += 1
            idx = seq % self.capacity
            if self._slots[idx] is not None:
                self._dropped += 1
            self._slots[idx] = Event(seq, ts, wall, kind, who, args)

    def __len__(self) -> int:
        with self._lock:
            return min(self._seq, self.capacity)

    @property
    def total_recorded(self) -> int:
        with self._lock:
            return self._seq

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def snapshot(self) -> list:
        """Events oldest-first (a consistent copy; recording continues)."""
        with self._lock:
            n = min(self._seq, self.capacity)
            start = self._seq - n
            return [self._slots[(start + i) % self.capacity]
                    for i in range(n)]

    def clear(self) -> None:
        with self._lock:
            self._slots = [None] * self.capacity
            self._seq = 0
            self._dropped = 0


_ring: Optional[EventRing] = None
_ring_lock = threading.Lock()


def ring() -> EventRing:
    """The process-global event ring (singleton)."""
    global _ring
    with _ring_lock:
        if _ring is None:
            _ring = EventRing()
        return _ring


def record(kind: str, who: str = "", **args) -> None:
    """Record one event on the global ring (the one-liner the hot paths
    call). Never raises — a telemetry bug must not take down paging."""
    try:
        ring().record(kind, who, args or None)
    except Exception:
        pass


def reset_ring() -> None:
    """Testing hook: drop the singleton ring."""
    global _ring
    with _ring_lock:
        _ring = None
