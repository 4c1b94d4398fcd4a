"""Pluggable paging policies for the proactive pager.

A copy of ``nvshare_tpu/pager/policy.py`` (pure Python: the same
orderings from the same clocks, so the two packages can be compared).

A policy answers two ordering questions the engine asks:

  * **writeback_order(dirty)** — which dirty resident arrays to trickle to
    their host shadows first during the holder's compute phase;
  * **prefetch_order(candidates)** — which evicted arrays to page back in
    first when this tenant is on deck / freshly granted.

Selected via ``$TPUSHARE_PAGER_POLICY``:

  * ``lru`` (default) — recency from the arena's existing touch clock:
    write back the coldest dirty arrays first (least likely to be
    superseded by a donation before the handoff), prefetch the hottest
    first.
  * ``lfu`` — frequency: the policy counts touches per array; rarely-used
    arrays are written back first and frequently-used ones prefetched
    first. Wins over LRU when a workload periodically sweeps cold data
    (the sweep pollutes recency but not frequency).
  * ``wss`` — working-set predictor: replays this tenant's recent access
    history against the quantum lengths observed in the telemetry event
    ring (LOCK_RELEASE spans) to predict which arrays the next quantum
    will actually touch, and prefetches those ahead of everything else.

Policies only ever ORDER arrays the engine hands them — they never page,
evict, or mutate residency themselves, so a buggy policy degrades paging
order, not correctness.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from statistics import median
from typing import Sequence

from nvshare_tpu_torch.telemetry import events as tev
from nvshare_tpu_torch.utils import env_float, env_int, get_logger

log = get_logger("pager.policy")

POLICIES = ("lru", "lfu", "wss")


class PagerPolicy:
    """Base policy: LRU ordering from the arena's touch clock."""

    name = "lru"

    def on_touch(self, va) -> None:
        """Called (under the arena lock) whenever ``va`` is touched."""

    def kv_resident(self, va) -> bool:
        """Cross-quantum phase detection: is ``va`` KV-cache-class —
        touched steadily across quanta, so mid-decode eviction would be
        paid back on the very next token? Base policies keep no
        inter-touch history and never classify (the explicit
        ``phase_hint`` tag still applies arena-side)."""
        return False

    def writeback_order(self, dirty: Sequence) -> list:
        # Coldest first: hot arrays are the likeliest to be consumed by a
        # donation (making their writeback wasted work) — let them age.
        return sorted(dirty, key=lambda va: va._last_touch)

    def prefetch_order(self, candidates: Sequence) -> list:
        # Hottest first: the first ops after a grant hit the recent set.
        return sorted(candidates, key=lambda va: -va._last_touch)


class LRUPolicy(PagerPolicy):
    name = "lru"


class LFUPolicy(PagerPolicy):
    """Frequency ordering. Counts live alongside the arrays (weak keys),
    so a discarded array drops out without an unregister protocol."""

    name = "lfu"

    def __init__(self):
        self._mu = threading.Lock()
        self._counts: "weakref.WeakKeyDictionary" = (
            weakref.WeakKeyDictionary())

    def on_touch(self, va) -> None:
        with self._mu:
            self._counts[va] = self._counts.get(va, 0) + 1

    def _count(self, va) -> int:
        with self._mu:
            return self._counts.get(va, 0)

    def writeback_order(self, dirty: Sequence) -> list:
        return sorted(dirty, key=lambda va: (self._count(va),
                                             va._last_touch))

    def prefetch_order(self, candidates: Sequence) -> list:
        return sorted(candidates, key=lambda va: (-self._count(va),
                                                  -va._last_touch))


class WSSPolicy(PagerPolicy):
    """Working-set predictor.

    Keeps a bounded access history ``(weakref(array), ts)`` and replays it
    against the quantum lengths this tenant actually experienced: the
    telemetry event ring records every LOCK_RELEASE with its held-seconds,
    so the predictor's window is the median of the recent holds (falling
    back to ``$TPUSHARE_WSS_WINDOW_S`` before any history exists). The
    predicted working set — arrays touched within one window of the last
    access — is prefetched ahead of everything else; arrays outside it
    (e.g. a cold validation set swept once an epoch) wait for demand
    faults instead of burning the prefetch budget.
    """

    name = "wss"

    def __init__(self, client_name: str = ""):
        self.client_name = client_name
        self._mu = threading.Lock()
        self._history: deque = deque(
            maxlen=max(env_int("TPUSHARE_WSS_HISTORY", 4096), 16))
        self._wss_ewma: float = 0.0
        # Per-array inter-touch EWMA: [last_ts, ewma_s, touches,
        # first_ts] per live array, weak keys so a dropped array's book
        # collects with it. A small, STEADY inter-touch interval
        # SUSTAINED across at least one quantum window is the KV-cache
        # signature — a one-shot burst (many touches inside one op, a
        # sweep) is not, however recently or often it was touched.
        self._itt: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._kv_min_touches = max(
            env_int("TPUSHARE_WSS_KV_TOUCHES", 4), 2)
        # window_s() scans a telemetry ring snapshot; the KV classifier
        # runs per candidate on the eviction path, so the window is
        # cached briefly (the median of recent holds moves slowly).
        self._win_cache_at = -1.0
        self._win_cache = 0.0

    def on_touch(self, va) -> None:
        now = time.monotonic()
        with self._mu:
            self._history.append((weakref.ref(va), now))
            book = self._itt.get(va)
            if book is None:
                self._itt[va] = [now, -1.0, 1, now]
            else:
                gap = now - book[0]
                book[0] = now
                book[1] = gap if book[1] < 0 else (0.7 * book[1]
                                                   + 0.3 * gap)
                book[2] += 1

    def inter_touch_ewma_s(self, va) -> float:
        """The smoothed inter-touch interval for ``va`` (-1 with fewer
        than two touches observed)."""
        with self._mu:
            book = self._itt.get(va)
            return float(book[1]) if book is not None else -1.0

    def kv_resident(self, va) -> bool:
        """KV-hot classification: at least ``TPUSHARE_WSS_KV_TOUCHES``
        touches, a steady inter-touch EWMA no longer than the predicted
        quantum window, AND a first-to-last touch span of at least one
        window — the array is re-touched every quantum ACROSS quanta
        (cross-quantum residency), so evicting it mid-decode is paid
        back on the next token. The span floor keeps a single op that
        touches an array many times in one burst from classifying."""
        with self._mu:
            book = self._itt.get(va)
        if book is None or book[2] < self._kv_min_touches or book[1] < 0:
            return False
        win = self.window_s()
        return book[1] <= win and (book[0] - book[3]) >= win

    def kv_resident_bytes(self) -> int:
        """Aggregate bytes currently classified KV-hot (the serving A/B
        observable for the inter-touch predictor)."""
        with self._mu:
            cands = list(self._itt.keys())
        return sum(va.nbytes for va in cands if self.kv_resident(va))

    def window_s(self) -> float:
        """Predicted next-quantum length: median of this client's recent
        lock holds from the event ring, else the env fallback. Cached
        for 250 ms — the KV classifier calls this per candidate inside
        the arena lock on the eviction path, and a fresh ring snapshot
        per array would make eviction O(candidates x ring)."""
        now = time.monotonic()
        if self._win_cache_at >= 0 and now - self._win_cache_at < 0.25:
            return self._win_cache
        holds = []
        try:
            for ev in reversed(tev.ring().snapshot()):
                if (ev.kind == tev.LOCK_RELEASE
                        and ev.who == self.client_name and ev.args
                        and "seconds" in ev.args):
                    holds.append(float(ev.args["seconds"]))
                    if len(holds) >= 8:
                        break
        except Exception:  # telemetry must never break paging policy
            holds = []
        if holds:
            win = max(float(median(holds)), 0.05)
        else:
            win = env_float("TPUSHARE_WSS_WINDOW_S", 30.0)
        self._win_cache_at = now
        self._win_cache = win
        return win

    def predicted_ids(self) -> set:
        with self._mu:
            history = list(self._history)
        if not history:
            return set()
        cutoff = history[-1][1] - self.window_s()
        out = set()
        for ref, ts in history:
            if ts < cutoff:
                continue
            va = ref()
            if va is not None:
                out.add(id(va))
        return out

    def prefetch_order(self, candidates: Sequence) -> list:
        # Three tiers: KV-class first (tagged or inter-touch-detected —
        # the first decode step after a grant reads the whole cache),
        # then the predicted working set, then everything else.
        predicted = self.predicted_ids()
        kv, hot, cold = [], [], []
        for va in candidates:
            if getattr(va, "_phase_hint", None) == "kv" or \
                    self.kv_resident(va):
                kv.append(va)
            elif id(va) in predicted:
                hot.append(va)
            else:
                cold.append(va)
        for tier in (kv, hot, cold):
            tier.sort(key=lambda va: -va._last_touch)
        return kv + hot + cold

    def observed_wss_bytes(self) -> int:
        """Byte size of the currently predicted working set: unique live
        arrays touched within one window of the latest access."""
        with self._mu:
            history = list(self._history)
        if not history:
            return 0
        cutoff = history[-1][1] - self.window_s()
        seen: set = set()
        total = 0
        for ref, ts in history:
            if ts < cutoff:
                continue
            va = ref()
            if va is None or id(va) in seen:
                continue
            seen.add(id(va))
            total += va.nbytes
        return total

    def wss_ewma_bytes(self) -> int:
        """Smoothed observed working-set size. The pager exports it as
        the ``tpushare_wss_bytes`` gauge and the fleet streamer rides it
        into the ``k=MET`` push as the optional ``wss=`` token — a
        tighter residency demand estimate than ``max(res, virt)`` for
        the scheduler's co-admission controller (which falls back to the
        conservative estimate whenever the token is absent)."""
        cur = float(self.observed_wss_bytes())
        with self._mu:
            self._wss_ewma = (cur if self._wss_ewma <= 0
                              else 0.7 * self._wss_ewma + 0.3 * cur)
            return int(self._wss_ewma)


def make_policy(name: str, client_name: str = "") -> PagerPolicy:
    """Policy factory for ``$TPUSHARE_PAGER_POLICY``; unknown names warn
    and fall back to LRU (a typo must not disable proactive paging)."""
    name = (name or "lru").strip().lower()
    if name == "lfu":
        return LFUPolicy()
    if name == "wss":
        return WSSPolicy(client_name)
    if name != "lru":
        log.warning("unknown TPUSHARE_PAGER_POLICY=%r — using lru", name)
    return LRUPolicy()
