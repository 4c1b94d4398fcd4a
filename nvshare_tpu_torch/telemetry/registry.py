"""Thread-safe metrics registry: counters, gauges, histograms with labels.

Stdlib-only by design (the telemetry subsystem must never add a hard
dependency): the API is a deliberately small subset of prometheus_client's
— ``registry().counter(...).labels(client="job-a").inc()`` — backed by
plain dicts and locks. A copy of the JAX package's registry, so both
packages expose the same metric families.

Concurrency model: one lock per metric family guards child creation and
every sample mutation. Hot-path increments are therefore one lock
acquire + one float add — cheap enough for the paging/gating paths, whose
own arena locks dominate by orders of magnitude.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

# Default buckets tuned for lock-hold / gate-wait / handoff durations in
# seconds: sub-millisecond gating noise up to multi-minute quanta.
DEFAULT_BUCKETS = (0.001, 0.005, 0.025, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                   10.0, 30.0, 60.0, 120.0, 300.0, math.inf)

LabelKey = Tuple[str, ...]


class _Child:
    """One labeled time series of a metric family."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class CounterChild(_Child):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self._value += amount


class GaugeChild(_Child):
    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount


class HistogramChild:
    __slots__ = ("_lock", "buckets", "counts", "sum", "count")

    def __init__(self, lock: threading.Lock, buckets: Sequence[float]):
        self._lock = lock
        self.buckets = tuple(buckets)
        self.counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        with self._lock:
            self.sum += value
            self.count += 1
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    self.counts[i] += 1
                    break

    def snapshot_state(self) -> tuple:
        """(sum, count, [(upper_bound, cumulative_count), ...]) read under
        ONE lock hold — exporters must use this, not the fields piecewise,
        or a concurrent observe() lands between reads and the exposed
        _count disagrees with the +Inf bucket (breaking the Prometheus
        histogram invariant consumers rely on)."""
        with self._lock:
            out, acc = [], 0
            for ub, c in zip(self.buckets, self.counts):
                acc += c
                out.append((ub, acc))
            return self.sum, self.count, out

    def cumulative(self) -> list:
        """[(upper_bound, cumulative_count), ...] snapshot."""
        return self.snapshot_state()[2]


class MetricFamily:
    """A named metric with a fixed label schema and one child per label
    combination. ``labels()`` with no labelnames returns the single
    anonymous child, so unlabeled metrics read naturally."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[LabelKey, object] = {}

    def _new_child(self):
        raise NotImplementedError

    def labels(self, *labelvalues, **labelkw):
        if labelkw:
            if labelvalues:
                raise ValueError("pass label values positionally OR by "
                                 "keyword, not both")
            try:
                labelvalues = tuple(labelkw[k] for k in self.labelnames)
            except KeyError as e:
                raise ValueError(f"missing label {e} for {self.name}")
        if len(labelvalues) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, got "
                f"{labelvalues!r}")
        key = tuple(str(v) for v in labelvalues)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child()
                self._children[key] = child
            return child

    # Unlabeled convenience: counter.inc() == counter.labels().inc()
    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def dec(self, amount: float = 1.0) -> None:
        self.labels().dec(amount)

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    def samples(self) -> Iterable[Tuple[LabelKey, object]]:
        with self._lock:
            return list(self._children.items())

    def remove(self, *labelvalues) -> None:
        """Drop one labeled series (a retired tenant's gauge must stop
        being exported, not freeze at its last value). No-op if absent."""
        key = tuple(str(v) for v in labelvalues)
        with self._lock:
            self._children.pop(key, None)


class Counter(MetricFamily):
    kind = "counter"

    def _new_child(self):
        return CounterChild(self._lock)


class Gauge(MetricFamily):
    kind = "gauge"

    def _new_child(self):
        return GaugeChild(self._lock)


class Histogram(MetricFamily):
    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        bl = list(buckets)
        if not bl:
            raise ValueError("histogram needs at least one bucket")
        if bl[-1] != math.inf:
            bl.append(math.inf)
        if bl != sorted(bl):
            raise ValueError("histogram buckets must be sorted")
        self.buckets = tuple(bl)

    def _new_child(self):
        return HistogramChild(self._lock, self.buckets)


class Registry:
    """Process-wide metric store.

    ``counter/gauge/histogram`` are get-or-create: calling twice with the
    same name returns the same family (so modules can declare their
    metrics independently), but a name re-declared with a different type
    or label schema is a programming error and raises.

    ``add_collector(fn)`` registers a zero-arg callable invoked before
    every snapshot/exposition — the hook scrape-time gauges (arena
    residency, queue depths) use so their values are current without the
    hot path paying for gauge writes.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, MetricFamily] = {}
        self._collectors: list = []

    def _get_or_create(self, cls, name: str, help: str, labelnames, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or (
                        fam.labelnames != tuple(labelnames)):
                    raise ValueError(
                        f"metric {name!r} re-declared with a different "
                        f"type/labels ({fam.kind}{fam.labelnames} vs "
                        f"{cls.kind}{tuple(labelnames)})")
                buckets = kw.get("buckets")
                if buckets is not None and isinstance(fam, Histogram):
                    bl = list(buckets)
                    if bl and bl[-1] != math.inf:
                        bl.append(math.inf)
                    if tuple(bl) != fam.buckets:
                        raise ValueError(
                            f"histogram {name!r} re-declared with "
                            f"different buckets ({fam.buckets} vs "
                            f"{tuple(bl)}) — observations would land in "
                            f"the first declarer's layout")
                return fam
            fam = cls(name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def add_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._collectors.append(fn)

    def collect(self) -> list:
        """Run scrape-time collectors, then return the family list.
        A collector that raises is dropped — loudly — so telemetry never
        takes the data path down, but a vanished gauge source is
        diagnosable from the log instead of silently disappearing."""
        with self._lock:
            collectors = list(self._collectors)
        dead = []
        for fn in collectors:
            try:
                fn()
            except Exception:
                import logging

                logging.getLogger("tpushare.telemetry").warning(
                    "dropping scrape collector %r after it raised; its "
                    "gauges will stop updating", fn, exc_info=True)
                dead.append(fn)
        if dead:
            with self._lock:
                for fn in dead:
                    try:
                        self._collectors.remove(fn)
                    except ValueError:
                        pass
        with self._lock:
            return list(self._families.values())

    def snapshot(self) -> dict:
        """{metric_name: {label_tuple_or_(): value}} — counters/gauges as
        floats, histograms as {"sum": s, "count": n, "buckets": [...]}.
        The structured view bench tooling reads (the replacement for
        scraping ``VirtualHBM.stats`` by hand)."""
        out = {}
        for fam in self.collect():
            series = {}
            for key, child in fam.samples():
                if isinstance(child, HistogramChild):
                    hsum, hcount, buckets = child.snapshot_state()
                    series[key] = {"sum": hsum, "count": hcount,
                                   "buckets": buckets}
                else:
                    series[key] = child.value
            out[fam.name] = series
        return out


_registry: Optional[Registry] = None
_registry_lock = threading.Lock()


def registry() -> Registry:
    """The process-global registry (singleton)."""
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = Registry()
        return _registry


def reset_registry() -> None:
    """Testing hook: drop the singleton. Modules holding direct family
    references keep mutating the old one — re-wire after calling this."""
    global _registry
    with _registry_lock:
        _registry = None
