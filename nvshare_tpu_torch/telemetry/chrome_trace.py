"""Chrome ``trace_event`` JSON export of the telemetry event ring.

Renders a co-location run as a timeline loadable in ``chrome://tracing``
or https://ui.perfetto.dev: one track (tid) per tenant, LOCK_ACQUIRE →
LOCK_RELEASE as complete ("X") spans, everything else (FAULT/EVICT/
PREFETCH/HANDOFF/DROP_LOCK/OOM_RETRY) as instant ("i") marks on the
owning tenant's track. Non-overlap of two tenants' lock spans IS the
paper's serialization claim, now visible instead of inferred from step
timestamps.

Format reference: the Trace Event Format spec (the ``traceEvents`` array
with ph/ts/dur/pid/tid/name/args; timestamps in microseconds).
"""

from __future__ import annotations

import json
from typing import IO, Optional, Union

from nvshare_tpu_torch.telemetry import events as ev

_PID = 1  # one process per export; pid only namespaces tid in the UI


def build_trace(ring: Optional[ev.EventRing] = None) -> dict:
    """Ring -> {"traceEvents": [...], ...} (pure transform, no I/O)."""
    ring = ring if ring is not None else ev.ring()
    evs = ring.snapshot()
    out = []
    open_spans: dict = {}  # who -> acquire Event
    if evs:
        t0 = evs[0].ts
        # Name the tracks once (Perfetto shows these instead of raw tids).
        seen = []
        for e in evs:
            if e.who and e.who not in seen:
                seen.append(e.who)
        for i, who in enumerate(seen):
            out.append({"ph": "M", "pid": _PID, "tid": i + 1,
                        "name": "thread_name", "args": {"name": who}})
        tids = {who: i + 1 for i, who in enumerate(seen)}
    else:
        t0 = 0.0
        tids = {}

    def us(ts: float) -> float:
        return round((ts - t0) * 1e6, 3)

    for e in evs:
        tid = tids.get(e.who, 0)
        if e.kind == ev.LOCK_ACQUIRE:
            # A duplicate acquire (ring wrapped past the release) closes
            # the dangling span at the new acquire so spans never nest.
            prev = open_spans.pop(e.who, None)
            if prev is not None:
                out.append({"ph": "X", "ts": us(prev.ts),
                            "dur": max(us(e.ts) - us(prev.ts), 0.0),
                            "pid": _PID, "tid": tid, "name": "device-lock",
                            "args": prev.args or {}})
            open_spans[e.who] = e
        elif e.kind == ev.LOCK_RELEASE:
            acq = open_spans.pop(e.who, None)
            if acq is None:
                continue  # release with no visible acquire (wrapped away)
            args = dict(acq.args or {})
            args.update(e.args or {})
            out.append({"ph": "X", "ts": us(acq.ts),
                        "dur": max(us(e.ts) - us(acq.ts), 0.0),
                        "pid": _PID, "tid": tid, "name": "device-lock",
                        "args": args})
        else:
            out.append({"ph": "i", "s": "t", "ts": us(e.ts), "pid": _PID,
                        "tid": tid, "name": e.kind,
                        "args": e.args or {}})
    # Spans still open at snapshot time: emit begin events so the
    # timeline shows the live holder.
    for who, acq in open_spans.items():
        out.append({"ph": "B", "ts": us(acq.ts), "pid": _PID,
                    "tid": tids.get(who, 0), "name": "device-lock",
                    "args": acq.args or {}})
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "nvshare_tpu_torch.telemetry",
            "events_dropped_by_ring": ring.dropped,
        },
    }


def export_chrome_trace(dest: Union[str, IO[str]],
                        ring: Optional[ev.EventRing] = None) -> dict:
    """Write the trace JSON to a path or file object; returns the dict."""
    trace = build_trace(ring)
    if hasattr(dest, "write"):
        json.dump(trace, dest)
    else:
        with open(dest, "w", encoding="utf-8") as f:
            json.dump(trace, f)
    return trace


def lock_spans(trace: dict) -> dict:
    """{track_name: [(start_us, end_us), ...]} for the device-lock spans —
    the helper tests/benches use to assert two tenants never overlap."""
    names = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            names[e["tid"]] = e["args"]["name"]
    spans: dict = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("name") == "device-lock":
            who = names.get(e["tid"], str(e["tid"]))
            spans.setdefault(who, []).append(
                (e["ts"], e["ts"] + e["dur"]))
    for v in spans.values():
        v.sort()
    return spans


def spans_overlap(a: list, b: list, tolerance_us: float = 0.0) -> bool:
    """True if any span in ``a`` overlaps any span in ``b`` by more than
    ``tolerance_us`` (merged-sweep, O(n log n))."""
    marked = sorted([(s, e, 0) for s, e in a] + [(s, e, 1) for s, e in b])
    last_end = {0: -1.0, 1: -1.0}
    for s, e, side in marked:
        other_end = last_end[1 - side]
        if s < other_end - tolerance_us:
            return True
        last_end[side] = max(last_end[side], e)
    return False
