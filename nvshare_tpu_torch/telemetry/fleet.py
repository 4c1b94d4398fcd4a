"""Fleet observability plane: cross-tenant trace streaming, fairness
accounting, and the merged fleet timeline.

Telemetry is per-process — each tenant owns its registry, event ring
and monotonic clock, so no single artifact shows who held the
device, who starved, and where each handoff's milliseconds went. This
module closes that gap using the scheduler as the one vantage point every
tenant already shares (the gpu_ext argument: the arbiter is the right
place for cross-client introspection):

  * **streaming** — :class:`FleetStreamer` forwards the local event ring
    (and a compact per-arena metric snapshot) to the scheduler as
    ``TELEMETRY_PUSH`` frames over an observer-only control-socket
    connection. Double-gated: ``$TPUSHARE_FLEET=1`` must be set AND the
    scheduler must have advertised :data:`~nvshare_tpu_torch.runtime.protocol.
    SCHED_CAP_TELEMETRY` in its register reply — with either missing,
    **zero** TELEMETRY_PUSH frames touch the wire, keeping the
    byte-for-byte reference protocol behavior;
  * **fairness accounting** — the scheduler serves per-tenant quantum
    occupancy (``occ_pm``), wait-time share (``wait_pm``), starvation age
    (``starve_ms``), grants/preemptions and the latest metric snapshot in
    its extended ``GET_STATS`` detail rows (scheduler-computed fields
    first, so a tenant-controlled paging line cannot spoof them);
  * **merging** — :class:`FleetCollector` polls ``GET_STATS`` with
    :data:`~nvshare_tpu_torch.runtime.protocol.STATS_WANT_TELEM`, aligns each
    process's monotonic clock against the scheduler's arrival timestamps,
    and :func:`merge_trace` emits one fleet-wide Chrome trace: every
    tenant's lock spans on one coherent timeline, each handoff tied to a
    correlation id (the scheduling round: holder DROP → GRANT → next
    tenant's LOCK_OK) and decomposed into writeback / wire / page-in
    child slices.

Clock-alignment caveat: the offset estimator is
``min(arrival_sched - send_client)`` over all frames from one sender, so
it is biased by the minimum one-way push latency (sub-millisecond on a
local UNIX socket, the only transport here). Events from different
processes closer together than that bias can render in the wrong order;
lock spans stay safe because the scheduler's own GRANT instants bound
them.

``python -m nvshare_tpu_torch.telemetry.top`` renders the live fairness view;
:func:`fleet_to_registry` maps it onto ``tpushare_fleet_*`` Prometheus
gauges. See docs/TELEMETRY.md (fleet plane) for the wire format.
"""

from __future__ import annotations

import atexit
import select
import threading
import time
from typing import Optional

from nvshare_tpu_torch.runtime.protocol import IDENT_LEN
from nvshare_tpu_torch.utils import env_bool, get_logger
from nvshare_tpu_torch.utils.config import env_float

log = get_logger("fleet")

#: Tenant names are clipped in push frames so one token can never eat the
#: whole payload.
_WHO_MAX = 40
#: The frame's job_name field: Msg.pack silently byte-slices anything
#: longer, so every encoder here must keep whole tokens within this —
#: a sliced value would parse as valid-but-wrong downstream.
_PAYLOAD_MAX = IDENT_LEN - 1


def fleet_enabled() -> bool:
    """$TPUSHARE_FLEET=1 switches the fleet plane on (default off: no
    TELEMETRY_PUSH frame is ever sent — reference wire parity)."""
    return env_bool("TPUSHARE_FLEET", False)


# --------------------------------------------------------------- wire codec

def _compact(v) -> str:
    """One k=v token value: no spaces (the frame is space-delimited), no
    surprises from bools/floats."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        v = round(v, 6)
        return repr(int(v)) if float(v).is_integer() else repr(v)
    return str(v).replace(" ", "_").replace("=", ":")


def encode_event(ev, now_us: Optional[int] = None) -> str:
    """One ring :class:`~nvshare_tpu_torch.telemetry.events.Event` -> a compact
    ``k=v`` line that fits the 139-char frame payload.

    Layout: ``k=<kind> w=<who> ts=<event µs> now=<send µs>`` then the
    event args verbatim (clipped, never split mid-token). ``ts`` is the
    event's local-monotonic timestamp; ``now`` is the send time on the
    same clock — the (now, scheduler-arrival) pair is what the collector
    aligns clocks with.
    """
    if now_us is None:
        now_us = int(time.monotonic() * 1e6)
    parts = [f"k={ev.kind}", f"w={_compact(ev.who)[:_WHO_MAX]}",
             f"ts={int(ev.ts * 1e6)}", f"now={int(now_us)}"]
    out = " ".join(parts)
    for key, val in (ev.args or {}).items():
        if key in ("k", "w", "ts", "now"):
            continue  # reserved header tokens stay spoof-proof
        tok = f" {key}={_compact(val)}"
        if len(out) + len(tok) > _PAYLOAD_MAX:
            break
        out += tok
    return out


def encode_met(who: str, resident: int, virtual: int, budget: int,
               clean_pm: int, now_us: Optional[int] = None,
               evictions: Optional[int] = None,
               faults: Optional[int] = None,
               wss: Optional[int] = None) -> str:
    """The periodic per-tenant metric snapshot (``k=MET``): resident vs
    virtual bytes and the clean-at-handoff ratio (per mille) — the fields
    ``top`` renders — plus the cumulative pager eviction/fault counters
    (``ev=``/``flt=``) the scheduler's co-admission controller
    differences into an eviction-pressure rate. The scheduler keeps only
    the latest per tenant. Same whole-token budget as
    :func:`encode_event`: trailing tokens are dropped, never sliced
    mid-value."""
    if now_us is None:
        now_us = int(time.monotonic() * 1e6)
    out = f"k=MET w={_compact(who)[:_WHO_MAX]} now={int(now_us)}"
    toks = [f"res={int(resident)}", f"virt={int(virtual)}",
            f"budget={int(budget)}", f"clean_pm={int(clean_pm)}"]
    if evictions is not None:
        toks.append(f"ev={int(evictions)}")
    if faults is not None:
        toks.append(f"flt={int(faults)}")
    if wss is not None:
        # Observed working-set EWMA (the wss pager policy): the optional
        # tighter co-admission estimate; the scheduler falls back to
        # max(res, virt) whenever the token is absent.
        toks.append(f"wss={int(wss)}")
    for tok in toks:
        if len(out) + 1 + len(tok) > _PAYLOAD_MAX:
            break
        out += " " + tok
    return out


def decode_event_line(line: str) -> dict:
    """Inverse of :func:`encode_event`/:func:`encode_met`: a tolerant
    parse into ``{"kind", "who", "ts", "now", "args"}`` (``ts``/``now``
    in µs, None when absent; unknown tokens land in ``args``). Built on
    :func:`parse_stats_kv`, so duplicates, empty values and truncated
    tails never raise."""
    from nvshare_tpu_torch.runtime.protocol import parse_stats_kv

    kv = parse_stats_kv(line)
    out = {
        "kind": str(kv.pop("k", "?")),
        "who": str(kv.pop("w", "")),
        "ts": kv.pop("ts", None),
        "now": kv.pop("now", None),
    }
    for f in ("ts", "now"):
        if out[f] is not None and not isinstance(out[f], int):
            out[f] = None  # mangled timestamp: fall back to arrival time
    out["args"] = kv
    return out


# ----------------------------------------------------------------- streamer

class FleetStreamer:
    """Background thread forwarding the process-global event ring (plus a
    per-arena metric snapshot) to the scheduler as TELEMETRY_PUSH frames.

    One per process (tenant attribution travels in each frame's ``w=``
    token, so in-process co-located tenants share a streamer). The
    connection is a dedicated observer-only registration
    (``CAP_TELEMETRY | CAP_OBSERVER``): it never competes for the device
    lock, is excluded from the scheduler's ``clients=``/fairness output,
    and keeps telemetry entirely off the latency-sensitive client state
    machines. If the scheduler did not advertise
    :data:`~nvshare_tpu_torch.runtime.protocol.SCHED_CAP_TELEMETRY` (an older
    daemon would treat the frame type as fatal), the streamer closes the
    link and stays silent: ``active`` is False and nothing is sent, ever.
    """

    def __init__(self, job_name: Optional[str] = None,
                 interval_s: Optional[float] = None,
                 sock_path: Optional[str] = None,
                 max_frames_per_tick: int = 128):
        from nvshare_tpu_torch import telemetry
        from nvshare_tpu_torch.runtime.protocol import (
            CAP_OBSERVER,
            CAP_TELEMETRY,
            SCHED_CAP_TELEMETRY,
            SchedulerLink,
            default_job_name,
        )

        base = job_name or default_job_name()
        self.job_name = f"{base[:96]}/fleet"
        self.interval_s = (interval_s if interval_s is not None
                           else env_float("TPUSHARE_FLEET_PUSH_S", 0.25))
        self.max_frames_per_tick = max_frames_per_tick
        self.active = False
        self._link = SchedulerLink(path=sock_path, job_name=self.job_name)
        try:
            self._link.register(caps=CAP_TELEMETRY | CAP_OBSERVER)
        except Exception:
            self._link.close()
            raise
        if not (self._link.sched_caps & SCHED_CAP_TELEMETRY):
            log.info("scheduler predates the fleet plane — telemetry "
                     "streaming disabled (zero TELEMETRY_PUSH frames)")
            self._link.close()
            return
        self.active = True
        self._last_seq = -1
        self._stop = threading.Event()
        reg = telemetry.registry()
        self._m_frames = reg.counter(
            "tpushare_fleet_frames_total",
            "TELEMETRY_PUSH frames streamed to the scheduler")
        self._m_dropped = reg.counter(
            "tpushare_fleet_frames_dropped_total",
            "ring events skipped because a push tick was over its frame "
            "budget")
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="tpushare-fleet")
        self._thread.start()
        atexit.register(self.stop)
        log.info("fleet streamer up (%s, every %.0f ms)", self.job_name,
                 self.interval_s * 1000)

    # -- internals --------------------------------------------------------

    def _drain_incoming(self) -> None:
        """Discard broadcast frames (SCHED_ON/OFF land on every
        registered connection, observers included) so the socket buffer
        can never fill against the daemon."""
        from nvshare_tpu_torch.runtime.protocol import FRAME_SIZE

        while True:
            r, _, _ = select.select([self._link.sock], [], [], 0)
            if not r:
                return
            if not self._link.sock.recv(FRAME_SIZE):
                raise ConnectionError("scheduler closed the fleet link")

    def _tick(self) -> None:
        from nvshare_tpu_torch import telemetry
        from nvshare_tpu_torch.runtime.protocol import MsgType
        from nvshare_tpu_torch.telemetry import events as tev

        self._drain_incoming()
        evs = [e for e in tev.ring().snapshot() if e.seq > self._last_seq]
        if evs:
            self._last_seq = evs[-1].seq
        if len(evs) > self.max_frames_per_tick:
            # Newest-first survival, like the ring itself: a burst beyond
            # the per-tick budget drops its oldest events, counted.
            self._m_dropped.inc(len(evs) - self.max_frames_per_tick)
            evs = evs[-self.max_frames_per_tick:]
        now_us = int(time.monotonic() * 1e6)
        for e in evs:
            self._link.send(MsgType.TELEMETRY_PUSH,
                            job_name=encode_event(e, now_us))
            self._m_frames.inc()
        # Metric snapshot per live arena (label set of the resident-bytes
        # gauge), so `top` sees resident vs virtual bytes and the clean
        # ratio without scraping every tenant's /metrics endpoint.
        snap = telemetry.registry().snapshot()
        res = snap.get("tpushare_resident_bytes", {})
        virt = snap.get("tpushare_tracked_bytes", {})
        budget = snap.get("tpushare_budget_bytes", {})
        clean = snap.get("tpushare_clean_at_handoff_ratio", {})
        # Cumulative pager counters ride along so the scheduler can
        # difference them into an eviction-pressure rate (the signal
        # that demotes co-residency back to time-slicing).
        evs = snap.get("tpushare_evictions_total", {})
        hevs = snap.get("tpushare_handoff_evictions_total", {})
        flts = snap.get("tpushare_page_faults_total", {})
        # Observed working-set EWMA (exported only by the wss pager
        # policy): rides as the optional wss= token so co-admission can
        # admit tighter pairs; absent keys simply omit the token.
        wss_map = snap.get("tpushare_wss_bytes", {})
        for key, rbytes in res.items():
            who = key[0] if key else ""
            wss_v = wss_map.get(key)
            self._link.send(
                MsgType.TELEMETRY_PUSH,
                job_name=encode_met(
                    who, rbytes, virt.get(key, 0), budget.get(key, 0),
                    int(1000 * clean.get(key, 0.0)), now_us,
                    evictions=int(evs.get(key, 0) + hevs.get(key, 0)),
                    faults=int(flts.get(key, 0)),
                    wss=int(wss_v) if wss_v else None))
            self._m_frames.inc()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self._tick()
            except (OSError, ConnectionError):
                # The fd must not outlive the stream (a long-lived tenant
                # would leak it for the process lifetime otherwise).
                log.warning("fleet link lost — streaming stops")
                self.active = False
                self._link.close()
                return
            except Exception:  # telemetry must never take a tenant down
                log.debug("fleet push tick failed", exc_info=True)
        # Final flush so short-lived tenants' tails reach the fleet view.
        try:
            self._tick()
        except Exception:
            pass

    def stop(self) -> None:
        """Stop the thread and close the link unconditionally —
        "not streaming any more" must never mean "skip cleanup".
        Idempotent (SchedulerLink.close tolerates repeats)."""
        st = getattr(self, "_stop", None)
        if st is not None:
            st.set()
            t = getattr(self, "_thread", None)
            if (t is not None and t.is_alive()
                    and t is not threading.current_thread()):
                t.join(timeout=10)
        self.active = False
        self._link.close()


_streamer: Optional[FleetStreamer] = None
_streamer_lock = threading.Lock()


def maybe_start_streamer(job_name: Optional[str] = None
                         ) -> Optional[FleetStreamer]:
    """Start the process's fleet streamer if ``$TPUSHARE_FLEET=1`` — the
    one-liner both client runtimes call after registering. Idempotent
    (one streamer per process); returns None when disabled, when the
    scheduler is unreachable, or when it predates the fleet plane."""
    global _streamer
    if not fleet_enabled():
        return None
    with _streamer_lock:
        if _streamer is not None:
            return _streamer if _streamer.active else None
        try:
            s = FleetStreamer(job_name=job_name)
        except Exception as e:
            log.warning("fleet streamer failed to start: %s", e)
            return None
        _streamer = s
        return s if s.active else None


def reset_streamer() -> None:
    """Testing hook: stop and drop the process streamer singleton."""
    global _streamer
    with _streamer_lock:
        if _streamer is not None:
            try:
                _streamer.stop()
            except Exception:
                pass
        _streamer = None


# ---------------------------------------------------------------- collector

def fetch_fleet_stats(path: Optional[str] = None,
                      timeout: float = 10.0) -> dict:
    """One extended GET_STATS round-trip: summary + per-tenant fairness
    rows + the (drained) fleet event replay."""
    from nvshare_tpu_torch.telemetry.dump import fetch_sched_stats

    return fetch_sched_stats(path=path, timeout=timeout, want_telem=True)


def occupancy_shares(stats: dict) -> dict:
    """{tenant: device share in [0, 1]} from an extended stats fetch.

    Prefers the scheduler's device-seconds attribution (``dev_pm``,
    emitted by co-residency-configured daemons): overlapping concurrent
    holds split each interval among the holders, so the values sum to
    <= 1.0 of device-seconds even when wall-clock occupancy (``occ_pm``)
    sums past 1.0. Falls back to ``occ_pm`` for exclusive-only daemons,
    where the two coincide."""
    out = {}
    for c in stats.get("clients", []):
        occ = c.get("dev_pm")
        if not isinstance(occ, int):
            occ = c.get("occ_pm")
        if isinstance(occ, int):
            out[c.get("client", "?")] = occ / 1000.0
    return out


class FleetCollector:
    """Stateful fleet poller: accumulates replayed trace events across
    polls, estimates each sender's clock offset against the scheduler
    clock, and prunes tenants the scheduler no longer reports (a dead
    tenant must drop out of the fairness view, not freeze at its last
    numbers)."""

    def __init__(self, sock_path: Optional[str] = None,
                 max_events: int = 65536):
        self.sock_path = sock_path
        self.max_events = max_events
        self.summary: dict = {}
        self.tenants: dict = {}     # name -> latest fairness row
        self.offsets: dict = {}     # sender -> offset seconds (min-delay)
        self.events: list = []      # accumulated decoded frames

    def poll(self, timeout: float = 10.0) -> dict:
        st = fetch_fleet_stats(self.sock_path, timeout=timeout)
        self.summary = st["summary"]
        # Wholesale replace = pruning: tenants absent from this poll are
        # gone (the scheduler already dropped their rows on death).
        self.tenants = {c.get("client", "?"): c for c in st["clients"]}
        for fr in st["events"]:
            sender = fr.get("sender", "")
            if isinstance(fr.get("now"), int) and isinstance(
                    fr.get("arrival_ms"), int):
                sample = fr["arrival_ms"] / 1e3 - fr["now"] / 1e6
                prev = self.offsets.get(sender)
                self.offsets[sender] = (sample if prev is None
                                        else min(prev, sample))
            self.events.append(fr)
        if len(self.events) > self.max_events:
            self.events = self.events[-self.max_events:]
        return st

    def aligned_events(self) -> list:
        """All accumulated events with ``t`` = seconds on the scheduler
        clock: ``event_ts + offset(sender)`` when alignable, else the
        frame's arrival time. Sorted oldest-first."""
        out = []
        for fr in self.events:
            if (isinstance(fr.get("ts"), int)
                    and fr.get("sender") in self.offsets):
                t = fr["ts"] / 1e6 + self.offsets[fr["sender"]]
            elif isinstance(fr.get("arrival_ms"), int):
                t = fr["arrival_ms"] / 1e3
            else:
                continue
            out.append({**fr, "t": t})
        out.sort(key=lambda fr: fr["t"])
        return out

    def merge_trace(self) -> dict:
        return merge_trace(self.aligned_events(),
                           clock_offsets=self.offsets)


# ------------------------------------------------------------------- merger

_SCHED_TRACK = "scheduler"
_HANDOFF_TRACK = "handoffs"
#: Alignment slack (s) when pairing events across clocks: the grantee's
#: LOCK_ACQUIRE may align marginally before the scheduler's GRANT instant
#: because the offset estimator under-corrects by the minimum push latency.
_ALIGN_SLACK_S = 0.005


def merge_trace(aligned: list, clock_offsets: Optional[dict] = None
                ) -> dict:
    """Aligned fleet events -> one Chrome ``trace_event`` JSON dict.

    Tracks: one per tenant (lock spans + instants), one for the
    scheduler's GRANT/DROP/REVOKE instants, and one ``handoffs`` track where
    each handoff renders as a parent span (``corr=h<round>``) containing
    nested writeback / wire / page-in child slices:

      * **writeback** — the outgoing holder's HANDOFF event (fence +
        evict; its ``seconds`` arg is exactly one
        ``tpushare_handoff_seconds`` sample);
      * **wire** — end of the holder's eviction to the grantee's
        LOCK_ACQUIRE (release frame, scheduler grant, wakeup);
      * **page-in** — grantee's LOCK_ACQUIRE to its first PREFETCH
        completion (zero-length when nothing was paged back).
    """
    whos: list = []
    for fr in aligned:
        w = fr.get("who") or (_SCHED_TRACK if fr.get("sender") == "sched"
                              else fr.get("sender", "?"))
        if w not in whos and w != _SCHED_TRACK:
            whos.append(w)
    t0 = aligned[0]["t"] if aligned else 0.0

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 3)

    tids = {w: i + 1 for i, w in enumerate(whos)}
    tids[_SCHED_TRACK] = len(whos) + 1
    tids[_HANDOFF_TRACK] = len(whos) + 2
    out = [{"ph": "M", "pid": 1, "tid": tid, "name": "thread_name",
            "args": {"name": w}} for w, tid in tids.items()]

    open_spans: dict = {}
    for fr in aligned:
        kind, who, t = fr["kind"], fr.get("who", ""), fr["t"]
        if (fr.get("sender") == "sched"
                and kind in ("GRANT", "DROP", "REVOKE")):
            out.append({"ph": "i", "s": "t", "ts": us(t), "pid": 1,
                        "tid": tids[_SCHED_TRACK], "name": kind,
                        "args": dict(fr.get("args", {}), who=who)})
            continue
        tid = tids.get(who, 0)
        if kind == "LOCK_ACQUIRE":
            prev = open_spans.pop(who, None)
            if prev is not None:  # ring wrapped past the release
                out.append({"ph": "X", "ts": us(prev["t"]),
                            "dur": max(us(t) - us(prev["t"]), 0.0),
                            "pid": 1, "tid": tid, "name": "device-lock",
                            "args": prev.get("args", {})})
            open_spans[who] = fr
        elif kind == "LOCK_RELEASE":
            acq = open_spans.pop(who, None)
            if acq is None:
                continue
            args = dict(acq.get("args", {}))
            args.update(fr.get("args", {}))
            out.append({"ph": "X", "ts": us(acq["t"]),
                        "dur": max(us(t) - us(acq["t"]), 0.0),
                        "pid": 1, "tid": tid, "name": "device-lock",
                        "args": args})
        else:
            out.append({"ph": "i", "s": "t", "ts": us(t), "pid": 1,
                        "tid": tid, "name": kind,
                        "args": fr.get("args", {})})
    for who, acq in open_spans.items():
        out.append({"ph": "B", "ts": us(acq["t"]), "pid": 1,
                    "tid": tids.get(who, 0), "name": "device-lock",
                    "args": acq.get("args", {})})

    out.extend(_handoff_slices(aligned, tids[_HANDOFF_TRACK], us))
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "nvshare_tpu_torch.telemetry.fleet",
            "clock_offsets_s": dict(clock_offsets or {}),
        },
    }


def _handoff_slices(aligned: list, tid: int, us) -> list:
    """The correlation pass: one parent span + three child slices per
    scheduler GRANT that follows a DROP/HANDOFF (see :func:`merge_trace`).
    """
    grants = [fr for fr in aligned
              if fr.get("sender") == "sched" and fr["kind"] == "GRANT"]
    out = []
    prev_grant_t = float("-inf")
    for g in grants:
        corr = f"h{g.get('args', {}).get('r', '?')}"
        nxt = g.get("who", "")
        # The outgoing holder's eviction: latest HANDOFF before this
        # grant (and after the previous one — each handoff pairs with
        # exactly one grant).
        handoff = None
        for fr in aligned:
            if fr["t"] >= g["t"] + _ALIGN_SLACK_S:
                break
            if fr["kind"] == "HANDOFF" and fr["t"] > prev_grant_t:
                handoff = fr
        prev_grant_t = g["t"]
        if handoff is None:
            continue  # first grant / free-lock grant: nothing handed off
        holder = handoff.get("who", "")
        # parse_stats_kv keeps non-integer values as strings; handoff
        # durations are floats, so coerce here.
        try:
            wb_s = float(handoff.get("args", {}).get("seconds", 0))
        except (TypeError, ValueError):
            wb_s = 0.0
        wb_end = handoff["t"]
        acq = next(
            (fr for fr in aligned
             if fr["kind"] == "LOCK_ACQUIRE" and fr.get("who") == nxt
             and fr["t"] >= wb_end - _ALIGN_SLACK_S), None)
        if acq is None:
            continue
        acq_t = max(acq["t"], wb_end)  # clamp alignment jitter
        release_t = next(
            (fr["t"] for fr in aligned
             if fr["kind"] == "LOCK_RELEASE" and fr.get("who") == nxt
             and fr["t"] > acq["t"]), float("inf"))
        pf = next(
            (fr for fr in aligned
             if fr["kind"] == "PREFETCH" and fr.get("who") == nxt
             and acq["t"] - _ALIGN_SLACK_S <= fr["t"] < release_t), None)
        pagein_end = max(pf["t"], acq_t) if pf is not None else acq_t
        start, end = wb_end - wb_s, pagein_end
        segs = [("writeback", start, wb_end),
                ("wire", wb_end, acq_t),
                ("page-in", acq_t, pagein_end)]
        out.append({
            "ph": "X", "ts": us(start), "dur": max(us(end) - us(start), 0.0),
            "pid": 1, "tid": tid, "name": "handoff",
            "args": {"corr": corr, "holder": holder, "next": nxt,
                     "writeback_s": round(wb_s, 6),
                     "wire_s": round(acq_t - wb_end, 6),
                     "pagein_s": round(pagein_end - acq_t, 6)}})
        for name, s, e in segs:
            out.append({"ph": "X", "ts": us(s),
                        "dur": max(us(e) - us(s), 0.0), "pid": 1,
                        "tid": tid, "name": name, "args": {"corr": corr}})
    return out


def handoff_summaries(trace: dict) -> list:
    """[{corr, holder, next, writeback_s, wire_s, pagein_s, start_us,
    dur_us}] for the handoff parent spans — the helper tests and bench
    reporting use."""
    out = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("name") == "handoff":
            out.append(dict(e.get("args", {}), start_us=e["ts"],
                            dur_us=e["dur"]))
    return out


# --------------------------------------------------------------- prometheus

#: fairness row field -> (gauge suffix, scale, help)
_FLEET_GAUGES = {
    "occ_pm": ("fleet_occupancy_share", 1e-3,
               "share of scheduler uptime this tenant held the device "
               "lock (wall clock: sums to <= 1 across tenants unless "
               "co-residency overlaps holds)"),
    "dev_pm": ("fleet_device_share", 1e-3,
               "device-seconds share (concurrent holds split the "
               "interval; sums to <= 1 across tenants always)"),
    "cog": ("fleet_co_grants", 1.0,
            "concurrent (co-admitted) grants this tenant received"),
    "wait_pm": ("fleet_wait_share", 1e-3,
                "share of scheduler uptime this tenant spent queued"),
    "starve_ms": ("fleet_starvation_seconds", 1e-3,
                  "age of the tenant's live lock wait (0 when not "
                  "queued)"),
    "preempt": ("fleet_preemptions", 1.0,
                "DROP_LOCK preemptions this tenant received"),
    "revoked": ("fleet_revocations", 1.0,
                "lease revocations (forcible reclaims after an ignored "
                "DROP_LOCK) this tenant suffered"),
    "grants": ("fleet_grants", 1.0, "lock grants to this tenant"),
    "pushes": ("fleet_pushes", 1.0,
               "telemetry lines the scheduler attributed to this tenant"),
    "res": ("fleet_resident_bytes", 1.0,
            "device-resident bytes (tenant's latest metric push)"),
    "virt": ("fleet_virtual_bytes", 1.0,
             "tracked virtual bytes (tenant's latest metric push)"),
    "clean_pm": ("fleet_clean_ratio", 1e-3,
                 "clean-at-handoff ratio (tenant's latest metric push)"),
}


def fleet_to_registry(stats: dict, reg) -> None:
    """Map an extended stats fetch onto ``tpushare_fleet_*`` gauges —
    the fleet extension of the Prometheus exporter (gauges: every value
    is a point-in-time read from the daemon)."""
    for c in stats.get("clients", []):
        name = c.get("client", "?")
        for field, (suffix, scale, help_) in _FLEET_GAUGES.items():
            v = c.get(field)
            if isinstance(v, (int, float)):
                reg.gauge(f"tpushare_{suffix}", help_, ["client"]).labels(
                    client=name).set(v * scale)
    s = stats.get("summary", {})
    if isinstance(s.get("up"), int):
        reg.gauge("tpushare_fleet_sched_uptime_seconds",
                  "scheduler uptime (occupancy denominator)").set(
            s["up"] / 1e3)
    if isinstance(s.get("telem"), int):
        reg.gauge("tpushare_fleet_events_replayed",
                  "fleet trace events replayed in the last fetch").set(
            s["telem"])
