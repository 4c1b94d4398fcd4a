"""Scheduler STATS round-trip + telemetry dump CLI.

``python -m nvshare_tpu_torch.telemetry.dump`` queries the live
tpushare-scheduler over its UNIX socket (the same GET_STATS/STATS plane
``tpusharectl -s`` uses, pure-Python end to end) and prints queue depth,
the current lock holder, TQ preemption counts, per-client paging/latency
lines and gang rounds — as text, JSON, or Prometheus exposition
(``--prom`` maps every summary field onto ``tpushare_sched_*`` gauges,
ready for a textfile collector).

The module half (:func:`fetch_sched_stats`) is the library API benches
and tests use for the same round-trip.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from nvshare_tpu_torch.runtime.protocol import (
    MsgType,
    SchedulerLink,
    parse_stats_kv,
)
from nvshare_tpu_torch.telemetry.registry import Registry


def fetch_sched_stats(path: Optional[str] = None,
                      timeout: float = 10.0,
                      want_telem: bool = False,
                      want_flight: bool = False,
                      want_wc: bool = True) -> dict:
    """One GET_STATS round-trip over the pure-Python link.

    Returns ``{"summary": {k: v}, "clients": [...], "gangs": [...],
    "events": [...], "flight": [...]}``. The summary's ``paging=N`` /
    ``gangs=N`` / ``telem=N`` / ``flight=N`` fields announce how many
    per-client, per-gang, fleet-replay and flight-journal detail frames
    follow the summary frame; all are read here so the socket is left
    clean. ``want_telem`` sets the :data:`STATS_WANT_TELEM` flag: the
    scheduler then replays (and drains) its buffered TELEMETRY_PUSH
    frames, decoded into event dicts (see
    :mod:`nvshare_tpu_torch.telemetry.fleet`). ``want_flight`` sets
    :data:`STATS_WANT_FLIGHT`: a ``TPUSHARE_FLIGHT=1`` daemon then
    drains its flight-recorder journal as FLIGHT_REC frames (a
    recorder-less daemon simply never announces ``flight=`` — callers
    should diagnose that explicitly, see :func:`main`). ``want_wc``
    (default, non-draining) sets :data:`STATS_WANT_WC`: a flight-armed
    daemon then sends each tenant's full ``wc=cause:ms,...`` wait-cause
    partition on its own detail frame (``wcrows=N`` in the overflow
    summary), merged here into the matching client dict as ``"wc"`` —
    the fairness row's 139-byte frame tail-truncates under load, so the
    partition never rides it.
    """
    from nvshare_tpu_torch.runtime.protocol import (
        STATS_WANT_FLIGHT,
        STATS_WANT_TELEM,
        STATS_WANT_WC,
    )

    with SchedulerLink(path=path, job_name="telemetry-dump") as link:
        link.send(MsgType.GET_STATS,
                  arg=(STATS_WANT_TELEM if want_telem else 0)
                  | (STATS_WANT_FLIGHT if want_flight else 0)
                  | (STATS_WANT_WC if want_wc else 0))
        reply = link.recv(timeout=timeout)
        if reply.type != MsgType.STATS:
            raise RuntimeError(f"unexpected stats reply {reply.type!r}")
        summary = parse_stats_kv(reply.job_name)
        # The namespace overflow line: holder= (authoritative — the
        # summary line can clip its trailing holder= token when the fixed
        # frame runs out of room, this copy cannot) plus the QoS/lease
        # counters that no longer fit the 139-char summary (nearmiss=,
        # qpre=, qpol=, all emitted BEFORE the tenant-controlled holder
        # name). Only this allowlist merges, and it OVERRIDES the
        # job_name parse: a tenant named "x nearmiss=9" can pollute the
        # clipped summary's holder tail, never the overflow's leading
        # scheduler-computed tokens. An old daemon leaves its own pod
        # namespace here — no matching k=v tokens, so nothing merges.
        ns_kv = parse_stats_kv(reply.job_namespace)
        for k in ("holder", "nearmiss", "qpre", "qpol", "co", "coadm",
                  "codem", "qcap", "phsh", "wcsum", "wcrows", "wres",
                  "wheld", "wpaced", "polgen", "polrb", "fed", "fedup",
                  "fedage", "fedrnd", "fedexp", "fedlat"):
            if k in ns_kv:
                summary[k] = ns_kv[k]
        clients = []
        for _ in range(int(summary.get("paging", 0))):
            m = link.recv(timeout=timeout)
            if m.type != MsgType.PAGING_STATS:
                raise RuntimeError(
                    f"expected PAGING_STATS detail frame, got {m.type!r}")
            detail = parse_stats_kv(m.job_name)
            detail["client"] = m.job_namespace
            detail["client_id"] = m.client_id
            clients.append(detail)
        # Wait-cause detail frames (wcrows=N, STATS_WANT_WC): one full
        # wc= partition per attributed tenant, merged into its fairness
        # row by name. These OVERRIDE any row-parsed "wc" — the detail
        # frame is the authoritative, untruncatable copy.
        by_name = {c["client"]: c for c in clients}
        for _ in range(int(summary.get("wcrows", 0))):
            m = link.recv(timeout=timeout)
            if m.type != MsgType.PAGING_STATS:
                raise RuntimeError(
                    f"expected wait-cause detail frame, got {m.type!r}")
            row = by_name.get(m.job_namespace)
            wc = parse_stats_kv(m.job_name).get("wc")
            if row is not None and isinstance(wc, str):
                row["wc"] = wc
        gangs = []
        for _ in range(int(summary.get("gangs", 0))):
            m = link.recv(timeout=timeout)
            if m.type != MsgType.GANG_INFO:
                raise RuntimeError(
                    f"expected GANG_INFO detail frame, got {m.type!r}")
            gangs.append({"line": m.job_name, "world": m.arg})
        events = []
        for _ in range(int(summary.get("telem", 0))):
            m = link.recv(timeout=timeout)
            if m.type != MsgType.TELEMETRY_PUSH:
                raise RuntimeError(
                    f"expected TELEMETRY_PUSH replay frame, got {m.type!r}")
            from nvshare_tpu_torch.telemetry.fleet import decode_event_line

            d = decode_event_line(m.job_name)
            d["sender"] = m.job_namespace
            d["arrival_ms"] = m.arg
            events.append(d)
        flight = []
        for _ in range(int(summary.get("flight", 0))):
            m = link.recv(timeout=timeout)
            if m.type != MsgType.FLIGHT_REC:
                raise RuntimeError(
                    f"expected FLIGHT_REC drain frame, got {m.type!r}")
            flight.append({"ms": m.arg, "line": m.job_name})
        return {"summary": summary, "clients": clients, "gangs": gangs,
                "events": events, "flight": flight}


#: summary field -> (metric suffix, help). Every value is a point-in-time
#: read from the daemon, so they all export as gauges (Prometheus's
#: counter semantics assume the scraper owns the lifetime, which it does
#: not across scheduler restarts).
_SUMMARY_GAUGES = {
    "on": ("sched_on", "1 while anti-thrash scheduling is enabled"),
    "tq": ("sched_tq_seconds", "current time quantum"),
    "clients": ("sched_clients", "registered clients"),
    "queue": ("sched_queue_depth", "clients queued for the device lock "
                                   "(holder included)"),
    "held": ("sched_lock_held", "1 while the device lock is granted"),
    "grants": ("sched_grants_total", "lock grants since scheduler start"),
    "drops": ("sched_tq_preemptions_total",
              "DROP_LOCK preemptions (TQ expiry) since scheduler start"),
    "early": ("sched_early_releases_total",
              "idle early releases since scheduler start"),
    "round": ("sched_round", "scheduling-round generation counter"),
    "wavg": ("sched_wait_avg_ms", "mean grant wait over all grants"),
    "wmax": ("sched_wait_max_ms", "max grant wait over all grants"),
    "revoked": ("sched_revocations_total",
                "lease revocations since scheduler start"),
    "nearmiss": ("sched_lease_near_misses_total",
                 "revocations whose release landed just after (grace "
                 "auto-widened)"),
    "qpre": ("sched_qos_preemptions_total",
             "QoS early preemptions (interactive over batch) since "
             "scheduler start"),
    # Co-residency plane (emitted only by coadmit-configured daemons).
    "co": ("sched_co_holders", "live concurrent (co-admitted) holds"),
    "coadm": ("sched_coadmissions_total",
              "concurrent grants made since scheduler start"),
    "codem": ("sched_co_demotions_total",
              "collapses back to exclusive time-slicing since scheduler "
              "start"),
    "qcap": ("sched_qos_admission_downgrades_total",
             "REGISTERs admitted with their QoS declaration stripped "
             "(aggregate weight cap)"),
    # Federation plane (emitted only by $TPUSHARE_FED-federated daemons;
    # docs/FEDERATION.md). fedage=-1 means "federated but never heard
    # from the coordinator" — still a meaningful gauge value.
    "fed": ("sched_federated",
            "1 while this scheduler runs under a tpushare-fed "
            "coordinator"),
    "fedup": ("sched_fed_coordinator_up",
              "1 while the coordinator link is connected (0 = fail-open "
              "local arbitration)"),
    "fedage": ("sched_fed_coordinator_age_ms",
               "milliseconds since the last coordinator frame (-1 = "
               "never heard from it)"),
    "fedrnd": ("sched_fed_rounds_total",
               "coordinator gang rounds taken since scheduler start"),
    "fedexp": ("sched_fed_round_expiries_total",
               "coordinator round leases that expired locally and "
               "drained through DROP_LOCK"),
    "fedlat": ("sched_fed_round_latency_ms",
               "last federation round's grant-to-released latency"),
    # Flight-recorder plane (present only on a --flight request against
    # a TPUSHARE_FLIGHT=1 daemon).
    "flight": ("sched_flight_journal_depth",
               "flight-recorder records drained by this request"),
    "fdrop": ("sched_flight_dropped_total",
              "flight-recorder records lost to journal-ring overflow"),
}


def stats_to_registry(stats: dict, reg: Registry) -> None:
    """Map a :func:`fetch_sched_stats` result onto ``tpushare_sched_*``
    gauges in ``reg`` (used by --prom and by anything republishing the
    scheduler's view next to its own process metrics)."""
    summary = stats["summary"]
    for field, (suffix, help_) in _SUMMARY_GAUGES.items():
        if field in summary and isinstance(summary[field], int):
            reg.gauge(f"tpushare_{suffix}", help_).set(summary[field])
    holder = summary.get("holder", "-")
    info = reg.gauge("tpushare_sched_holder_info",
                     "1, labeled with the current lock holder",
                     ["holder"])
    # The lock is mutually exclusive: zero every previously-seen holder
    # series before marking the current one, or a long-lived registry
    # exports several simultaneous "holders" as the lock moves around.
    for _, child in info.samples():
        child.set(0)
    info.labels(holder=str(holder)).set(1)
    per_client = reg.gauge("tpushare_sched_client_grants",
                           "grants per registered client", ["client"])
    for c in stats["clients"]:
        if isinstance(c.get("grants"), int):
            per_client.labels(client=c.get("client", "?")).set(c["grants"])
    _flight_slo_to_registry(stats, reg)


#: ``whist=`` bucket upper bounds in seconds (src/arbiter_core.hpp
#: kSloWaitBucketsMs + the +Inf tail), as Prometheus ``le`` labels.
_WHIST_LE = ("0.01", "0.1", "1", "10", "+Inf")


def parse_whist(whist) -> Optional[list]:
    """A fairness row's ``whist=a:b:c:d:e`` token -> per-bucket counts
    (None when absent/mangled). Shared by --prom and ``top``."""
    if not isinstance(whist, str):
        return None
    parts = whist.split(":")
    if len(parts) != len(_WHIST_LE) or not all(
            p.isdigit() for p in parts):
        return None
    return [int(p) for p in parts]


def parse_wc(token) -> Optional[dict]:
    """A wait-cause detail frame's ``wc=cause:ms,...`` token ->
    ``{cause: ms}`` (None when absent/mangled). The cause vocabulary is
    pinned by tools/lint/contract_check.py; shared by --prom and
    ``top``."""
    if not isinstance(token, str) or not token:
        return None
    out = {}
    for part in token.split(","):
        bits = part.split(":")
        if len(bits) != 2 or not bits[1].isdigit():
            return None
        out[bits[0]] = int(bits[1])
    return out if out else None


def _flight_slo_to_registry(stats: dict, reg: Registry) -> None:
    """The scheduler's authoritative SLO self-metrics (rows carry
    ``whist=``/``rmarg=``/``hacc=``/``herr=`` only on a
    ``TPUSHARE_FLIGHT=1`` daemon — see docs/TELEMETRY.md). The wait
    histogram exports in Prometheus histogram shape (cumulative buckets
    by ``le``) so PromQL quantile tooling works unchanged."""
    # Families are created lazily so a flight-off daemon's --prom output
    # doesn't grow even empty headers (capture-parity hygiene).
    def fam(name, help_, labels):
        return reg.gauge(f"tpushare_sched_client_{name}", help_, labels)

    for c in stats["clients"]:
        who = c.get("client", "?")
        counts = parse_whist(c.get("whist"))
        if counts is not None:
            bucket = fam("grant_wait_bucket",
                         "scheduler-observed REQ_LOCK->LOCK_OK wait "
                         "histogram (cumulative count per le seconds)",
                         ["client", "le"])
            acc = 0
            for n, le in zip(counts, _WHIST_LE):
                acc += n
                bucket.labels(client=who, le=le).set(acc)
        if isinstance(c.get("rmarg"), int):
            fam("revoke_margin_min_ms",
                "tightest observed release-before-revoke-deadline "
                "margin", ["client"]).labels(client=who).set(c["rmarg"])
        if isinstance(c.get("hacc"), int):
            fam("horizon_hit_permille",
                "horizon position-1 predictions that resolved to a "
                "grant", ["client"]).labels(client=who).set(c["hacc"])
        if isinstance(c.get("herr"), int):
            fam("horizon_eta_err_ms",
                "EWMA of |realized - predicted| grant ETA",
                ["client"]).labels(client=who).set(c["herr"])
        wc = parse_wc(c.get("wc"))
        if wc is not None:
            # The grant-latency attribution ledger: one
            # monotone series per (cause, tenant). Same lazy-creation
            # hygiene — a flight-off daemon exports no empty family.
            causes = reg.gauge(
                "tpushare_sched_wait_cause_ms_total",
                "cumulative REQ_LOCK->LOCK_OK gate-wait milliseconds "
                "attributed to each wait cause (wait-cause ledger)",
                ["cause", "tenant"])
            for cause, ms in wc.items():
                causes.labels(cause=cause, tenant=who).set(ms)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nvshare_tpu_torch.telemetry.dump",
        description="Query the live tpushare-scheduler stats plane.")
    ap.add_argument("--sock", default=None,
                    help="scheduler socket path (default: "
                         "$TPUSHARE_SOCK_DIR/scheduler.sock)")
    ap.add_argument("--json", action="store_true",
                    help="print the full stats object as JSON")
    ap.add_argument("--prom", action="store_true",
                    help="print as Prometheus text exposition "
                         "(tpushare_sched_* gauges)")
    ap.add_argument("--fleet", action="store_true",
                    help="also fetch the fleet plane: drains the "
                         "scheduler's telemetry replay buffer and (with "
                         "--prom) adds the tpushare_fleet_* gauges")
    ap.add_argument("--flight", action="store_true",
                    help="also drain the arbiter flight-recorder journal "
                         "(TPUSHARE_FLIGHT=1 daemons; see "
                         "tools/flight for the incident-replay pipeline)")
    ap.add_argument("--flight-out", default=None, metavar="PATH",
                    help="with --flight: write the drained journal as a "
                         "binary flight_journal.bin (the tools/flight "
                         "input format) instead of printing records")
    ap.add_argument("--timeout", type=float, default=10.0)
    args = ap.parse_args(argv)
    try:
        stats = fetch_sched_stats(path=args.sock, timeout=args.timeout,
                                  want_telem=args.fleet,
                                  want_flight=args.flight)
    except OSError as e:
        print(f"scheduler unreachable: {e}", file=sys.stderr)
        return 2
    # Explicit capability diagnostics: silence here used to read as "no
    # data" when it actually meant "this daemon cannot produce any".
    if args.fleet and "telem" not in stats["summary"]:
        print("scheduler does not advertise telemetry (pre-fleet daemon) "
              "— --fleet has nothing to drain", file=sys.stderr)
    if args.flight and "flight" not in stats["summary"]:
        print("scheduler does not advertise a flight recorder "
              "(TPUSHARE_FLIGHT unset, or a pre-flight daemon) — "
              "--flight has nothing to drain", file=sys.stderr)
    if args.flight and args.flight_out is not None:
        # The scheduler's own flush format (u32-LE length-prefixed
        # lines), so tools/flight/convert.py reads either source.
        import struct as _struct

        with open(args.flight_out, "wb") as f:
            for rec in stats.get("flight", []):
                raw = rec["line"].encode("utf-8")
                f.write(_struct.Struct("<I").pack(len(raw)))
                f.write(raw)
        print(f"flight journal ({len(stats.get('flight', []))} records) "
              f"-> {args.flight_out}", file=sys.stderr)
    if args.json:
        print(json.dumps(stats, indent=2, sort_keys=True))
    elif args.prom:
        from nvshare_tpu_torch.telemetry.prometheus import render_text

        reg = Registry()  # private: only the scheduler view, no process noise
        stats_to_registry(stats, reg)
        if args.fleet:
            from nvshare_tpu_torch.telemetry.fleet import fleet_to_registry

            fleet_to_registry(stats, reg)
        sys.stdout.write(render_text(reg))
    else:
        s = stats["summary"]
        print("scheduler: " + " ".join(
            f"{k}={v}" for k, v in s.items()))
        print(f"  queue depth : {s.get('queue', '?')}")
        print(f"  lock holder : {s.get('holder', '-')}")
        print(f"  preemptions : {s.get('drops', '?')} "
              f"(grants={s.get('grants', '?')}, "
              f"early={s.get('early', '?')})")
        # Federation diagnostics: explicit either way, so a silent FED
        # line never reads as "no rounds yet" when it means "this daemon
        # cannot take part in any" (same reasoning as --fleet/--flight).
        if s.get("fed") == 1:
            link = ("up" if s.get("fedup") == 1
                    else "DOWN (fail-open: local arbitration)")
            print(f"  federation  : coordinator {link} "
                  f"age={s.get('fedage', '?')}ms "
                  f"rounds={s.get('fedrnd', '?')} "
                  f"expiries={s.get('fedexp', '?')} "
                  f"last-round-latency={s.get('fedlat', '?')}ms")
        else:
            print("  federation  : scheduler is not federated "
                  "(TPUSHARE_FED unset)")
        for c in stats["clients"]:
            line = " ".join(f"{k}={v}" for k, v in c.items()
                            if k not in ("client", "client_id"))
            print(f"  client {c.get('client', '?')}: {line}")
        for gng in stats["gangs"]:
            print(f"  gang {gng['line']}")
        if stats.get("events"):
            print(f"  fleet events drained: {len(stats['events'])}")
        if stats.get("flight") and args.flight_out is None:
            print(f"  flight journal drained: {len(stats['flight'])} "
                  f"records")
            for rec in stats["flight"]:
                print(f"    {rec['line']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
