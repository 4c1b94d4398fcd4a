"""``python -m nvshare_tpu_torch.telemetry.top`` — live fleet fairness view.

A ``top``-style console for one tpushare scheduler: per-tenant occupancy
bars, wait share, resident vs virtual bytes, clean-at-handoff ratio,
grants/preemptions, and starvation alerts — all straight from the
scheduler's extended ``GET_STATS`` plane (no per-tenant /metrics
scraping). Renders with curses when stdout is a terminal; ``--plain``
(or a pipe) prints one frame per interval instead, which is also what
the tests exercise.

The starvation alert fires when a tenant's live wait exceeds
``--starve-after`` seconds (default: twice the scheduler's quantum) —
the "who starved" observable the fairness plane exists for. The
threshold is ENTITLEMENT-AWARE: a QoS-declared tenant whose achieved
occupancy sits below half its entitled share (``weight / sum(weights)``,
undeclared rows counting as weight 1) alerts at a quarter of the normal
threshold — a weighted tenant being denied its share is starving long
before an unweighted FIFO peer would be. The QOS column shows each
row's declared ``class:weight`` (``int:2`` / ``bat:1``; ``-`` =
undeclared), straight from the scheduler-validated ``qos=``/``qw=``
fairness-row labels.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

from nvshare_tpu_torch.telemetry.dump import (fetch_sched_stats, parse_wc,
                                        parse_whist)

# Narrowed (was 24) when the QOS column landed, so a full row — tenant,
# qos, bar, waits, residency, counters, alert — still fits the default
# 120-char frame width without clipping the ALERT tail.
_BAR_W = 18

#: Coordinator staleness horizon for the FED header alert (mirrors
#: src/fed_core.hpp kFedDefaultStatsStaleMs — the age at which the
#: coordinator itself would write the host off).
_FED_STALE_MS = 15000


def _fed_hdr(s: dict) -> str:
    """The FED header segment: round counter, last-round latency, and
    coordinator liveness, from the federation overflow tokens
    (``fed=``/``fedup=``/``fedage=``/...). Empty for a non-federated
    daemon — frames stay header-identical, and ``dump`` owns the
    explicit "scheduler is not federated" diagnostic. A dead or stale
    coordinator is an ALERT state: the host is running fail-open on
    local arbitration and cross-host WFQ shares are no longer being
    enforced."""
    if s.get("fed") != 1:
        return ""
    if s.get("fedup") != 1:
        return (f"fed=ALERT:coord-down(fail-open) "
                f"rnd={s.get('fedrnd', '?')} ")
    fedage = s.get("fedage")
    if isinstance(fedage, int) and fedage > _FED_STALE_MS:
        return (f"fed=ALERT:coord-stale({fedage / 1e3:.0f}s) "
                f"rnd={s.get('fedrnd', '?')} ")
    return (f"fed=rnd{s.get('fedrnd', '?')}"
            f"/exp{s.get('fedexp', '?')}"
            f"/{s.get('fedlat', '?')}ms ")


def _fetch(sock, timeout):
    """Summary + fairness rows only. Deliberately NOT want_telem: the
    scheduler's trace replay ring is drain-on-read with one consumer,
    and `top` renders nothing from it — a refreshing `top` must never
    steal the events a FleetCollector/bench trace sink is polling for."""
    return fetch_sched_stats(path=sock, timeout=timeout,
                             want_telem=False)


def _fmt_bytes(n) -> str:
    if not isinstance(n, (int, float)):
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return (f"{n:.0f}{unit}" if unit == "B"
                    else f"{n / 1.0:.1f}{unit}")
        n /= 1024.0
    return "?"


def _bar(share: float, width: int = _BAR_W) -> str:
    share = min(max(share, 0.0), 1.0)
    filled = int(round(share * width))
    return "#" * filled + "." * (width - filled)


#: ``whist=`` bucket labels (upper bounds 10ms/100ms/1s/10s/+inf —
#: src/arbiter_core.hpp kSloWaitBucketsMs).
_WHIST_LABELS = ("<10ms", "<100ms", "<1s", "<10s", ">10s")


def _slo_col(c: dict) -> str:
    """The SLO column: scheduler-observed MEDIAN grant-latency bucket
    plus horizon-prediction accuracy (``<1s/87%``). Rendered only for
    rows a TPUSHARE_FLIGHT=1 daemon annotated; ``-`` halves mean "no
    samples yet"."""
    counts = parse_whist(c.get("whist"))
    lat = "-"
    if counts and sum(counts) > 0:
        acc, total = 0, sum(counts)
        for n, lab in zip(counts, _WHIST_LABELS):
            acc += n
            if 2 * acc >= total:
                lat = lab
                break
    hacc = c.get("hacc")
    acc_s = f"{hacc / 10:.0f}%" if isinstance(hacc, int) else "-"
    return f"{lat}/{acc_s}"


def _why_col(c: dict) -> str:
    """The WHY column: the tenant's DOMINANT wait cause and its share of
    the cumulative gate wait (``hold 67%``), from the wait-cause ledger
    ``wc=`` token. ``-`` means no attributed wait yet."""
    wc = parse_wc(c.get("wc"))
    if not wc:
        return "-"
    cause, ms = max(wc.items(), key=lambda kv: kv[1])
    total = sum(wc.values())
    return f"{cause[:9]} {100 * ms // max(total, 1)}%"


def render_plain(stats: dict, starve_after_s: Optional[float] = None,
                 width: int = 120) -> str:
    """One text frame from an extended stats fetch — the pure renderer
    both the curses and plain loops (and the tests) share."""
    s = stats.get("summary", {})
    tq = s.get("tq", 0)
    if starve_after_s is None:
        starve_after_s = max(2.0 * (tq if isinstance(tq, int) else 0), 5.0)
    up_s = (s.get("up", 0) or 0) / 1e3
    pol = s.get("qpol")
    # Co-residency (capacity-aware co-admission): co= live concurrent
    # holds, coadm= concurrent grants so far — present only when the
    # daemon is coadmit-configured.
    co = s.get("co")
    co_hdr = (f"co={co}/{s.get('coadm', '?')} "
              if isinstance(co, int) else "")
    rows = sorted(stats.get("clients", []),
                  key=lambda c: -(c.get("occ_pm") or 0))
    # The SLO column (scheduler-authoritative grant latency + horizon
    # accuracy) appears only when the daemon annotates rows with it
    # (TPUSHARE_FLIGHT=1) — recorder-less frames stay column-identical.
    flight = any(isinstance(c.get("whist"), str) for c in rows)
    slo_hdr = f" {'SLO':>10}" if flight else ""
    # The WHY column (dominant wait cause per tenant, wait-cause ledger)
    # follows the same gating: only rows a flight-armed daemon annotated
    # with wc= render it — recorder-less frames stay column-identical.
    why = any(isinstance(c.get("wc"), str) for c in rows)
    why_hdr = f" {'WHY':>13}" if why else ""
    lines = [
        "tpushare-top — fleet view  "
        f"[sched {'ON' if s.get('on') else 'OFF'} tq={tq}s "
        + (f"policy={pol} " if isinstance(pol, str) else "")
        + co_hdr
        + _fed_hdr(s)
        + f"up={up_s:.0f}s queue={s.get('queue', '?')} "
        f"grants={s.get('grants', '?')} drops={s.get('drops', '?')} "
        f"holder={s.get('holder', '-')}]",
        f"{'TENANT':<20} {'QOS':>6} {'OCCUPANCY':<{_BAR_W + 7}} "
        f"{'WAIT':>6} {'RES/VIRT':>19} {'CLEAN':>6} {'GR':>4} {'PRE':>4} "
        f"{'REV':>4}{slo_hdr}{why_hdr}  ALERT",
    ]
    # Entitled shares from the declared weights (undeclared rows weigh 1,
    # exactly like the scheduler's WFQ): the entitlement-aware starving
    # threshold below compares each row's achieved occupancy against it.
    weights = {id(c): (c.get("qw") if isinstance(c.get("qw"), int)
                       and c.get("qw") >= 1 else 1) for c in rows}
    total_w = sum(weights.values())
    total_occ = 0.0
    for c in rows:
        occ = (c.get("occ_pm") or 0) / 1000.0
        total_occ += occ
        wait = (c.get("wait_pm") or 0) / 1000.0
        starve_s = (c.get("starve_ms") or 0) / 1e3
        clean = c.get("clean_pm")
        revoked = c.get("revoked", 0) or 0
        declared = isinstance(c.get("qw"), int) and c.get("qw") >= 1
        qos_col = (f"{c.get('qos', '?')}:{c.get('qw')}" if declared
                   else "-")
        entitled = weights[id(c)] / total_w if total_w else 0.0
        # Entitlement-aware threshold: a declared tenant far below its
        # share starves at 1/4 the plain threshold.
        thr = starve_after_s
        if declared and occ < 0.5 * entitled:
            thr = starve_after_s / 4.0
        alert = f"STARVING {starve_s:.1f}s" if starve_s > thr else ""
        # A starving tenant whose cumulative wait is >80% one cause gets
        # the culprit named in the alert — the ledger's whole point.
        wc = parse_wc(c.get("wc"))
        if alert and wc:
            cause, cms = max(wc.items(), key=lambda kv: kv[1])
            total_wc = sum(wc.values())
            if total_wc > 0 and 5 * cms > 4 * total_wc:
                alert += f" cause={cause}"
        if revoked and not alert:
            alert = f"REVOKED x{revoked}"
        # Flight-recorder revoke-margin SLO: a tenant whose releases have
        # landed within half a second of the revoke deadline is one load
        # spike away from zombie-hood — worth an alert before it happens.
        # Negative = a release that landed AFTER the deadline and only
        # beat the revoke by racing the timer thread: already over it.
        rmarg = c.get("rmarg")
        if not alert and isinstance(rmarg, int) and rmarg < 500:
            alert = (f"LATE-RELEASE {-rmarg}ms" if rmarg < 0
                     else f"TIGHT-RELEASE {rmarg}ms")
        slo_col = f" {_slo_col(c):>10}" if flight else ""
        why_col = f" {_why_col(c):>13}" if why else ""
        lines.append(
            f"{str(c.get('client', '?'))[:20]:<20} {qos_col:>6} "
            f"|{_bar(occ)}| {occ:5.1%} {wait:6.1%} "
            f"{_fmt_bytes(c.get('res')):>9}/"
            f"{_fmt_bytes(c.get('virt')):>9} "
            f"{(clean / 1000 if isinstance(clean, int) else 0):>6.0%} "
            f"{c.get('grants', 0):>4} {c.get('preempt', 0):>4} "
            f"{revoked:>4}{slo_col}{why_col}  {alert}")
    if not rows:
        lines.append("  (no registered tenants)")
    # Overlapping-occupancy semantics: under co-residency wall-clock
    # occupancy legitimately sums past 100% (concurrent holds). The
    # invariant moves to DEVICE-seconds — the scheduler's dev_pm
    # attribution splits each overlapped interval among its holders, and
    # THAT total must stay <= 100%.
    dev_rows = [c.get("dev_pm") for c in rows
                if isinstance(c.get("dev_pm"), int)]
    if dev_rows:
        total_dev = sum(dev_rows) / 1000.0
        lines.append(
            f"{'TOTAL':<20} |{_bar(total_dev)}| {total_dev:5.1%} "
            f"device-seconds (wall occupancy {total_occ:5.1%}; "
            f"co-residency may exceed 100%)")
    else:
        lines.append(f"{'TOTAL':<20} |{_bar(total_occ)}| {total_occ:5.1%}"
                     f"  (exclusive lock: must stay <= 100%)")
    return "\n".join(line[:width] for line in lines)


def _loop_plain(args) -> int:
    n = 0
    while True:
        try:
            stats = _fetch(args.sock, args.timeout)
        except OSError as e:
            print(f"scheduler unreachable: {e}", file=sys.stderr)
            return 2
        print(render_plain(stats, args.starve_after))
        n += 1
        if args.once or (args.iterations and n >= args.iterations):
            return 0
        print()
        time.sleep(args.interval)


def _loop_curses(args) -> int:
    import curses

    def run(scr):
        curses.curs_set(0)
        scr.nodelay(True)
        while True:
            try:
                stats = _fetch(args.sock, args.timeout)
                frame = render_plain(stats, args.starve_after,
                                     width=max(scr.getmaxyx()[1] - 1, 20))
            except OSError as e:
                frame = f"scheduler unreachable: {e}"
            scr.erase()
            maxy = scr.getmaxyx()[0]
            for i, line in enumerate(frame.splitlines()[:maxy - 1]):
                try:
                    scr.addstr(i, 0, line)
                except curses.error:
                    pass
            scr.refresh()
            if args.once:
                return
            deadline = time.time() + args.interval
            while time.time() < deadline:
                if scr.getch() in (ord("q"), 27):
                    return
                time.sleep(0.05)

    curses.wrapper(run)
    return 0


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nvshare_tpu_torch.telemetry.top",
        description="Live per-tenant fairness view of a tpushare "
                    "scheduler (occupancy, waits, residency, starvation).")
    ap.add_argument("--sock", default=None,
                    help="scheduler socket path (default: "
                         "$TPUSHARE_SOCK_DIR/scheduler.sock)")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="refresh interval seconds (default 1)")
    ap.add_argument("--once", action="store_true",
                    help="render a single frame and exit")
    ap.add_argument("--iterations", type=int, default=0,
                    help="exit after N frames (plain mode; 0 = forever)")
    ap.add_argument("--plain", action="store_true",
                    help="plain-text frames instead of curses")
    ap.add_argument("--starve-after", type=float, default=None,
                    help="starvation alert threshold seconds "
                         "(default: 2x the scheduler quantum)")
    ap.add_argument("--timeout", type=float, default=10.0)
    args = ap.parse_args(argv)
    if args.plain or args.iterations or not sys.stdout.isatty():
        return _loop_plain(args)
    try:
        return _loop_curses(args)
    except ImportError:
        return _loop_plain(args)


if __name__ == "__main__":
    sys.exit(main())
