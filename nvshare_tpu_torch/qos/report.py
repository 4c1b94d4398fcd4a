"""``python -m nvshare_tpu_torch.qos.report`` — achieved vs entitled, from a
fleet trace.

Replays a fleet-merged Chrome trace (``merge_trace`` output — the
``merged_trace.json`` / ``chaos_trace.json`` CI artifacts, or a
``TPUSHARE_FLEET_TRACE_OUT`` capture) into the two numbers a QoS
contract is judged by:

  * **achieved vs entitled occupancy share** per tenant — achieved from
    the merged ``device-lock`` spans, entitled from the declared weights
    (``weight_i / sum(weights)``, undeclared tenants counting as weight
    1, exactly like the scheduler's WFQ);
  * **per-class gate-wait percentiles** — from the ``GATE_WAIT`` instants
    both client runtimes emit whenever gated work actually blocked
    (p50/p90/p99 per latency class).

Tenant→spec mapping comes from ``--spec name=class:weight`` flags and/or
a ``--stats`` JSON (a ``fetch_sched_stats`` dump whose fairness rows
carry the scheduler-validated ``qos=``/``qw=`` labels); unmapped tenants
default to undeclared batch.

Usage::

    python -m nvshare_tpu_torch.qos.report artifacts/merged_trace.json \
        --spec inter=interactive:2 --spec batch1=batch:1 [--json]

The module half (:func:`build_report`) is the library API
``chip_smoke.py``'s QoS pair and the tests use.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from nvshare_tpu_torch.qos.spec import (
    QosSpec,
    TOKEN_CLASSES,
    entitled_shares,
    parse_qos,
)


def tenant_tracks(trace: dict) -> dict:
    """{tid: tenant name} from the trace's thread_name metadata, minus
    the scheduler/handoffs bookkeeping tracks."""
    out = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            name = e.get("args", {}).get("name", "")
            if name and name not in ("scheduler", "handoffs"):
                out[e.get("tid")] = name
    return out


def lock_spans_by_tenant(trace: dict) -> dict:
    """{tenant: [(start_us, dur_us), ...]} of its device-lock spans."""
    tracks = tenant_tracks(trace)
    out: dict = {name: [] for name in tracks.values()}
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("name") == "device-lock":
            name = tracks.get(e.get("tid"))
            if name is not None:
                out[name].append((float(e.get("ts", 0.0)),
                                  float(e.get("dur", 0.0))))
    return out


def achieved_shares(trace: dict) -> dict:
    """{tenant: share of total held time in [0, 1]}. Normalized over the
    SUM of hold time (not wall time): handoff dead time belongs to the
    system, not to any tenant's entitlement."""
    spans = lock_spans_by_tenant(trace)
    held = {n: sum(d for _, d in ss) for n, ss in spans.items()}
    total = sum(held.values())
    if total <= 0:
        return {}
    return {n: h / total for n, h in held.items()}


def gate_waits_by_tenant(trace: dict) -> dict:
    """{tenant: [gate-wait seconds, ...]} from the GATE_WAIT instants."""
    tracks = tenant_tracks(trace)
    out: dict = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "i" or e.get("name") != "GATE_WAIT":
            continue
        name = tracks.get(e.get("tid"))
        if name is None:
            continue
        try:
            s = float(e.get("args", {}).get("seconds", 0.0))
        except (TypeError, ValueError):
            continue
        out.setdefault(name, []).append(s)
    return out


def percentile(xs: list, p: float) -> Optional[float]:
    """Nearest-rank percentile (None on empty input)."""
    if not xs:
        return None
    xs = sorted(xs)
    k = max(0, min(len(xs) - 1, int(round(p / 100.0 * len(xs) + 0.5)) - 1))
    return xs[k]


def specs_from_stats(stats: dict) -> dict:
    """{tenant: QosSpec|None} from a ``fetch_sched_stats`` dump's
    fairness rows (the scheduler-validated ``qos=``/``qw=`` labels)."""
    out = {}
    for c in stats.get("clients", []):
        name = c.get("client", "?")
        klass = TOKEN_CLASSES.get(c.get("qos"))
        qw = c.get("qw")
        if klass is not None and isinstance(qw, int) and qw >= 1:
            out[name] = QosSpec(klass=klass, weight=qw)
        else:
            out.setdefault(name, None)
    return out


def build_report(trace: dict, specs: Optional[dict] = None) -> dict:
    """The replay: achieved-vs-entitled share per tenant + per-class
    gate-wait percentiles. ``specs`` maps tenant -> QosSpec|None; tenants
    seen in the trace but absent from the map count as undeclared."""
    specs = dict(specs or {})
    achieved = achieved_shares(trace)
    for name in achieved:
        specs.setdefault(name, None)
    entitled = entitled_shares(
        {n: (s.weight if s is not None else None)
         for n, s in specs.items()})
    tenants = {}
    for name in sorted(specs):
        spec = specs[name]
        ach = achieved.get(name)
        ent = entitled.get(name)
        tenants[name] = {
            "qos": str(spec) if spec is not None else None,
            "class": spec.class_name if spec is not None else "batch",
            "weight": spec.weight if spec is not None else 1,
            "achieved_share": round(ach, 4) if ach is not None else None,
            "entitled_share": round(ent, 4) if ent is not None else None,
            "share_error": (round(ach - ent, 4)
                            if ach is not None and ent is not None
                            else None),
        }
    waits = gate_waits_by_tenant(trace)
    by_class: dict = {}
    for name, ws in waits.items():
        spec = specs.get(name)
        cls = spec.class_name if spec is not None else "batch"
        by_class.setdefault(cls, []).extend(ws)
    classes = {}
    for cls, ws in sorted(by_class.items()):
        classes[cls] = {
            "gate_waits": len(ws),
            "p50_s": percentile(ws, 50),
            "p90_s": percentile(ws, 90),
            "p99_s": percentile(ws, 99),
        }
    return {"tenants": tenants, "classes": classes,
            "max_share_error": max(
                (abs(t["share_error"]) for t in tenants.values()
                 if t["share_error"] is not None), default=None)}


def render_text(report: dict) -> str:
    lines = [f"{'TENANT':<24} {'QOS':>16} {'ACHIEVED':>9} {'ENTITLED':>9} "
             f"{'ERROR':>7}"]
    for name, t in report["tenants"].items():
        ach, ent, err = (t["achieved_share"], t["entitled_share"],
                         t["share_error"])
        lines.append(
            f"{name[:24]:<24} {(t['qos'] or '-'):>16} "
            f"{(f'{ach:.1%}' if ach is not None else '-'):>9} "
            f"{(f'{ent:.1%}' if ent is not None else '-'):>9} "
            f"{(f'{err:+.1%}' if err is not None else '-'):>7}")
    for cls, c in report["classes"].items():
        def fmt(v):
            return f"{v * 1e3:.1f}ms" if v is not None else "-"
        lines.append(
            f"class {cls:<12} gate-waits={c['gate_waits']:<6} "
            f"p50={fmt(c['p50_s'])} p90={fmt(c['p90_s'])} "
            f"p99={fmt(c['p99_s'])}")
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nvshare_tpu_torch.qos.report",
        description="Replay a fleet trace into achieved-vs-entitled "
                    "occupancy shares and per-class gate-wait "
                    "percentiles.")
    ap.add_argument("trace", help="fleet-merged Chrome trace JSON "
                                  "(merge_trace output)")
    ap.add_argument("--spec", action="append", default=[],
                    metavar="NAME=CLASS:WEIGHT",
                    help="tenant QoS mapping, repeatable")
    ap.add_argument("--stats", default=None,
                    help="fetch_sched_stats JSON dump: read the "
                         "scheduler-validated qos=/qw= row labels")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    trace = json.loads(open(args.trace).read())
    specs: dict = {}
    if args.stats:
        specs.update(specs_from_stats(json.loads(open(args.stats).read())))
    for item in args.spec:
        name, _, spec_s = item.partition("=")
        if not name or not spec_s:
            print(f"bad --spec {item!r} (want NAME=CLASS:WEIGHT)",
                  file=sys.stderr)
            return 2
        specs[name] = parse_qos(spec_s)
    report = build_report(trace, specs)
    print(json.dumps(report, indent=2, sort_keys=True) if args.json
          else render_text(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
