"""The port's exporters (Chrome trace, Prometheus text, the self-check),
its scheduler-stats dump and ``top`` against the JAX package's on the
same inputs, and the arena's residency gauges against the JAX arena's on
the same op sequence. All comparisons are exact: these are text and
integer transforms of the same data.
"""

import json
import math
import urllib.request

import numpy as np
import pytest

from nvshare_tpu.telemetry import chrome_trace as ref_trace
from nvshare_tpu.telemetry import dump as ref_dump
from nvshare_tpu.telemetry import prometheus as ref_prom
from nvshare_tpu.telemetry import top as ref_top
from nvshare_tpu.telemetry.registry import Registry as RefRegistry
from nvshare_tpu_torch.telemetry import chrome_trace as port_trace
from nvshare_tpu_torch.telemetry import dump as port_dump
from nvshare_tpu_torch.telemetry import events as port_events
from nvshare_tpu_torch.telemetry import prometheus as port_prom
from nvshare_tpu_torch.telemetry import top as port_top
from nvshare_tpu_torch.telemetry.registry import Registry as PortRegistry


def _filled_ring():
    ring = port_events.EventRing(capacity=16)
    ev = port_events
    for kind, who, args in (
            (ev.LOCK_ACQUIRE, "a", {"runtime": "python"}),
            (ev.FAULT, "a", {"n": 2}),
            (ev.LOCK_RELEASE, "a", {"reason": "drop", "seconds": 0.5}),
            (ev.GATE_WAIT, "b", {"seconds": 0.25}),
            (ev.LOCK_ACQUIRE, "b", None),
            (ev.HANDOFF, "b", {"n": 1, "seconds": 0.125}),
            (ev.LOCK_RELEASE, "b", {"reason": "idle"}),
            (ev.LOCK_ACQUIRE, "a", None),
            (ev.PREFETCH, "a", {"n": 3, "bytes": 4096}),
            (ev.LOCK_RELEASE, "a", {"reason": "explicit"}),
            (ev.LOCK_ACQUIRE, "c", None)):
        ring.record(kind, who, args)
    return ring


@pytest.mark.parametrize("capacity", [16, 4])
def test_chrome_trace_matches_reference(capacity):
    """One filled port ring (and a wrapped one) exported by both
    packages: the same events, spans and dropped count."""
    full = _filled_ring()
    ring = port_events.EventRing(capacity=capacity)
    for e in full.snapshot():
        ring.record(e.kind, e.who, e.args)
    got, want = port_trace.build_trace(ring), ref_trace.build_trace(ring)
    assert got["traceEvents"] == want["traceEvents"]
    assert got["otherData"]["events_dropped_by_ring"] == \
        want["otherData"]["events_dropped_by_ring"]
    assert port_trace.lock_spans(got) == ref_trace.lock_spans(want)
    spans = port_trace.lock_spans(got)
    for a, b in (("a", "b"), ("a", "c")):
        assert port_trace.spans_overlap(spans.get(a, []), spans.get(b, [])) \
            == ref_trace.spans_overlap(spans.get(a, []), spans.get(b, []))


def test_chrome_trace_export_writes_the_trace(tmp_path):
    ring = _filled_ring()
    out = tmp_path / "trace.json"
    trace = port_trace.export_chrome_trace(str(out), ring)
    assert json.loads(out.read_text()) == json.loads(json.dumps(trace))
    assert any(e["ph"] == "B" for e in trace["traceEvents"])  # c is live


def _fill(registry_cls):
    reg = registry_cls()
    reg.counter("t_c_total", "a counter", ["job"]).labels(
        job='we"ird\\name').inc(3)
    reg.counter("t_c_total", "a counter", ["job"]).labels(job="b").inc()
    reg.gauge("t_g_bytes", "a gauge").set(1.5)
    reg.gauge("t_g_ratio", "", ["client", "kind"]).labels(
        client="x", kind="y").set(2 ** 60)
    h = reg.histogram("t_h_seconds", "a histogram", ["client"],
                      buckets=[0.1, 1.0, math.inf]).labels(client="x")
    for v in (0.05, 0.5, 99.0):
        h.observe(v)
    reg.histogram("t_default_seconds", "default buckets").observe(0.3)
    return reg


def test_prometheus_text_matches_reference(tmp_path):
    """One registry filled the same way in each package renders the same
    exposition, over HTTP and into a textfile too."""
    port_reg, ref_reg = _fill(PortRegistry), _fill(RefRegistry)
    text = port_prom.render_text(port_reg)
    assert text == ref_prom.render_text(ref_reg)
    srv = port_prom.start_http_server(port=0, reg=port_reg)
    try:
        with urllib.request.urlopen(srv.url, timeout=10) as r:
            assert r.read().decode() == text
    finally:
        srv.close()
    port_prom.write_textfile(str(tmp_path / "p.prom"), port_reg)
    ref_prom.write_textfile(str(tmp_path / "r.prom"), ref_reg)
    assert (tmp_path / "p.prom").read_text() == \
        (tmp_path / "r.prom").read_text()


def test_textfile_placeholders_match_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSHARE_JOB_NAME", "jobx")
    for path in (str(tmp_path / "m-{pid}-{job}.prom"),
                 str(tmp_path / "plain.prom")):
        assert port_prom._expand_textfile_path(path) == \
            ref_prom._expand_textfile_path(path)


def test_exporter_starts_from_env_at_arena_creation(monkeypatch):
    """$TPUSHARE_METRICS_PORT, formerly refused, starts the exporter
    where the JAX package starts it: at arena creation."""
    from nvshare_tpu_torch import vmem

    monkeypatch.setattr(port_prom, "_auto_server", None)
    monkeypatch.setenv("TPUSHARE_METRICS_PORT", "0")
    a = vmem.VirtualHBM(device="cpu", budget_bytes=1 << 20,
                        name="torch-exporter")
    srv = port_prom._auto_server
    try:
        assert srv is not None
        x = a.array(np.ones((16, 16), np.float32))
        with urllib.request.urlopen(srv.url, timeout=10) as r:
            body = r.read().decode()
        assert 'tpushare_tracked_bytes{client="torch-exporter"} 1024' \
            in body
        del x
    finally:
        a.close()
        srv.close()


def test_selfcheck_module():
    from nvshare_tpu_torch.telemetry.check import selfcheck

    assert selfcheck(verbose=False) == 0


def test_arena_residency_gauges_match_the_jax_arena():
    """The gauges the fleet streamer reads (resident, tracked, budget
    bytes) hold the same values as the JAX arena's after the same ops,
    and a closed arena's series leave the exposition."""
    from nvshare_tpu import telemetry as ref_tel
    from nvshare_tpu import vmem as ref_vmem
    from nvshare_tpu_torch import telemetry as port_tel
    from nvshare_tpu_torch import vmem as port_vmem

    def run(vmem, tel, name):
        a = vmem.VirtualHBM(budget_bytes=3 * 4096, name=name,
                            **({"device": "cpu"} if vmem is port_vmem
                               else {}))
        xs = [a.array(np.full((32, 32), i, np.float32)) for i in range(4)]
        snap = tel.registry().snapshot()
        vals = [snap[k][(name,)] for k in ("tpushare_resident_bytes",
                                            "tpushare_tracked_bytes",
                                            "tpushare_budget_bytes")]
        a.close()
        snap = tel.registry().snapshot()
        gone = (name,) not in snap.get("tpushare_resident_bytes", {})
        del xs
        return vals, gone

    got = run(port_vmem, port_tel, "torch-gauges")
    want = run(ref_vmem, ref_tel, "jax-gauges")
    assert got == want
    assert got[0][0] <= got[0][2] < got[0][1] and got[1]


_STATS = {
    "summary": {"on": 1, "tq": 2, "held": 1, "queue": 2, "holder": "busy-a",
                "grants": 12, "drops": 4, "up": 20_000, "round": 12,
                "qpol": "wfq", "qpre": 2},
    "clients": [
        {"client": "busy-a", "occ_pm": 700, "wait_pm": 100, "starve_ms": 0,
         "preempt": 3, "pushes": 40, "grants": 8, "res": 32 << 20,
         "virt": 96 << 20, "clean_pm": 900, "qos": "int", "qw": 2,
         "whist": "1,2,3,0,0,0,0,0"},
        {"client": "starved-b", "occ_pm": 100, "wait_pm": 800,
         "starve_ms": 9_000, "preempt": 1, "pushes": 22, "grants": 4,
         "res": 0, "virt": 64 << 20, "clean_pm": 0, "qos": "bat", "qw": 1},
    ],
    "gangs": [], "events": [],
}


@pytest.mark.parametrize("tq", [2, 30])
def test_top_render_matches_reference(tq):
    stats = {**_STATS, "summary": dict(_STATS["summary"], tq=tq)}
    assert port_top.render_plain(stats) == ref_top.render_plain(stats)


@pytest.mark.parametrize("token", ["1,2,3,0,0,0,0,0", "", "x,1", None,
                                   "1;2", "lock:120,page:30,bogus"])
def test_dump_parsers_match_reference(token):
    assert port_dump.parse_whist(token) == ref_dump.parse_whist(token)
    assert port_dump.parse_wc(token) == ref_dump.parse_wc(token)


def test_stats_to_registry_matches_reference():
    port_reg, ref_reg = PortRegistry(), RefRegistry()
    port_dump.stats_to_registry(_STATS, port_reg)
    ref_dump.stats_to_registry(_STATS, ref_reg)
    assert port_prom.render_text(port_reg) == ref_prom.render_text(ref_reg)


def test_sched_stats_and_dump_cli_match_reference(sched, monkeypatch,
                                                  capsys):
    from nvshare_tpu_torch.runtime.protocol import MsgType, SchedulerLink

    monkeypatch.setenv("TPUSHARE_SOCK_DIR", sched.sock_dir)
    with SchedulerLink(job_name="stats-holder") as holder:
        holder.register()
        holder.send(MsgType.REQ_LOCK)
        assert holder.recv().type == MsgType.LOCK_OK
        got = port_dump.fetch_sched_stats()
        want = ref_dump.fetch_sched_stats()
        for st in (got, want):
            st["summary"].pop("up", None)
        assert got["summary"].keys() == want["summary"].keys()
        assert got["summary"]["holder"] == "stats-holder"
        assert [c["client"] for c in got["clients"]] == \
            [c["client"] for c in want["clients"]] == ["stats-holder"]
        assert port_dump.main(["--prom"]) == 0
        prom = capsys.readouterr().out
        assert ref_dump.main(["--prom"]) == 0
        ref_text = capsys.readouterr().out
        names = sorted({ln.split()[2] for ln in prom.splitlines()
                        if ln.startswith("# TYPE")})
        assert names == sorted({ln.split()[2] for ln in ref_text.splitlines()
                                if ln.startswith("# TYPE")})
        assert "tpushare_sched_queue_depth" in names
        assert port_top.main(["--once", "--plain"]) == 0
        assert "stats-holder" in capsys.readouterr().out
