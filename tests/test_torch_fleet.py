"""The port's fleet plane (``nvshare_tpu_torch.telemetry.fleet``) against
the JAX package's: the push-frame codec, the merged trace with its
handoff split, occupancy shares and the fleet gauges on the same inputs
(exact), then a pair of port tenants streaming to the real scheduler
with ``TPUSHARE_FLEET=1``.
"""

import threading
import time

import numpy as np
import pytest

from nvshare_tpu.telemetry import fleet as ref_fleet
from nvshare_tpu.telemetry import prometheus as ref_prom
from nvshare_tpu.telemetry.registry import Registry as RefRegistry
from nvshare_tpu_torch.telemetry import events as tev
from nvshare_tpu_torch.telemetry import fleet as port_fleet
from nvshare_tpu_torch.telemetry import prometheus as port_prom
from nvshare_tpu_torch.telemetry.registry import Registry as PortRegistry

MB = 1 << 20

EVENTS = [
    (tev.LOCK_ACQUIRE, "tenant-a", {"runtime": "python"}),
    (tev.HANDOFF, "tenant-a", {"n": 4, "seconds": 0.030001, "moved": 1 << 30,
                               "clean": 2}),
    (tev.GATE_WAIT, "b" * 80, {"seconds": 1.5}),
    (tev.DROP_LOCK, "x y=z", {"held": True, "k": "spoof", "w": "spoof"}),
    (tev.FAULT, "t", {f"a{i}": "v" * 12 for i in range(12)}),
    (tev.PREFETCH, "t", None),
]


@pytest.mark.parametrize("i", range(len(EVENTS)))
def test_event_codec_matches_reference(i):
    kind, who, args = EVENTS[i]
    e = tev.Event(seq=i, ts=123.456789, wall=1.0, kind=kind, who=who,
                  args=args)
    line = port_fleet.encode_event(e, now_us=987654321)
    assert line == ref_fleet.encode_event(e, now_us=987654321)
    assert port_fleet.decode_event_line(line) == \
        ref_fleet.decode_event_line(line)


@pytest.mark.parametrize("kw", [
    {}, {"evictions": 17, "faults": 5}, {"wss": 1 << 33},
    {"evictions": 10 ** 15, "faults": 10 ** 15, "wss": 10 ** 15}])
def test_met_codec_matches_reference(kw):
    args = ("w" * 60, 32 * MB, 96 * MB, 77 << 30, 900)
    line = port_fleet.encode_met(*args, now_us=42, **kw)
    assert line == ref_fleet.encode_met(*args, now_us=42, **kw)
    assert port_fleet.decode_event_line(line) == \
        ref_fleet.decode_event_line(line)


@pytest.mark.parametrize("line", ["", "garbage", "k=", "k=X ts=abc now=",
                                  "k=A w=b ts=1 now=2 x=3 x=4 tail="])
def test_decode_garbage_matches_reference(line):
    assert port_fleet.decode_event_line(line) == \
        ref_fleet.decode_event_line(line)


def _ev(kind, who, t, sender="p", **args):
    return {"kind": kind, "who": who, "t": t, "sender": sender,
            "args": args}


ALIGNED = sorted([
    _ev("GRANT", "a", 9.999, sender="sched", r=6),
    _ev("LOCK_ACQUIRE", "a", 10.0),
    _ev("DROP", "a", 11.0, sender="sched", r=7),
    _ev("HANDOFF", "a", 11.030, seconds="0.03", n=4, clean=4),
    _ev("LOCK_RELEASE", "a", 11.031),
    _ev("GRANT", "b", 11.035, sender="sched", r=8),
    _ev("LOCK_ACQUIRE", "b", 11.036),
    _ev("PREFETCH", "b", 11.050, n=4),
    _ev("GATE_WAIT", "a", 11.9, seconds=0.9),
    _ev("DROP", "b", 12.0, sender="sched", r=8),
    _ev("HANDOFF", "b", 12.5, seconds=0.5, n=4),
    _ev("LOCK_RELEASE", "b", 12.51),
    _ev("GRANT", "a", 12.52, sender="sched", r=9),
    _ev("LOCK_ACQUIRE", "a", 12.521),
    _ev("LOCK_ACQUIRE", "c", 13.0),
], key=lambda e: e["t"])


def test_merge_trace_and_handoff_split_match_reference():
    got = port_fleet.merge_trace(ALIGNED, clock_offsets={"p": 0.25})
    want = ref_fleet.merge_trace(ALIGNED, clock_offsets={"p": 0.25})
    assert got["traceEvents"] == want["traceEvents"]
    assert got["otherData"]["clock_offsets_s"] == \
        want["otherData"]["clock_offsets_s"]
    hs = port_fleet.handoff_summaries(got)
    assert hs == ref_fleet.handoff_summaries(want)
    assert [(h["holder"], h["next"], h["corr"]) for h in hs] == \
        [("a", "b", "h8"), ("b", "a", "h9")]
    assert hs[0]["writeback_s"] == pytest.approx(0.03, abs=1e-9)


_STATS = {
    "summary": {"on": 1, "tq": 1, "queue": 2, "grants": 12, "drops": 4,
                "up": 20_000, "telem": 3},
    "clients": [
        {"client": "busy-a", "occ_pm": 700, "wait_pm": 100, "starve_ms": 0,
         "preempt": 3, "pushes": 40, "grants": 8, "res": 32 * MB,
         "virt": 96 * MB, "clean_pm": 900, "revoked": 1},
        {"client": "co-b", "occ_pm": 800, "dev_pm": 450, "cog": 2},
        {"client": "old-c", "occ_pm": "x"},
    ],
}


def test_occupancy_and_fleet_gauges_match_reference():
    assert port_fleet.occupancy_shares(_STATS) == \
        ref_fleet.occupancy_shares(_STATS)
    port_reg, ref_reg = PortRegistry(), RefRegistry()
    port_fleet.fleet_to_registry(_STATS, port_reg)
    ref_fleet.fleet_to_registry(_STATS, ref_reg)
    assert port_prom.render_text(port_reg) == ref_prom.render_text(ref_reg)


def test_port_tenant_pair_streams_to_the_scheduler(monkeypatch, tmp_path,
                                                   native_build):
    """Two port tenants with the fleet plane on, against the real
    scheduler: the merged trace holds both tenants' lock spans on one
    timeline without overlap, every handoff splits into writeback, wire
    and page-in (the writeback a recorded HANDOFF sample), the occupancy
    shares sum to at most 1, and each tenant's k=MET push carries its
    arena's residency gauges (the series the port's arena now
    publishes; an unpublished one would stream as 0)."""
    from nvshare_tpu_torch import telemetry, vmem
    from nvshare_tpu_torch.colocate import Tenant, run_colocated
    from nvshare_tpu_torch.telemetry.chrome_trace import (
        lock_spans,
        spans_overlap,
    )
    from nvshare_tpu_torch.telemetry.dump import fetch_sched_stats
    from tests.conftest import SchedulerProc

    monkeypatch.setenv("TPUSHARE_SOCK_DIR", str(tmp_path))
    monkeypatch.setenv("TPUSHARE_FLEET", "1")
    monkeypatch.setenv("TPUSHARE_FLEET_PUSH_S", "0.1")
    monkeypatch.setenv("TPUSHARE_RELEASE_CHECK_S", "30")
    telemetry.reset_ring()
    port_fleet.reset_streamer()
    s = SchedulerProc(tmp_path, tq_sec=1)
    tenants = []
    try:
        tenants = [Tenant(n, budget_bytes=64 * MB, device="cpu")
                   for n in ("torch-fa", "torch-fb")]
        op = vmem.vop(lambda v: v * 1.0001)

        def workload(tenant):
            x = tenant.arena.array(np.ones((512, 512), np.float32))
            deadline = time.time() + 2.5
            while time.time() < deadline:
                x = op(x)
                time.sleep(0.02)
            return float(x.numpy()[0, 0])

        # Rows read while the workloads' arrays live (non-draining: the
        # collector keeps the replay). A row is one frame and may lose
        # its tail under load, so keep every field any row carried.
        pushed = {t.name: {} for t in tenants}
        done = threading.Event()

        def watch():
            while not done.wait(0.05):
                try:
                    rows = fetch_sched_stats()["clients"]
                except (OSError, ValueError):  # a slow poll: try again
                    continue
                for c in rows:
                    if c["client"] in pushed and c.get("virt"):
                        pushed[c["client"]].update(c)

        watcher = threading.Thread(target=watch)
        watcher.start()
        coll = port_fleet.FleetCollector()
        try:
            report = run_colocated({t: workload for t in tenants},
                                   timeout_s=120)
        finally:
            done.set()
            watcher.join(timeout=30)
        assert report.ok, report.errors
        port_fleet.reset_streamer()  # the last push carries the tail
        st = coll.poll()
        shares = port_fleet.occupancy_shares(st)
        assert set(shares) == {"torch-fa", "torch-fb"}
        assert all(v > 0 for v in shares.values()) and \
            sum(shares.values()) <= 1.0, shares
        for n, row in pushed.items():
            assert row.get("virt") == MB, row
            assert row.get("budget", 64 * MB) == 64 * MB, row
            assert row.get("res", 0) in (0, MB), row
        trace = coll.merge_trace()
        spans = lock_spans(trace)
        assert spans.get("torch-fa") and spans.get("torch-fb")
        assert not spans_overlap(spans["torch-fa"], spans["torch-fb"],
                                 tolerance_us=500)
        hs = port_fleet.handoff_summaries(trace)
        assert len(hs) >= 1, hs
        samples = [float(e["args"]["seconds"])
                   for e in coll.aligned_events()
                   if e["kind"] == tev.HANDOFF and "seconds" in e["args"]]
        for h in hs:
            assert {h["holder"], h["next"]} <= {"torch-fa", "torch-fb"}
            total = h["writeback_s"] + h["wire_s"] + h["pagein_s"]
            assert total * 1e6 == pytest.approx(h["dur_us"], abs=2.0)
            assert any(h["writeback_s"] == pytest.approx(x, abs=1e-6)
                       for x in samples)
    finally:
        port_fleet.reset_streamer()
        for t in tenants:
            t.close()
        s.stop()
