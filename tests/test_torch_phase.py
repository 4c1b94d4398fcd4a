"""The port's serving-phase plane replayed against the JAX package's.

The arena-side cases of ``tests/test_phase.py`` (KV-tagged arrays evicted
last mid-decode, prefill activations leaving the hot set at the handoff,
the wss policy's inter-touch KV detection) run through a JAX arena and a
port arena (``device="cpu"``) with the same seeded inputs; both must make
the same residency decisions. The mock serving workloads
(``models/serving.py``) run in both packages on the same numpy inputs:
their paging counters must agree exactly and their checksums within f32
rounding (the two packages sum the einsums in another order). Then the
port's decode and prefill tenants run as a pair under the real
scheduler, with the pager and the wss policy, and must equal their solo
runs bit for bit.
"""

import time
import types

import numpy as np
import pytest

import nvshare_tpu.models.serving as jserving
import nvshare_tpu_torch.models.serving as tserving
import nvshare_tpu_torch.vmem as tvmem
from tests.test_torch_pager import SIDES, FakeClock, Side, run_both

# Checksums of the mock decoder after a few tokens, JAX against the port:
# softmax over 64 cached positions and two 64-wide contractions a layer in
# f32, summed in another order, a few ulps per value.
SERVE_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _port_process_arena():
    tvmem.reset_arena()
    tvmem.arena(device="cpu")
    yield
    tvmem.reset_arena()


@pytest.fixture
def clock(monkeypatch):
    import nvshare_tpu.pager.policy as jpolicy
    import nvshare_tpu_torch.pager.policy as tpolicy

    c = FakeClock()
    fake = types.SimpleNamespace(monotonic=c.monotonic)
    monkeypatch.setattr(jpolicy, "time", fake)
    monkeypatch.setattr(tpolicy, "time", fake)
    return c


def zeros(*shape):
    return np.zeros(shape, np.float32)


def sc_kv_pressure(side, tag):
    a = side.arena(f"{tag}-{side.name}", budget=1 << 20)
    try:
        kv = a.array(zeros(64, 1024))   # 256 KiB
        kv.phase_hint = "kv"
        cold = a.array(zeros(64, 1024))
        a.ensure([kv])
        a.ensure([cold])  # kv is now the COLDER of the two
        a.set_phase("decode")
        big = a.array(zeros(160, 1024))  # 640 KiB: pressure
        a.ensure([big])
        facts = {"decode": (kv.resident, cold.resident, big.resident)}
        # No phase: plain LRU; the tag alone changes nothing.
        a.set_phase(None)
        a.ensure([cold])
        a.ensure([kv])
        big2 = a.array(zeros(160, 1024))
        a.ensure([big2])
        facts.update(none=(kv.resident, cold.resident, big2.resident),
                     **side.facts(a))
        return {}, facts
    finally:
        a.close()


def test_kv_tagged_arrays_survive_decode_pressure():
    _, (_, f) = run_both(sc_kv_pressure, "kv")
    assert f["decode"] == (True, False, True)
    assert f["none"][1] is False


def sc_act_handoff(side, tag, pager):
    a = side.arena(f"{tag}-{side.name}", budget=8 << 20)
    p = side.pager.Pager(a, start=False) if pager else None
    try:
        act = a.array(zeros(64, 1024))
        act.phase_hint = "act"
        keep = a.array(np.ones((64, 1024), np.float32))
        a.ensure([act, keep])
        a.sync_and_evict_all()
        hot = [r() for r in a._hot]
        facts = {"evicted": (act.resident, keep.resident),
                 "hot": (keep in hot, act in hot)}
        if p is not None:
            p.on_lock_next()
        a.prefetch_hot()
        if p is not None:
            while p._bg_plan:
                p._bg_prefetch_tick()
        facts.update(back=(keep.resident, act.resident), **side.facts(a))
        return {}, facts
    finally:
        if p is not None:
            p.close()
        a.close()


@pytest.mark.parametrize("pager", [False, True], ids=["sync", "pager"])
def test_act_tagged_arrays_evict_after_use_at_handoff(pager):
    _, (_, f) = run_both(sc_act_handoff, f"act{int(pager)}", pager)
    assert f["evicted"] == (False, False)
    assert f["hot"] == (True, False)
    assert f["back"] == (True, False)


def sc_wss_kv(side, tag, clock):
    a = side.arena(f"{tag}-{side.name}", budget=4 << 20)
    pol = side.policy.WSSPolicy(f"{tag}-nobody")
    try:
        steady, oneshot, burst = (a.array(zeros(16, 1024))
                                  for _ in range(3))
        pol.on_touch(oneshot)
        for _ in range(8):  # one op touching an array many times at once
            pol.on_touch(burst)
        for _ in range(8):  # steady re-touches spanning several windows
            pol.on_touch(steady)
            clock.now += 0.005
        facts = {"kv": [pol.kv_resident(v)
                        for v in (steady, oneshot, burst)],
                 "itt": round(pol.inter_touch_ewma_s(steady), 9),
                 "kv_bytes": pol.kv_resident_bytes(),
                 "order": [x is steady for x in
                           pol.prefetch_order([oneshot, steady])]}
        a.pager = types.SimpleNamespace(policy=pol)
        a.set_phase("decode")
        facts["protected"] = (a._kv_protected(steady),
                              a._kv_protected(oneshot))
        a.set_phase(None)
        facts["idle"] = a._kv_protected(steady)
        a.pager = None
        return {}, facts
    finally:
        a.pager = None
        a.close()


def test_wss_inter_touch_ewma_classifies_kv(monkeypatch, clock):
    monkeypatch.setenv("TPUSHARE_WSS_KV_TOUCHES", "4")
    monkeypatch.setenv("TPUSHARE_WSS_WINDOW_S", "0.01")
    _, (_, f) = run_both(sc_wss_kv, "wsskv", clock)
    assert f["kv"] == [True, False, False]
    assert f["order"] == [True, False]
    assert f["protected"] == (True, False) and f["idle"] is False


def test_phase_hint_and_phase_are_validated():
    for side in SIDES:
        a = side.arena(f"hint-{side.name}", budget=1 << 20)
        try:
            va = a.array(zeros(4))
            assert va.phase_hint is None
            va.phase_hint = "kv"
            va.phase_hint = None
            with pytest.raises(ValueError):
                va.phase_hint = "weights"
            for phase in (None, "idle", "prefill", "decode"):
                a.set_phase(phase)
                assert a.phase == phase
            with pytest.raises(ValueError):
                a.set_phase("training")
        finally:
            a.close()


# -- the mock serving workloads ---------------------------------------------


class FakeTenant:
    """What the serving workloads need of a tenant, without a scheduler."""

    def __init__(self, arena):
        self.arena = arena
        self.client = types.SimpleNamespace(mark_activity=lambda: None,
                                            release_now=lambda: None)
        self.phases = []

    def set_phase(self, phase):
        self.arena.set_phase(phase)
        self.phases.append(phase)


SERVING = {"jax": jserving, "torch": tserving}


def sc_serving(side, tag, budget):
    """decode_workload then prefill_workload on one arena each, under
    ``budget``: the decode tenant's cache does not fit beside its other
    arrays when the budget is tight, so the KV order decides what moves."""
    m = SERVING[side.name]
    da = side.arena(f"{tag}d-{side.name}", budget=budget)
    pa = side.arena(f"{tag}p-{side.name}", budget=budget)
    try:
        dt, pt = FakeTenant(da), FakeTenant(pa)
        dec = m.decode_workload(tokens=12, layers=3, batch=4, max_len=64,
                                d_model=64, requests=2,
                                inter_request_s=0.0)(dt)
        pre = m.prefill_workload(bursts=3, seq=96, steps_per_burst=3)(pt)
        facts = {"decode_stats": dict(da.stats),
                 "prefill_stats": dict(pa.stats),
                 "phases": (dt.phases, pt.phases),
                 "decode": {k: dec[k] for k in ("tokens", "requests",
                                                "kv_bytes")},
                 "prefill": {k: pre[k] for k in ("bursts", "act_bytes",
                                                 "weight_bytes")},
                 "lat_n": len(dec["token_lat_s"])}
        return {}, dict(facts, checksums=(dec["checksum"],
                                          pre.get("checksum")))
    finally:
        da.close()
        pa.close()


@pytest.mark.parametrize("budget", [64 << 20, 200 << 10],
                         ids=["roomy", "tight"])
def test_serving_workloads_match_reference(budget):
    (_, jf), (_, tf) = [sc_serving(s, f"sv{budget}", budget)
                        for s in SIDES]
    jsum, tsum = jf.pop("checksums"), tf.pop("checksums")
    assert tf == jf
    np.testing.assert_allclose(tsum[0], jsum[0], rtol=SERVE_RTOL)
    assert np.isfinite(tsum[1]) and jsum[1] is None
    assert tf["phases"] == (["decode", "idle"], ["prefill", "idle"])
    if budget < 1 << 20:
        # The tight budget paged mid-decode.
        assert tf["decode_stats"]["evictions"] > 0


def test_serving_model_phase_tags_and_determinism():
    side = Side("torch")
    a = side.arena("svmod-a", budget=32 << 20)
    b = side.arena("svmod-b", budget=32 << 20)
    try:
        m1 = tserving.ServingModel(a, layers=2, batch=4, max_len=32,
                                   d_model=32)
        m2 = tserving.ServingModel(b, layers=2, batch=4, max_len=32,
                                   d_model=32)
        assert all(k.phase_hint == "kv" and v.phase_hint == "kv"
                   for k, v in m1.kv)
        for t in range(5):
            m1.decode_token(t)
            m2.decode_token(t)
        c1, c2 = m1.checksum(), m2.checksum()
        assert np.isfinite(c1) and c1 == c2
    finally:
        a.close()
        b.close()


def test_gate_wait_samples_and_percentile_match_reference():
    from nvshare_tpu.telemetry import events as jtev
    from nvshare_tpu_torch.telemetry import events as ttev

    rng = np.random.RandomState(3)
    waits = rng.rand(37).round(6).tolist()
    names = {"dec": "decode", "pre": "prefill"}
    for side, tev in (("jax", jtev), ("torch", ttev)):
        ring = [tev.Event(i, 0.0, 0.0, tev.GATE_WAIT,
                          ("dec", "pre", "other")[i % 3], {"seconds": w})
                for i, w in enumerate(waits)]
        ring.append(tev.Event(99, 0.0, 0.0, tev.HANDOFF, "dec",
                              {"seconds": 5.0}))
        m = SERVING[side]
        got = m.gate_wait_samples(names, ring)
        if side == "jax":
            want = got
        assert got == want
        for q in (50, 90, 99):
            assert (tserving.percentile(got["decode"], q)
                    == jserving.percentile(want["decode"], q))
    assert tserving.percentile([], 99) is None


# -- the serving pair under the real scheduler --------------------------------


@pytest.fixture
def phase_sched(tmp_path, native_build, monkeypatch):
    from tests.conftest import SchedulerProc

    monkeypatch.setenv("TPUSHARE_SOCK_DIR", str(tmp_path))
    monkeypatch.setenv("TPUSHARE_REQUIRE_SCHEDULER", "1")
    monkeypatch.setenv("TPUSHARE_PHASE", "1")
    monkeypatch.setenv("TPUSHARE_PAGER_POLICY", "wss")
    s = SchedulerProc(tmp_path, tq_sec=1, extra_env={"TPUSHARE_PHASE": "1"})
    try:
        yield s
    finally:
        s.stop()


def _serving_run(names, first_touch=False):
    from nvshare_tpu_torch.colocate import Tenant, run_colocated
    from nvshare_tpu_torch.telemetry import events as ttev

    works = {"decode": tserving.decode_workload(
                 tokens=300, layers=2, batch=4, max_len=64, d_model=64,
                 think_s=0.01, requests=2),
             "prefill": tserving.prefill_workload(
                 bursts=50, seq=192, steps_per_burst=4, gap_s=0.05)}
    tenants = {role: Tenant(name, budget_bytes=64 << 20, device="cpu",
                            use_pager=True)
               for role, name in names.items()}
    try:
        report = run_colocated({t: works[role]
                                for role, t in tenants.items()},
                               timeout_s=120)
        snaps = {role: t.telemetry_snapshot()
                 for role, t in tenants.items()}
        waits = tserving.gate_wait_samples(
            {t.name: role for role, t in tenants.items()},
            ttev.ring().snapshot())
    finally:
        for t in tenants.values():
            t.close()
    assert report.ok, report.errors
    return {role: report.results[t.name]
            for role, t in tenants.items()}, snaps, waits


def test_serving_pair_under_the_scheduler_equals_solo(phase_sched):
    solo = {role: _serving_run({role: f"solo-{role}"})[0][role]
            for role in ("decode", "prefill")}
    pair, snaps, waits = _serving_run({"decode": "sv-dec",
                                       "prefill": "sv-pre"})
    err = phase_sched.stop()
    assert "DROP_LOCK" in err, f"TQ never expired: {err}"
    for role in ("decode", "prefill"):
        assert pair[role]["checksum"] == solo[role]["checksum"], role
        assert snaps[role]["handoff_evicts"] > 0, snaps
    assert pair["decode"]["tokens"] == 300
    # The decode tenant waited at the gate behind the prefill tenant.
    assert waits["decode"] and tserving.percentile(
        waits["decode"], 99) >= tserving.percentile(waits["decode"], 50)


def test_tenant_set_phase_reaches_scheduler(phase_sched):
    from nvshare_tpu.telemetry.dump import fetch_sched_stats
    from nvshare_tpu_torch.colocate import Tenant

    t = Tenant("svt", budget_bytes=16 << 20, device="cpu")
    try:
        t.set_phase("decode")
        assert t.arena.phase == "decode"
        deadline = time.time() + 5
        while True:
            rows = {r["client"]: r
                    for r in fetch_sched_stats(
                        path=phase_sched.path)["clients"]}
            if rows.get("svt", {}).get("ph") == "dec" or \
                    time.time() > deadline:
                break
            time.sleep(0.05)
        assert rows["svt"]["ph"] == "dec", rows
        t.set_phase(None)
        assert t.arena.phase is None
    finally:
        t.close()
