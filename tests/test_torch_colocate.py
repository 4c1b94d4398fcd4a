"""Two port tenants in one process under the real scheduler.

The in-process co-location of ``nvshare_tpu_torch.colocate`` on the CPU:
two burner tenants share one physical pool smaller than their combined
working sets, and ``tpushare-scheduler`` (TQ = 1 s) serializes them. The
scheduler's own protocol log shows both tenants granted and quanta
expiring, the arenas show whole-set handoffs, and each tenant's result is
bit-identical to the same burner run solo: paging must not change a bit.
"""

import re

import pytest

from nvshare_tpu_torch import vmem
from nvshare_tpu_torch.colocate import Tenant, burner_workload, run_colocated

MB = 1 << 20
WSS = 64 * MB       # 4 chunks of 2048x2048 f32 per tenant
CHUNKS = 4
STEPS = 500         # a few seconds per tenant: several 1 s quanta


@pytest.fixture
def sched_env(tmp_path, native_build, monkeypatch):
    from tests.conftest import SchedulerProc

    monkeypatch.setenv("TPUSHARE_SOCK_DIR", str(tmp_path))
    monkeypatch.setenv("TPUSHARE_REQUIRE_SCHEDULER", "1")
    monkeypatch.setenv("TPUSHARE_RESERVE_BYTES", "0")
    s = SchedulerProc(tmp_path, tq_sec=1)
    try:
        yield s
    finally:
        s.stop()


def _run(names, pool_bytes):
    pool = vmem.PhysicalPool(pool_bytes)
    tenants = [Tenant(n, budget_bytes=WSS * 2, device="cpu", pool=pool)
               for n in names]
    try:
        report = run_colocated(
            {t: burner_workload("mix", WSS, STEPS, chunks=CHUNKS,
                                device_ratio=1.0)
             for t in tenants}, timeout_s=120)
        snaps = {t.name: t.telemetry_snapshot() for t in tenants}
        drops = {t.name: int(t.client._m["drops"].value) for t in tenants}
    finally:
        for t in tenants:
            t.close()
    assert report.ok, report.errors
    return report, snaps, drops


def test_two_port_tenants_serialize_and_page(sched_env):
    solo, _, _ = _run(["torch-solo"], WSS * 2)
    pair, snaps, drops = _run(["torch-t1", "torch-t2"], WSS * 3 // 2)
    err = sched_env.stop()

    granted = set(re.findall(r"LOCK_OK -> \S+ \(id ([0-9a-f]+)\)", err))
    assert len(granted) >= 2, f"both tenants must be granted: {err}"
    assert "DROP_LOCK" in err, f"TQ never expired: {err}"
    assert sum(drops.values()) >= 1
    want = solo.results["torch-solo"].checksum
    for name in ("torch-t1", "torch-t2"):
        res = pair.results[name]
        assert res.passed and res.steps == STEPS
        assert res.checksum == want, (name, res.checksum, want)
        assert snaps[name]["handoff_evicts"] > 0, snaps
        assert snaps[name]["prefetches"] > 0, snaps


def test_tenant_refuses_unported_options(tmp_path, monkeypatch):
    """QoS and the fleet streamer are still refused; the proactive pager,
    ported since, attaches."""
    monkeypatch.setenv("TPUSHARE_SOCK_DIR", str(tmp_path))
    t = Tenant("torch-pager", device="cpu", use_pager=True)
    try:
        assert t.pager is not None and t.arena.pager is t.pager
    finally:
        t.close()
    with pytest.raises(NotImplementedError):
        Tenant("torch-qos", device="cpu", qos="interactive:2")
    monkeypatch.setenv("TPUSHARE_FLEET", "1")
    with pytest.raises(NotImplementedError):
        Tenant("torch-fleet", device="cpu")


def _train_run(names, budget):
    from nvshare_tpu_torch.colocate import lm_train_workload
    from nvshare_tpu_torch.models.transformer import Transformer

    # Dozens of steps a tenant: several 1 s quanta on the CPU.
    model = Transformer(vocab=64, dim=128, heads=4, depth=2, seq=128,
                        rope=True, remat=True)
    pool = vmem.PhysicalPool(budget)
    tenants = [Tenant(n, budget_bytes=budget, device="cpu", pool=pool)
               for n in names]
    try:
        report = run_colocated(
            {t: lm_train_workload(model, steps=60, batch=4, lr=1e-2,
                                  seed=3) for t in tenants}, timeout_s=180)
        snaps = {t.name: t.telemetry_snapshot() for t in tenants}
        drops = {t.name: int(t.client._m["drops"].value) for t in tenants}
    finally:
        for t in tenants:
            t.close()
    assert report.ok, report.errors
    return report, snaps, drops


def test_training_pair_under_the_scheduler_equals_solo(sched_env):
    """Two training tenants (remat, flash forward and backward, state
    donated and updated in place) under the real scheduler: every loss
    and the final f64 checksum of parameters and momentum equal the solo
    run's bit for bit, and both tenants hand their state off."""
    solo, _, _ = _train_run(["train-solo"], 8 * MB)
    pair, snaps, drops = _train_run(["train-t1", "train-t2"], 8 * MB)
    err = sched_env.stop()
    want = solo.results["train-solo"]
    assert want.passed and len(want.losses) == 60
    assert want.losses[-1] < want.losses[0] - 0.5, want.losses
    assert "DROP_LOCK" in err, f"TQ never expired: {err}"
    assert sum(drops.values()) >= 1
    for name in ("train-t1", "train-t2"):
        assert f"LOCK_OK -> {name} " in err, err
        got = pair.results[name]
        assert got.losses == want.losses, name
        assert got.checksum == want.checksum, name
        assert snaps[name]["handoff_evicts"] > 0, snaps
        assert snaps[name]["prefetches"] > 0, snaps
