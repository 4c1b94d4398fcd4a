"""The port's proactive pager replayed against the JAX package's.

Each scenario is one op sequence of ``tests/test_pager.py``, written once
and run through a JAX arena + ``nvshare_tpu.pager.Pager(start=False)`` and
through a port arena (``device="cpu"``) + the port's ``Pager``, with the
daemon ticks, the stream workers, ``on_lock_next``, ``on_horizon`` and
``prefetch_on_grant`` called by hand, so no thread timing enters. Dirty
arrays come from the same seeded numpy values through a donated
``x * 1.0001`` (one f32 multiply, bit-identical in both packages). Both
sides must end with the same paging counters, moved bytes, clean ratios,
prefetch plans and policy orderings, and bit-equal values. The policy
scenarios that read time replace both policy modules' clock with one fake
clock.
"""

import types
import weakref
from statistics import median

import numpy as np
import pytest

import nvshare_tpu.pager as jpager
import nvshare_tpu.pager.policy as jpolicy
import nvshare_tpu.vmem as jvmem
import nvshare_tpu_torch.pager as tpager
import nvshare_tpu_torch.pager.policy as tpolicy
import nvshare_tpu_torch.vmem as tvmem
from nvshare_tpu import telemetry as jtelemetry
from nvshare_tpu.telemetry import events as jtev
from nvshare_tpu_torch import telemetry as ttelemetry
from nvshare_tpu_torch.telemetry import events as ttev

F32 = 4


class Side:
    """One package's arena, pager, policies and telemetry."""

    def __init__(self, name):
        self.name = name
        jax_side = name == "jax"
        self.vm = jvmem if jax_side else tvmem
        self.pager = jpager if jax_side else tpager
        self.policy = jpolicy if jax_side else tpolicy
        self.tev = jtev if jax_side else ttev
        self.telemetry = jtelemetry if jax_side else ttelemetry
        self.kw = {} if jax_side else {"device": "cpu"}

    def arena(self, name, budget=1 << 30):
        return self.vm.VirtualHBM(budget_bytes=budget, name=name, **self.kw)

    def dirty(self, a, values):
        """Device-resident dirty arrays holding ``values`` * 1.0001."""
        step = self.vm.vop(lambda x: x * 1.0001, donate_argnums=(0,))
        return [step(a.array(v)) for v in values]

    def events(self, kind, who):
        return [e.args or {} for e in self.tev.ring().snapshot()
                if e.kind == kind and e.who == who]

    def metric(self, name, a):
        return self.telemetry.registry().snapshot().get(name, {}).get(
            (a.name,))

    def facts(self, a):
        """Counters and byte totals a scenario ends with."""
        return {"stats": dict(a.stats),
                "bytes_out": int(a._m_bytes_out.value),
                "resident_bytes": a.resident_bytes,
                "clean_ratio": a._m_clean_ratio.value,
                "handoffs": [(e["n"], e["clean"], e["moved"])
                             for e in self.events(self.tev.HANDOFF,
                                                  a.name)],
                "writebacks": self.metric("tpushare_writeback_total", a),
                "writeback_bytes": self.metric(
                    "tpushare_writeback_bytes_total", a)}


SIDES = [Side("jax"), Side("torch")]


@pytest.fixture(autouse=True)
def _port_process_arena():
    # The port's gate builds the process client around the process arena,
    # which must be a CPU arena here.
    tvmem.reset_arena()
    tvmem.arena(device="cpu")
    yield
    tvmem.reset_arena()


def values(n, side_len=128, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.rand(side_len, side_len).astype(np.float32)
            for _ in range(n)]


def index_of(vas, out):
    return [next(i for i, v in enumerate(vas) if v is va) for va in out]


def plan_indices(vas, plan):
    return None if plan is None else index_of(vas, [r() for r in plan])


def run_both(scenario, *args):
    """Run ``scenario(side, *args)`` on both sides; returns the two
    (values, facts) results after checking them equal."""
    (jv, jf), (tv, tf) = [scenario(s, *args) for s in SIDES]
    assert tf == jf
    assert tv.keys() == jv.keys()
    for k in jv:
        np.testing.assert_array_equal(tv[k], jv[k], err_msg=k)
    return (jv, jf), (tv, tf)


def drain_streams(pager):
    """The first-touch stream workers' loop, by hand: claim one dirty
    array, drain it, until nothing is left to claim."""
    claims = 0
    while (work := pager._claim_stream_work()) is not None:
        pager._stream_writeback(*work)
        claims += 1
    return claims


# -- whole-array trickle -----------------------------------------------------


def sc_writeback_converges(side, tag):
    a = side.arena(f"{tag}-{side.name}")
    p = side.pager.Pager(a, start=False)
    try:
        vas = side.dirty(a, values(6))
        a.fence()
        ticks = 0
        while any(va._dirty for va in vas):
            p._writeback_tick()
            ticks += 1
            assert ticks < 20
        facts = side.facts(a)
        facts.update(ticks=ticks, resident=[va.resident for va in vas],
                     wb_events=len(side.events(side.tev.WRITEBACK, a.name)))
        page_out = a.stats["page_out"]
        a.sync_and_evict_all()
        facts.update(after=side.facts(a),
                     rewrote=a.stats["page_out"] - page_out,
                     back=[va.resident for va in vas])
        return {f"v{i}": va.numpy() for i, va in enumerate(vas)}, facts
    finally:
        p.close()
        a.close()


def test_trickle_converges_then_handoff_is_pure_delete():
    _, (_, f) = run_both(sc_writeback_converges, "wb")
    # What tests/test_pager.py asserts of the reference, held here too.
    assert f["resident"] == [True] * 6 and f["wb_events"] >= 1
    assert f["writeback_bytes"] >= 6 * 128 * 128 * F32
    assert f["rewrote"] == 0 and f["after"]["clean_ratio"] == 1.0
    assert f["after"]["handoffs"][-1] == (6, 6, 0)


def sc_sync_handoff(side, tag):
    a = side.arena(f"{tag}-{side.name}")
    try:
        vas = side.dirty(a, values(4, 64))
        a.fence()
        a.sync_and_evict_all()
        return {f"v{i}": va.numpy() for i, va in enumerate(vas)}, \
            side.facts(a)
    finally:
        a.close()


def test_sync_handoff_reports_dirty_ratio():
    _, (_, f) = run_both(sc_sync_handoff, "sync")
    assert f["clean_ratio"] == 0.0
    assert f["handoffs"] == [(4, 0, 4 * 64 * 64 * F32)]


# -- plans: on deck, grant, generations, horizon ------------------------------


def sc_budgeted_prefetch(side, tag, mode):
    a = side.arena(f"{tag}-{side.name}")
    p = side.pager.Pager(a, start=False)
    try:
        vas = side.dirty(a, values(8))
        a.fence()
        a.sync_and_evict_all()
        facts = {"evicted": a.resident_bytes}
        if mode == "advisory":
            p.on_lock_next(remain_ms=500)
            facts["plan"] = plan_indices(vas, p._plan)
        p.prefetch_on_grant()
        facts.update(bg=plan_indices(vas, p._bg_plan),
                     sync=[va.resident for va in vas])
        ticks = 0
        while p._bg_plan:
            p._bg_prefetch_tick()
            ticks += 1
        facts.update(ticks=ticks, resident=[va.resident for va in vas],
                     prefetch_events=[
                         (e["n"], e["bytes"]) for e in side.events(
                             side.tev.PREFETCH, a.name)],
                     **side.facts(a))
        return {f"v{i}": va.numpy() for i, va in enumerate(vas)}, facts
    finally:
        p.close()
        a.close()


@pytest.mark.parametrize("budget_arrays,chunk", [(3, None), (8, 1),
                                                 (None, None)],
                         ids=["budget-3", "chunk-1B", "defaults"])
@pytest.mark.parametrize("mode", ["advisory", "grant-only"])
def test_prefetch_plans_match(monkeypatch, budget_arrays, chunk, mode):
    nbytes = 128 * 128 * F32
    if budget_arrays is not None:
        monkeypatch.setenv("TPUSHARE_PREFETCH_BUDGET_BYTES",
                           str(budget_arrays * nbytes))
    if chunk is not None:
        monkeypatch.setenv("TPUSHARE_PREFETCH_CHUNK_BYTES", str(chunk))
    _, (_, f) = run_both(sc_budgeted_prefetch, "plan", mode)
    want = 8 if budget_arrays is None else budget_arrays
    assert sum(f["resident"]) == want  # a hard cap, as the reference's
    assert f["resident_bytes"] <= want * nbytes


def sc_stale_generation(side, tag):
    a = side.arena(f"{tag}-{side.name}")
    p = side.pager.Pager(a, start=False)
    try:
        vas = side.dirty(a, values(6))
        a.fence()
        a.sync_and_evict_all()
        p.on_lock_next(remain_ms=500)
        p.prefetch_on_grant()
        facts = {"after_grant": a.resident_bytes, "bg": len(p._bg_plan)}
        stale_gen, stale_plan = p._bg_gen, list(p._bg_plan)
        p.sync_and_evict()
        facts.update(after_drop=a.resident_bytes, gen=p._gen - stale_gen)
        p._bg_plan, p._bg_gen = stale_plan, stale_gen
        p._bg_prefetch_tick()
        facts.update(after_stale=a.resident_bytes, bg_left=p._bg_plan)
        p._bg_plan = [weakref.ref(va) for va in vas[1:]]
        p._bg_gen = p._gen
        p._bg_prefetch_tick()
        facts.update(after_fresh=a.resident_bytes, **side.facts(a))
        return {f"v{i}": va.numpy() for i, va in enumerate(vas)}, facts
    finally:
        p.close()
        a.close()


def test_drop_invalidates_background_plan_generation(monkeypatch):
    monkeypatch.setenv("TPUSHARE_PREFETCH_CHUNK_BYTES", "1")
    _, (_, f) = run_both(sc_stale_generation, "gen")
    nbytes = 128 * 128 * F32
    assert f["after_grant"] == nbytes and f["bg"] == 5
    assert f["after_drop"] == 0 and f["gen"] == 1
    assert f["after_stale"] == 0 and f["bg_left"] == []
    assert f["after_fresh"] > 0


def sc_horizon(side, tag):
    a = side.arena(f"{tag}-{side.name}")
    p = side.pager.Pager(a, start=False)
    try:
        vas = side.dirty(a, values(8, 64))
        a.fence()
        a.sync_and_evict_all()
        plans = []
        for depth, total, eta in ((2, 2, 1500), (1, 2, 200), (3, 3, 900)):
            p.on_horizon(depth, total, eta_ms=eta)
            plans.append(plan_indices(vas, p._plan))
        p.on_horizon(0, 0)
        plans.append(plan_indices(vas, p._plan))
        facts = {"plans": plans,
                 "staged": side.metric("tpushare_horizon_staged_total", a),
                 "staged_bytes": side.metric(
                     "tpushare_horizon_staged_bytes_total", a)}
        return {}, facts
    finally:
        p.close()
        a.close()


def test_horizon_staging_is_depth_proportional(monkeypatch):
    nbytes = 64 * 64 * F32
    monkeypatch.setenv("TPUSHARE_PAGER_FIRST_TOUCH", "1")
    monkeypatch.setenv("TPUSHARE_PAGER_CHUNK_BYTES", str(64 << 10))
    monkeypatch.setenv("TPUSHARE_PREFETCH_BUDGET_BYTES", str(4 * nbytes))
    monkeypatch.setenv("TPUSHARE_PREFETCH_CHUNK_BYTES", str(nbytes))
    _, (_, f) = run_both(sc_horizon, "hz")
    assert [len(p) for p in f["plans"][:3]] == [2, 4, 1]
    assert f["plans"][3] is None and f["staged"] == 3


# -- policies ----------------------------------------------------------------


class FakeClock:
    """One monotonic clock for both packages' policy modules."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    fake = types.SimpleNamespace(monotonic=c.monotonic)
    monkeypatch.setattr(jpolicy, "time", fake)
    monkeypatch.setattr(tpolicy, "time", fake)
    return c


def test_policy_factory_and_fallback():
    for side in SIDES:
        m = side.policy
        assert type(m.make_policy("lru")).__name__ == "LRUPolicy"
        assert isinstance(m.make_policy("lfu"), m.LFUPolicy)
        assert isinstance(m.make_policy("wss"), m.WSSPolicy)
        assert isinstance(m.make_policy("banana"), m.LRUPolicy)
        assert isinstance(m.make_policy(""), m.LRUPolicy)
    assert tpolicy.POLICIES == jpolicy.POLICIES


# A touch pattern over six arrays: (array, gap in seconds before it).
TOUCHES = [(0, 0.0), (1, 0.01), (2, 0.01), (0, 0.5), (3, 0.01), (0, 0.01),
           (4, 0.3), (1, 0.01), (5, 0.01), (0, 0.2), (2, 0.01), (0, 0.01),
           (3, 0.4), (0, 0.01)]


def sc_policy(side, tag, name, clock):
    a = side.arena(f"{tag}-{side.name}")
    try:
        pol = side.policy.make_policy(name, f"{tag}-nobody")
        vas = [a.array(v) for v in values(6, 8)]
        clock.now = 1000.0
        for i, gap in TOUCHES:
            clock.now += gap
            a._touch(vas[i])   # the arena's recency clock ...
            pol.on_touch(vas[i])  # ... and the policy's hook
        facts = {"writeback": index_of(vas, pol.writeback_order(vas)),
                 "prefetch": index_of(vas, pol.prefetch_order(vas)),
                 "kv": [pol.kv_resident(va) for va in vas]}
        if name == "wss":
            facts.update(
                predicted=sorted(index_of(vas, [
                    va for va in vas if id(va) in pol.predicted_ids()])),
                itt=[round(pol.inter_touch_ewma_s(va), 9) for va in vas],
                wss=pol.observed_wss_bytes(),
                kv_bytes=pol.kv_resident_bytes())
        return {}, facts
    finally:
        a.close()


@pytest.mark.parametrize("name", ["lru", "lfu", "wss"])
def test_policy_orderings_match(monkeypatch, clock, name):
    monkeypatch.setenv("TPUSHARE_WSS_WINDOW_S", "0.35")
    monkeypatch.setenv("TPUSHARE_WSS_KV_TOUCHES", "4")
    _, (_, f) = run_both(sc_policy, f"pol-{name}", name, clock)
    if name == "lfu":
        # Array 0 is the most touched: prefetched first, written back last.
        assert f["prefetch"][0] == 0 and f["writeback"][-1] == 0
    if name == "wss":
        # Array 0 is re-touched steadily across windows: KV-class, first
        # in the prefetch order; the others were touched in bursts.
        assert f["kv"] == [True] + [False] * 5
        assert f["prefetch"][0] == 0


def test_writeback_rate_limiter_backs_off_on_step_latency_rise(monkeypatch):
    monkeypatch.setenv("TPUSHARE_PAGER_FIRST_TOUCH", "1")
    factors = {}
    for side in SIDES:
        a = side.arena(f"rate-{side.name}")
        p = side.pager.Pager(a, start=False)
        try:
            seq = []
            for s in [0.01] * 8 + [0.5] * 8 + [0.01] * 64:
                p.note_step_latency(s)
                seq.append(p.writeback_rate_factor)
            factors[side.name] = seq
        finally:
            p.close()
            a.close()
    assert factors["torch"] == factors["jax"]
    seq = factors["torch"]
    assert seq[7] == 1.0 and seq[15] <= 0.25 and seq[-1] == 1.0


# -- first-touch paging -------------------------------------------------------


@pytest.fixture
def first_touch(monkeypatch):
    monkeypatch.setenv("TPUSHARE_PAGER_FIRST_TOUCH", "1")
    monkeypatch.setenv("TPUSHARE_PAGER_CHUNK_BYTES", str(64 << 10))


def sc_fault_only(side, tag):
    a = side.arena(f"{tag}-{side.name}")
    p = side.pager.Pager(a, start=False)
    try:
        vas = side.dirty(a, values(4, 64))
        a.fence()
        a.sync_and_evict_all()
        p.on_lock_next(remain_ms=100)
        p.prefetch_on_grant()
        facts = {"first_touch": (a.first_touch, p.first_touch),
                 "after_grant": a.resident_bytes,
                 "bg": plan_indices(vas, p._bg_plan)}
        faults = a.stats["page_in"]
        with vas[0].pinned():
            pass
        facts.update(faulted=a.stats["page_in"] - faults,
                     resident=[va.resident for va in vas])
        p._bg_prefetch_tick()
        facts.update(after_tick=[va.resident for va in vas],
                     **side.facts(a))
        return {f"v{i}": va.numpy() for i, va in enumerate(vas)}, facts
    finally:
        p.close()
        a.close()


def test_first_touch_fault_only_page_in(first_touch):
    _, (_, f) = run_both(sc_fault_only, "ftf")
    assert f["first_touch"] == (True, True)
    assert f["after_grant"] == 0 and f["faulted"] == 1
    assert f["resident"] == [True, False, False, False]


def _copy_chunk(side, a, va, lo, hi):
    host_flat = a._host_flat_writable(va)
    if side.name == "jax":
        host_flat[lo:hi] = np.asarray(va._dev).reshape(-1)[lo:hi]
    else:
        host_flat[lo:hi].copy_(va._dev.reshape(-1)[lo:hi])


def sc_residual(side, tag):
    a = side.arena(f"{tag}-{side.name}")
    try:
        [va] = side.dirty(a, values(1, 256))  # 4 chunks of 64 KiB
        a.fence()
        with a._lock:
            chunks = sorted(va._dirty_chunks)
            # The streams drained every chunk but the first.
            for c in chunks[1:]:
                _copy_chunk(side, a, va, *a._chunk_bounds(va, c))
                va._dirty_chunks.discard(c)
        before = int(a._m_bytes_out.value)
        a.sync_and_evict_all()
        facts = {"chunks": chunks,
                 "moved": int(a._m_bytes_out.value) - before,
                 "resident": va.resident, **side.facts(a)}
        return {"v": va.numpy()}, facts
    finally:
        a.close()


def test_first_touch_handoff_moves_what_the_reference_moves(first_touch):
    """The sequence of the reference's
    ``test_first_touch_handoff_moves_only_residual_dirty_chunks``, which
    FAILS on the reference: its handoff moves the whole array (262144 B),
    not the one residual 64 KiB chunk that test expects. The JAX arena
    takes its chunk-residual branch only on a platform without a
    pinned-host memory space, and the CPU platform has one (as a TPU
    does). The port is held to what the reference does: a still-dirty
    array leaves whole, into the shadow the streams began. The residual
    chunk-only handoff is an open gap in both packages (ROADMAP
    Queue 3)."""
    _, (_, f) = run_both(sc_residual, "ftr")
    assert f["chunks"] == [0, 1, 2, 3]
    assert f["moved"] == 256 * 256 * F32
    assert not f["resident"]


def sc_streams(side, tag):
    a = side.arena(f"{tag}-{side.name}")
    p = side.pager.Pager(a, start=False)
    try:
        vas = side.dirty(a, values(6))
        a.fence()
        facts = {"chunks": [sorted(va._dirty_chunks) for va in vas]}
        facts["claims"] = drain_streams(p)
        facts.update(dirty=[va._dirty for va in vas], **side.facts(a))
        before = int(a._m_bytes_out.value)
        a.sync_and_evict_all()
        facts.update(handoff_moved=int(a._m_bytes_out.value) - before,
                     after=side.facts(a),
                     wb=[(e.get("n"), e.get("bytes"), e.get("ft"))
                         for e in side.events(side.tev.WRITEBACK, a.name)])
        return {f"v{i}": va.numpy() for i, va in enumerate(vas)}, facts
    finally:
        p.close()
        a.close()


def test_first_touch_streams_converge_then_handoff_is_free(first_touch):
    _, (_, f) = run_both(sc_streams, "fts")
    assert f["claims"] == 6 and f["dirty"] == [False] * 6
    assert f["writeback_bytes"] == 6 * 128 * 128 * F32
    assert f["handoff_moved"] == 0


def sc_partial_stream(side, tag):
    """A handoff lands while one array is half drained: it moves whole
    (into the shadow the stream began), as the untouched ones do."""
    a = side.arena(f"{tag}-{side.name}")
    p = side.pager.Pager(a, start=False)
    try:
        vas = side.dirty(a, values(3, 256))
        a.fence()
        va, dev, chunks = p._claim_stream_work()
        p._stream_writeback(va, dev, chunks[:2])
        facts = {"first": index_of(vas, [va]),
                 "left": sorted(va._dirty_chunks)}
        a.sync_and_evict_all()
        facts.update(**side.facts(a))
        return {f"v{i}": va.numpy() for i, va in enumerate(vas)}, facts
    finally:
        p.close()
        a.close()


def test_first_touch_partial_drain_at_handoff(first_touch):
    _, (_, f) = run_both(sc_partial_stream, "ftp")
    assert f["left"] == [2, 3]
    assert f["handoffs"][-1] == (3, 0, 3 * 256 * 256 * F32)


def test_first_touch_off_keeps_chunking_dormant(monkeypatch):
    monkeypatch.delenv("TPUSHARE_PAGER_FIRST_TOUCH", raising=False)
    for side in SIDES:
        a = side.arena(f"noft-{side.name}", budget=1 << 28)
        p = side.pager.Pager(a, start=False)
        try:
            assert not a.first_touch and not p.first_touch
            assert p._stream_threads == []
            [va] = side.dirty(a, values(1, 64))
            a.fence()
            assert va._dirty and va._dirty_chunks is None
            cbs = side.pager.client_callbacks(a, p)
            assert "on_horizon" not in cbs and "on_deck" in cbs
        finally:
            p.close()
            a.close()


def test_pager_disabled_keeps_the_synchronous_path(monkeypatch, tmp_path):
    monkeypatch.delenv("TPUSHARE_PAGER", raising=False)
    monkeypatch.setenv("TPUSHARE_SOCK_DIR", str(tmp_path))
    from nvshare_tpu_torch.colocate import Tenant

    assert not tpager.pager_enabled()
    a = Side("torch").arena("no-pager", budget=1 << 28)
    try:
        assert tpager.maybe_attach_pager(a) is None and a.pager is None
        cbs = tpager.client_callbacks(a)
        assert cbs["sync_and_evict"] == a.sync_and_evict_all
        assert "on_deck" not in cbs
    finally:
        a.close()
    t = Tenant("no-pager-tenant", budget_bytes=1 << 28, device="cpu")
    try:
        assert t.pager is None
    finally:
        t.close()
    monkeypatch.setenv("TPUSHARE_PAGER", "1")
    t = Tenant("env-pager-tenant", budget_bytes=1 << 28, device="cpu")
    try:
        assert t.pager is not None and t.arena.pager is t.pager
        assert t.client._on_deck == t.pager.on_lock_next
    finally:
        t.close()
    assert t.arena.pager is None  # closing the arena stopped the pager


def test_pager_thread_error_fails_the_tenant():
    """A device error in a pager thread stops the pager and surfaces in
    the tenant's next op; nothing carries on on the synchronous path."""
    side = Side("torch")
    a = side.arena("pager-error")
    p = tpager.Pager(a, start=False)
    try:
        [va] = side.dirty(a, values(1, 64))
        p._fail(RuntimeError("CUDA error: an illegal memory access"))
        assert p._stop.is_set()
        with pytest.raises(RuntimeError, match="pager of pager-error") as e:
            side.dirty(a, values(1, 64))
        assert "illegal memory access" in str(e.value.__cause__)
        with pytest.raises(RuntimeError):
            va.numpy()
    finally:
        p.close()
        a.close()


# -- two tenants against the real scheduler ----------------------------------


def _handoff_workload(vm, chunks, side_len, steps, step_sleep_s):
    """Every chunk goes dirty once, then one chunk a step is re-dirtied
    (tests/test_pager.py's stepper)."""
    import time

    def work(tenant):
        step = vm.vop(lambda x: x * 1.0001, donate_argnums=(0,))
        xs = [tenant.arena.array(
            np.full((side_len, side_len), i + 1.0, np.float32))
            for i in range(chunks)]
        xs = [step(x) for x in xs]
        for i in range(steps):
            xs[i % chunks] = step(xs[i % chunks])
            tenant.client.mark_activity()
            time.sleep(step_sleep_s)
        return [float(x.numpy().astype(np.float64).sum()) for x in xs]

    return work


def test_two_tenant_proactive_beats_sync_handoff(tmp_path, native_build,
                                                 monkeypatch):
    """The port's pair under TQ = 1 s, synchronous leg then proactive leg
    (the reference's acceptance run): every result equals the same
    workload run by the JAX package, the proactive leg hands off partly
    clean, and its median handoff is shorter."""
    from tests.conftest import SchedulerProc
    from nvshare_tpu_torch.colocate import Tenant, run_colocated

    chunks, side_len, steps, sleep_s = 8, 1408, 70, 0.03  # ~60 MiB WSS
    monkeypatch.setenv("TPUSHARE_SOCK_DIR", str(tmp_path))
    monkeypatch.setenv("TPUSHARE_RELEASE_CHECK_S", "30")
    # The same stepper run alone by the JAX package, unmanaged.
    ja = jvmem.VirtualHBM(budget_bytes=1 << 30, name="ab-ref")
    try:
        want = _handoff_workload(jvmem, chunks, side_len, steps, 0.0)(
            types.SimpleNamespace(
                arena=ja, client=types.SimpleNamespace(
                    mark_activity=lambda: None)))
    finally:
        ja.close()
    sched = SchedulerProc(tmp_path, tq_sec=1)
    try:
        def run_leg(tag, use_pager):
            tenants = [Tenant(f"{tag}{i}", budget_bytes=1 << 30,
                              device="cpu", use_pager=use_pager)
                       for i in (1, 2)]
            try:
                report = run_colocated({
                    t: _handoff_workload(tvmem, chunks, side_len, steps,
                                         sleep_s)
                    for t in tenants}, timeout_s=300)
                assert report.ok, report.errors
                names = [t.name for t in tenants]
                evs = [e.args for e in ttev.ring().snapshot()
                       if e.kind == ttev.HANDOFF and e.who in names
                       and e.args and e.args.get("n", 0) > 0]
                return (report.results, [e["seconds"] for e in evs],
                        [e.get("clean", 0) / e["n"] for e in evs])
            finally:
                for t in tenants:
                    t.close()

        attempts = []
        for attempt in range(2):
            res_sync, h_sync, _ = run_leg(f"tsync{attempt}-", False)
            res_pro, h_pro, c_pro = run_leg(f"tpro{attempt}-", True)
            assert len(h_sync) >= 2 and len(h_pro) >= 2, (h_sync, h_pro)
            assert max(c_pro) > 0.0, c_pro
            for res in (res_sync, res_pro):
                assert all(r == want for r in res.values()), (res, want)
            attempts.append((median(h_pro), median(h_sync)))
            if attempts[-1][0] < attempts[-1][1]:
                break
        assert attempts[-1][0] < attempts[-1][1], attempts
    finally:
        sched.stop()


def test_background_prefetch_races_donation_without_error(monkeypatch):
    """Stress: the daemon's background prefetch pages planned arrays in
    while the tenant's thread donates (discards) the same arrays. The
    page-in must take the arena lock before it looks at an array, or it
    faults in one whose shadow the donation just released. Bounded in
    time, with a short switch interval to interleave the threads."""
    import sys
    import time

    monkeypatch.setenv("TPUSHARE_PREFETCH_CHUNK_BYTES", "1")
    monkeypatch.setenv("TPUSHARE_WRITEBACK_INTERVAL_S", "0.001")
    side = Side("torch")
    a = side.arena("bg-race", budget=1 << 30)
    p = tpager.Pager(a)  # unmanaged: the daemon always runs
    step = tvmem.vop(lambda x: x * 1.0001, donate_argnums=(0,))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        deadline = time.time() + 5
        rounds = 0
        while time.time() < deadline and rounds < 60:
            xs = side.dirty(a, values(16, 32, seed=rounds))
            a.fence()
            a.sync_and_evict_all()
            p.on_lock_next()
            p.prefetch_on_grant()
            xs = [step(x) for x in xs]  # races the daemon's page-ins
            assert p.error is None, p.error
            rounds += 1
        assert rounds >= 10
    finally:
        sys.setswitchinterval(interval)
        p.close()
        a.close()


def test_process_client_attaches_the_pager(monkeypatch, tmp_path):
    """$TPUSHARE_PAGER=1 wires the process arena's pager into the process
    client, as nvshare_tpu.interpose.client() does. The process client is
    the native one by default; this test pins the Python client, whose
    callbacks it can read (the native runtime is process-wide state), as
    the JAX package's in-process tests do."""
    from nvshare_tpu_torch import interpose

    monkeypatch.setenv("TPUSHARE_PURE_PYTHON", "1")
    monkeypatch.setenv("TPUSHARE_PAGER", "1")
    monkeypatch.setenv("TPUSHARE_SOCK_DIR", str(tmp_path))  # no scheduler
    monkeypatch.setattr(interpose, "_client", None)
    a = tvmem.arena()
    c = interpose.client()
    try:
        assert a.pager is not None and a.pager._client is c
        assert c._on_deck == a.pager.on_lock_next
        assert c._sync_and_evict == a.pager.sync_and_evict
    finally:
        c.shutdown()
        a.pager.close()
