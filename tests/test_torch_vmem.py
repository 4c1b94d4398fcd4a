"""The port's virtual device memory replayed against the JAX package's.

Each scenario is an op sequence of ``tests/test_vmem.py``, written once
with operators both array types share, and run against a JAX arena and a
port arena (``device="cpu"``) with the same budget and the same seeded
numpy inputs. Both must end with the same paging counters and the same
values: the port keeps the reference's residency decisions, not just its
results.
"""

import numpy as np
import pytest
import torch

import nvshare_tpu.vmem as jvmem
import nvshare_tpu_torch.vmem as tvmem

MB = 1 << 20
N = 512  # 1 MiB f32 arrays against a 4 MiB budget: the reference's ratios


def big(seed, n=N):
    return np.random.RandomState(seed).rand(n, n).astype(np.float32)


def singleton(vm):
    vm.reset_arena()
    return vm.arena(device="cpu") if vm is tvmem else vm.arena()


def new_arena(vm, **kw):
    if vm is tvmem:
        kw["device"] = "cpu"
    return vm.VirtualHBM(**kw)


@pytest.fixture(autouse=True)
def _budget(monkeypatch):
    monkeypatch.setenv("TPUSHARE_HBM_BYTES", str(4 * MB))
    monkeypatch.setenv("TPUSHARE_RESERVE_BYTES", "0")
    yield
    jvmem.reset_arena()
    tvmem.reset_arena()


# Each scenario: (vm) -> (values: dict name -> ndarray, facts: dict).


def sc_starts_host_resident(vm):
    a = singleton(vm)
    x = a.array(big(0))
    return {}, {"resident": x.resident, "rb": a.resident_bytes,
                "tb": a.tracked_bytes, "stats": dict(a.stats)}


def sc_vop_pages_in_and_computes(vm):
    a = singleton(vm)
    x = a.array(big(1))
    y = vm.vop(lambda v: v @ v)(x)
    return {"y": y.numpy()}, {"x_res": x.resident, "y_res": y.resident,
                              "stats": dict(a.stats)}


def sc_lru_eviction_and_reload(vm):
    a = singleton(vm)
    arrays = {i: a.array(big(i)) for i in range(6)}  # 6 MiB > 4 MiB
    touch = vm.vop(lambda v: v + 1.0)
    results = {i: touch(va) for i, va in arrays.items()}
    facts = {"stats_before_read": dict(a.stats),
             "within_budget": a.resident_bytes <= a.budget}
    vals = {f"r{i}": results[i].numpy() for i in range(6)}
    facts["stats"] = dict(a.stats)
    return vals, facts


def sc_dirty_eviction_writes_back(vm):
    a = singleton(vm)
    x = a.array(big(2))
    y = vm.vop(lambda v: v * 3.0)(x)
    flood = [vm.vop(lambda v: v + 0.0)(a.array(big(10 + k)))
             for k in range(5)]
    del flood
    return {"y": y.numpy()}, {"stats": dict(a.stats)}


def sc_mem_info(vm):
    a = singleton(vm)
    free0, total = a.mem_info()
    x = a.array(big(3))
    _ = vm.vop(lambda v: v @ v)(x)
    free1, _ = a.mem_info()
    return {}, {"free0": free0, "total": total, "free1": free1}


def sc_handoff_evict_and_prefetch(vm):
    a = singleton(vm)
    x = a.array(big(6))
    y = vm.vop(lambda v: v - 2.0)(x)
    before = a.resident_bytes
    a.sync_and_evict_all()
    after_evict = (a.resident_bytes, x.resident, y.resident)
    a.prefetch_hot()
    return {"y": y.numpy()}, {"before": before, "after_evict": after_evict,
                              "back": (x.resident, y.resident),
                              "stats": dict(a.stats)}


def sc_delete_frees_accounting(vm):
    a = singleton(vm)
    x = a.array(big(7))
    before = a.tracked_bytes
    x.delete()
    return {}, {"freed": before - a.tracked_bytes}


def sc_pinned_context_blocks_lru_eviction(vm):
    a = singleton(vm)
    x = a.array(big(20))
    with x.pinned() as dev:
        flood = [a.array(big(30 + k)) for k in range(4)]
        a.ensure(flood)
        survived = x.resident
        total = float(dev.sum())
    return {"sum": np.float64(total)}, {"survived": survived,
                                        "pin": x._pin,
                                        "stats": dict(a.stats)}


def sc_adaptive_window_grows_when_fast(vm):
    a = singleton(vm)
    f = vm.vop(lambda v: v + 1.0)
    x = a.array(big(8))
    for _ in range(8):
        x = f(x)
    # Both windows grow from 1 on fast fences (their exact size depends on
    # fence times, which a loaded machine can stretch past 1 s).
    return {"x": x.numpy()}, {"grew": a._window > 1}


def sc_pool_detach_on_close(vm):
    pool = vm.PhysicalPool(capacity_bytes=4 * MB)
    a1 = new_arena(vm, budget_bytes=4 * MB, pool=pool)
    a2 = new_arena(vm, budget_bytes=4 * MB, pool=pool)
    x1 = a1.array(big(0))
    a1.ensure([x1])
    x2 = a2.array(big(1))
    a2.ensure([x2])
    both = pool.resident_bytes()
    a1.close()
    facts = {"both": both, "arenas": len(pool.arenas),
             "after": pool.resident_bytes(), "x1": x1.resident,
             "a1": (a1.resident_bytes, a1.tracked_bytes)}
    a1.close()  # idempotent
    more = [a2.array(big(10 + k)) for k in range(3)]
    a2.ensure(more)
    facts["full"] = pool.resident_bytes()
    facts["stats"] = dict(a2.stats)
    return {}, facts


def sc_pool_cross_tenant_eviction(vm):
    pool = vm.PhysicalPool(capacity_bytes=3 * MB)
    a1 = new_arena(vm, budget_bytes=4 * MB, pool=pool)
    a2 = new_arena(vm, budget_bytes=4 * MB, pool=pool)
    xs = [a1.array(big(40 + k)) for k in range(2)]
    a1.ensure(xs)
    ys = [a2.array(big(50 + k)) for k in range(2)]
    a2.ensure(ys)  # 4 MiB > 3 MiB pool: evicts a1's coldest array
    return {"x0": xs[0].numpy()}, {
        "res": [x.resident for x in xs + ys],
        "s1": dict(a1.stats), "s2": dict(a2.stats)}


SCENARIOS = [sc_starts_host_resident, sc_vop_pages_in_and_computes,
             sc_lru_eviction_and_reload, sc_dirty_eviction_writes_back,
             sc_mem_info, sc_handoff_evict_and_prefetch,
             sc_delete_frees_accounting,
             sc_pinned_context_blocks_lru_eviction,
             sc_adaptive_window_grows_when_fast, sc_pool_detach_on_close,
             sc_pool_cross_tenant_eviction]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[3:] for s in SCENARIOS])
def test_port_arena_replays_reference(scenario):
    jvals, jfacts = scenario(jvmem)
    tvals, tfacts = scenario(tvmem)
    assert tfacts == jfacts
    assert tvals.keys() == jvals.keys()
    for k in jvals:
        # Elementwise ops agree exactly; v @ v sums 512 f32 products in
        # another order (XLA vs ATen), a few ulps of a ~128 result.
        np.testing.assert_allclose(tvals[k], jvals[k], rtol=1e-5, atol=0,
                                   err_msg=k)


def test_handoff_counts_match_reference_values():
    """The replay above compares the packages with each other; this pins
    the values test_vmem.py asserts for the reference."""
    _, f = sc_handoff_evict_and_prefetch(tvmem)
    assert f["after_evict"] == (0, False, False)
    assert f["back"] == (True, True)
    assert f["stats"]["handoff_evicts"] == 2
    assert f["stats"]["prefetches"] == 2


def test_strict_single_oversub_refuses_in_both(monkeypatch):
    monkeypatch.setenv("TPUSHARE_HBM_BYTES", str(2 * MB))
    monkeypatch.setenv("TPUSHARE_ENABLE_SINGLE_OVERSUB", "0")
    for vm, err in ((jvmem, jvmem.TpuShareOOM), (tvmem, tvmem.TpuShareOOM)):
        a = singleton(vm)
        a.array(big(4))                       # 1 MiB fits
        with pytest.raises(err):
            a.array(big(5, n=750))            # ~2.1 MiB pushes past 2 MiB
        assert a.stats["oom_refusals"] == 1


def test_vop_passes_plain_arguments_through():
    """A Python argument that sets an output's shape is static in both
    packages; it reaches the function as it is."""
    ja = singleton(jvmem)
    x = np.arange(16.0, dtype=np.float32)
    want = jvmem.vop(lambda v, n: v.reshape(n, -1).sum(axis=1),
                     static_argnums=(1,))(ja.array(x), 4).numpy()
    ta = singleton(tvmem)
    got = tvmem.vop(lambda v, n: v.reshape(n, -1).sum(dim=1),
                    static_argnums=(1,))(ta.array(x), 4).numpy()
    np.testing.assert_allclose(got, want)


def test_vop_donation_consumes_in_place_operands():
    """A donated operand may be updated in place and returned: its bytes
    go back to the arena before the output is adopted, so tracked bytes
    stay at one copy and the old VArray is gone."""
    a = singleton(tvmem)
    x = a.array(big(9))
    tracked = a.tracked_bytes

    def inc(v):
        return v.add_(1.0)

    y = tvmem.vop(inc, donate_argnums=0)(x)
    assert a.tracked_bytes == tracked
    assert x not in a._live and y in a._live
    np.testing.assert_allclose(y.numpy(), big(9) + 1.0)


@pytest.mark.parametrize("fn", [lambda v: v, lambda v: v[:256]],
                         ids=["operand", "view"])
def test_vop_output_aliasing_a_kept_operand_is_copied(fn):
    a = singleton(tvmem)
    x = a.array(big(11))
    y = tvmem.vop(fn)(x)
    assert (y._dev.untyped_storage().data_ptr()
            != x._dev.untyped_storage().data_ptr())
    assert a.tracked_bytes == x.nbytes + y.nbytes


def test_first_touch_is_refused(monkeypatch):
    monkeypatch.setenv("TPUSHARE_PAGER_FIRST_TOUCH", "1")
    with pytest.raises(NotImplementedError):
        tvmem.VirtualHBM(device="cpu")


# -- pytrees through vop ----------------------------------------------------


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.rand(64, 64).astype(np.float32),
            "layers": [rng.rand(32).astype(np.float32) for _ in range(2)],
            "pair": (rng.rand(8).astype(np.float32),
                     np.arange(4, dtype=np.int32))}


def test_tree_array_and_tree_numpy_round_trip():
    a = singleton(tvmem)
    tree = _tree(0)
    vt = tvmem.tree_array(tree, arena=a)
    assert isinstance(vt["layers"], list) and isinstance(vt["pair"], tuple)
    assert all(isinstance(x, tvmem.VArray)
               for x in (vt["w"], *vt["layers"], *vt["pair"]))
    assert a.tracked_bytes == sum(
        x.nbytes for x in (tree["w"], *tree["layers"], *tree["pair"]))
    assert tvmem.tree_array(vt, arena=a)["w"] is vt["w"]
    back = tvmem.tree_numpy(vt)
    np.testing.assert_array_equal(back["w"], tree["w"])
    np.testing.assert_array_equal(back["pair"][1], tree["pair"][1])
    assert tvmem.tree_numpy({"n": 3})["n"] == 3


def _scaled(params, scale, x):
    """dict in, dict out; ``scale`` is a Python float (static)."""
    return {"y": params["w"] @ x * scale,
            "parts": [layer + scale for layer in params["layers"]]}


def test_pytree_vop_with_static_args_matches_reference():
    tree = _tree(1)
    x = np.random.RandomState(2).rand(64).astype(np.float32)
    ja, ta = singleton(jvmem), singleton(tvmem)
    want = jvmem.tree_numpy(jvmem.vop(_scaled, static_argnums=(1,))(
        jvmem.tree_array(tree, ja), 0.5, ja.array(x)))
    out = tvmem.vop(_scaled, static_argnums=(1,))(
        tvmem.tree_array(tree, arena=ta), 0.5, ta.array(x))
    assert isinstance(out["parts"], list) and len(out["parts"]) == 2
    assert all(isinstance(v, tvmem.VArray) and v.resident
               for v in (out["y"], *out["parts"]))
    got = tvmem.tree_numpy(out)
    np.testing.assert_allclose(got["y"], want["y"], rtol=1e-5)
    for g, w in zip(got["parts"], want["parts"]):
        np.testing.assert_array_equal(g, w)
    assert dict(ta.stats) == dict(ja.stats)


def test_static_args_reach_the_meta_pass_as_they_are():
    seen = []

    def fn(x, cfg):
        seen.append((x.device.type, cfg))
        return x[: cfg["n"]] * 2.0

    a = singleton(tvmem)
    out = tvmem.vop(fn, static_argnums=1)(a.array(big(3, n=8)), {"n": 3})
    assert seen == [("meta", {"n": 3}), ("cpu", {"n": 3})]
    assert out.shape == (3, 8)


def test_pytree_donation_updates_dict_leaves_in_place():
    a = singleton(tvmem)
    cache = tvmem.tree_array({"k": np.zeros((4, 8), np.float32),
                              "v": np.zeros((4, 8), np.float32)}, arena=a)
    keep = a.array(np.ones(8, np.float32))
    tracked = a.tracked_bytes

    def write(cache, row, val):
        cache["k"][row] = val
        cache["v"][row] = val * 2.0
        return val.sum(), cache

    step = tvmem.vop(write, static_argnums=(1,), donate_argnums=(0,))
    ptrs = {}
    for row in range(3):
        total, cache = step(cache, row, keep)
        ptrs.setdefault("k", cache["k"]._dev.data_ptr())
        # In place: the donated buffers back the outputs, no copies.
        assert cache["k"]._dev.data_ptr() == ptrs["k"]
        assert a.tracked_bytes == tracked + total.nbytes  # one live total
    assert keep in a._live and keep.resident
    got = tvmem.tree_numpy(cache)
    np.testing.assert_array_equal(got["k"][:3], np.ones((3, 8)))
    np.testing.assert_array_equal(got["v"][:3], 2 * np.ones((3, 8)))
    np.testing.assert_array_equal(got["k"][3], np.zeros(8))


def test_vop_creates_outputs_from_a_device_argument_without_inputs():
    a = singleton(tvmem)

    def make(dev):
        return {"a": torch.ones(16, 16, device=dev),
                "b": [torch.zeros(4, device=dev)]}

    out = tvmem.vop(make)(torch.device("cpu"))
    assert a.tracked_bytes == 16 * 16 * 4 + 4 * 4
    assert out["a"].resident and out["a"].numpy().sum() == 256
    with pytest.raises(TypeError, match="tensor"):
        tvmem.vop(lambda x: {"n": 3})(a.array(big(4, n=4)))


# -- an LM pair under the real scheduler ---------------------------------


@pytest.fixture
def sched_env(tmp_path, native_build, monkeypatch):
    from tests.conftest import SchedulerProc

    monkeypatch.setenv("TPUSHARE_SOCK_DIR", str(tmp_path))
    monkeypatch.setenv("TPUSHARE_REQUIRE_SCHEDULER", "1")
    s = SchedulerProc(tmp_path, tq_sec=1)
    try:
        yield s
    finally:
        s.stop()


def _lm_run(names, budget):
    from nvshare_tpu_torch.colocate import Tenant, lm_workload, run_colocated
    from nvshare_tpu_torch.models.transformer import Transformer

    # A few seconds of gated work a tenant: several 1 s quanta.
    model = Transformer(vocab=64, dim=128, heads=4, depth=2, seq=512,
                        rope=True)
    pool = tvmem.PhysicalPool(budget)
    tenants = [Tenant(n, budget_bytes=budget, device="cpu", pool=pool)
               for n in names]
    try:
        report = run_colocated(
            {t: lm_workload(model, requests=64, score_batch=2,
                            decode_batch=4, decode_tokens=8)
             for t in tenants}, timeout_s=120)
        snaps = {t.name: t.telemetry_snapshot() for t in tenants}
    finally:
        for t in tenants:
            t.close()
    assert report.ok, report.errors
    return report, snaps


def test_lm_pair_under_the_scheduler_equals_solo(sched_env):
    solo, _ = _lm_run(["lm-solo"], 16 * MB)
    pair, snaps = _lm_run(["lm-t1", "lm-t2"], 16 * MB)
    err = sched_env.stop()
    assert "DROP_LOCK" in err, f"TQ never expired: {err}"
    want = solo.results["lm-solo"]
    assert want.passed and want.tokens.shape == (64, 4, 8)
    for name in ("lm-t1", "lm-t2"):
        assert f"LOCK_OK -> {name} " in err, err
        got = pair.results[name]
        assert got.checksums == want.checksums, name
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert snaps[name]["handoff_evicts"] > 0, snaps
        assert snaps[name]["prefetches"] > 0, snaps


def test_meta_pass_runs_once_per_signature():
    a = singleton(tvmem)
    metas = []

    def fn(x, pos, cfg):
        if x.device.type == "meta":
            metas.append(pos)
        return x[:2] * pos

    op = tvmem.vop(fn, static_argnums=(2,))
    x, y = a.array(big(5, n=8)), a.array(big(6, n=16))
    for pos in range(3):  # a dynamic scalar is keyed by its type
        op(x, pos, "cfg")
    assert metas == [0]
    op(y, 0, "cfg")      # another shape
    op(x, 0, "other")    # another static value
    assert metas == [0, 0, 0]
    out = op(x, 2.5, "cfg")  # another scalar type
    assert metas == [0, 0, 0, 2.5]
    np.testing.assert_allclose(out.numpy(), big(5, n=8)[:2] * 2.5)
    tvmem.vop(fn, static_argnums=(2,))(x, 1, {"unhashable": 1})
    tvmem.vop(fn, static_argnums=(2,))(x, 1, {"unhashable": 1})
    assert len(metas) == 6
