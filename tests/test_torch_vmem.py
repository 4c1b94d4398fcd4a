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
    """The JAX vop needs static_argnums for a Python argument; PyTorch
    runs eagerly, so the port passes it through as it is."""
    ja = singleton(jvmem)
    x = np.arange(16.0, dtype=np.float32)
    want = jvmem.vop(lambda v, n: v.reshape(n, -1).sum(axis=1),
                     static_argnums=(1,))(ja.array(x), 4).numpy()
    ta = singleton(tvmem)
    got = tvmem.vop(lambda v, n: v.reshape(n, -1).sum(dim=1))(
        ta.array(x), 4).numpy()
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
