"""The port's dispatch-mode gate for unmodified programs, on the CPU.

The counterparts of ``tests/test_interpose.py`` and
``tests/test_interpose_sweep.py``: ``interpose.enable(device="cpu")``
gates every aten op on the CPU the way the card's gate gates CUDA ops.
Unmanaged work still runs; under a scheduler the first gated op
registers and holds the lock; ``disable()`` restores plain dispatch; each
gated op counts and reaches ``after_submit``; a battery of programs gives
the same bits gated and ungated, and agrees with the JAX battery on
numpy inputs; a critical section and a kernel wrapper gate once; the
port's own threads never carry the gate.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from nvshare_tpu_torch import interpose, vmem
from nvshare_tpu_torch.ops import fused_mix
from nvshare_tpu_torch.runtime.client import PurePythonClient


def _gated_total() -> int:
    fam = interpose._exec_counter()
    return int(sum(child.value for _, child in fam.samples()))


@pytest.fixture
def gate_on(monkeypatch):
    monkeypatch.setenv("TPUSHARE_PURE_PYTHON", "1")  # in-process safe
    vmem.reset_arena()
    interpose._reset_client_for_tests()
    interpose.enable(device="cpu")
    try:
        yield
    finally:
        interpose.disable()
        interpose._reset_client_for_tests()
        vmem.reset_arena()


def test_unmanaged_work_still_runs(gate_on, tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSHARE_SOCK_DIR", str(tmp_path))  # nothing there
    x = torch.ones(64, 64)
    assert float((x @ x).sum()) == 64.0 * 64 * 64
    assert not interpose.client().managed
    assert _gated_total() >= 3


def test_registers_and_holds_lock_under_scheduler(gate_on, sched,
                                                  monkeypatch):
    monkeypatch.setenv("TPUSHARE_SOCK_DIR", sched.sock_dir)
    x = torch.arange(16.0)
    np.testing.assert_array_equal((x * 2.0).numpy(), np.arange(16.0) * 2)
    c = interpose.client()
    assert c.managed
    assert c.owns_lock  # granted on the first gated op
    st = sched.ctl("-s").stdout
    assert "clients=1" in st and "held=1" in st


def test_disable_restores_dispatch(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSHARE_PURE_PYTHON", "1")
    monkeypatch.setenv("TPUSHARE_SOCK_DIR", str(tmp_path))
    start = threading.Thread.start
    interpose.enable(device="cpu")
    interpose.enable(device="cpu")  # idempotent
    try:
        assert sum(isinstance(m, interpose._GateMode)
                   for m in _get_current_dispatch_mode_stack()) == 1
        assert threading.Thread.start is not start
    finally:
        interpose.disable()
        interpose.disable()
        interpose._reset_client_for_tests()
        vmem.reset_arena()
    assert not interpose.enabled()
    assert threading.Thread.start is start is interpose._saved["start"]
    assert not any(isinstance(m, interpose._GateMode)
                   for m in _get_current_dispatch_mode_stack())
    before = _gated_total()
    assert float(torch.ones(3).sum()) == 3.0
    assert _gated_total() == before


def test_each_gated_op_counts_and_reaches_after_submit(gate_on, tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("TPUSHARE_SOCK_DIR", str(tmp_path))
    torch.ones(1)  # bootstrap the client and the arena
    a = interpose.current_arena()
    calls = []
    orig = a.after_submit
    monkeypatch.setattr(a, "after_submit",
                        lambda: (calls.append(1), orig())[1])
    before = _gated_total()
    x = torch.ones(8, 8)          # aten.ones
    y = (x * 2).sum()             # aten.mul, aten.sum
    z = x.view(64)                # a view: gated and counted too
    assert float(y) == 128.0      # aten._local_scalar_dense
    assert z.shape == (64,)
    n = _gated_total() - before
    assert n == len(calls) == 5, (n, len(calls))
    # Meta tensors never touch the gated device.
    torch.ones(4, device="meta") * 2
    assert _gated_total() - before == 5


def programs():
    """The battery of ``tests/test_interpose_sweep.py`` in PyTorch, each
    on numpy inputs ``inp`` (so the same values feed both packages)."""

    def p_matmul(inp):
        x = torch.from_numpy(inp["x64"])
        return x @ x.T

    def p_grad(inp):
        w = torch.from_numpy(inp["w"]).requires_grad_()
        x = torch.from_numpy(inp["x16"])
        loss = (torch.tanh(x @ w) ** 2).sum()
        return torch.autograd.grad(loss, w)[0]

    def p_scan(inp):
        carry, ys = torch.zeros(8), []
        for t in torch.arange(40.0).reshape(5, 8):
            carry = carry * 0.9 + t
            ys.append(carry)
        return torch.stack(ys)

    def p_vmap(inp):
        f = torch.func.vmap(lambda a, b: torch.dot(a, b) + torch.sin(a).sum())
        return f(torch.from_numpy(inp["a"]), torch.from_numpy(inp["b"]))

    def p_while(inp):
        i, v = torch.tensor(0), torch.ones(4)
        while i < 10:
            i, v = i + 1, v * 1.1
        return v

    def p_random_and_sort(inp):
        gen = torch.Generator().manual_seed(0)
        drawn = torch.rand(1000, generator=gen)
        x = torch.from_numpy(inp["u"]) + 0.0 * drawn
        return torch.sort(x).values[::100]

    def p_mixed_dtypes(inp):
        a = torch.arange(24, dtype=torch.int32).reshape(4, 6)
        b = a.to(torch.bfloat16) * 1.5
        return b.float().sum(dim=0), a.max()

    def p_cond_and_dynamic_slice(inp):
        x = torch.arange(64.0).reshape(8, 8)
        y = x * 2.0 if x.sum() > 0 else x - 1.0
        at = int(torch.tensor(3))
        y = y.clone()
        y[at:at + 2, at:at + 2] = torch.zeros(2, 2)
        return y

    return {"matmul": p_matmul, "grad": p_grad, "scan": p_scan,
            "vmap": p_vmap, "while": p_while,
            "random_sort": p_random_and_sort,
            "mixed_dtypes": p_mixed_dtypes,
            "cond_dynslice": p_cond_and_dynamic_slice}


def jax_programs():
    """The same programs as the JAX battery writes them, on ``inp``."""

    def p_matmul(inp):
        return jax.jit(lambda a: a @ a.T)(jnp.asarray(inp["x64"]))

    def p_grad(inp):
        def loss(w, x):
            return jnp.sum(jnp.tanh(x @ w) ** 2)
        return jax.grad(loss)(jnp.asarray(inp["w"]), jnp.asarray(inp["x16"]))

    def p_scan(inp):
        def step(carry, t):
            carry = carry * 0.9 + t
            return carry, carry
        _, ys = jax.lax.scan(step, jnp.zeros((8,)),
                             jnp.arange(40.0).reshape(5, 8))
        return ys

    def p_vmap(inp):
        f = jax.vmap(lambda a, b: jnp.dot(a, b) + jnp.sin(a).sum())
        return f(jnp.asarray(inp["a"]), jnp.asarray(inp["b"]))

    def p_while(inp):
        return jax.lax.while_loop(lambda s: s[0] < 10,
                                  lambda s: (s[0] + 1, s[1] * 1.1),
                                  (0, jnp.ones((4,))))[1]

    def p_random_and_sort(inp):
        return jnp.sort(jnp.asarray(inp["u"]))[::100]

    def p_mixed_dtypes(inp):
        a = jnp.arange(24, dtype=jnp.int32).reshape(4, 6)
        b = a.astype(jnp.bfloat16) * 1.5
        return (b.astype(jnp.float32).sum(axis=0), a.max())

    def p_cond_and_dynamic_slice(inp):
        x = jnp.arange(64.0).reshape(8, 8)
        y = jax.lax.cond(x.sum() > 0, lambda a: a * 2.0,
                         lambda a: a - 1.0, x)
        return jax.lax.dynamic_update_slice(y, jnp.zeros((2, 2)), (3, 3))

    return {"matmul": p_matmul, "grad": p_grad, "scan": p_scan,
            "vmap": p_vmap, "while": p_while,
            "random_sort": p_random_and_sort,
            "mixed_dtypes": p_mixed_dtypes,
            "cond_dynslice": p_cond_and_dynamic_slice}


def inputs():
    rng = np.random.RandomState(0)
    return {"x64": rng.randn(64, 64).astype(np.float32),
            "w": rng.randn(32, 8).astype(np.float32),
            "x16": rng.randn(16, 32).astype(np.float32),
            "a": rng.randn(10, 32).astype(np.float32),
            "b": rng.randn(10, 32).astype(np.float32),
            "u": rng.rand(1000).astype(np.float32)}


def _leaves(out) -> list:
    outs = out if isinstance(out, tuple) else (out,)
    return [np.asarray(o.detach().float().numpy() if isinstance(
        o, torch.Tensor) else o, dtype=np.float64) for o in outs]


# Tolerances against JAX, from the dtype: f32 products and transcendentals
# agree to a few ulp of their magnitude (summation order differs between
# the two CPU backends); sorting, integer, bf16-exact and elementwise
# programs agree exactly.
JAX_RTOL = {"matmul": 1e-5, "grad": 1e-5, "vmap": 1e-5, "scan": 1e-6,
            "while": 1e-6, "random_sort": 0.0, "mixed_dtypes": 0.0,
            "cond_dynslice": 0.0}


@pytest.mark.parametrize("name", sorted(programs()))
def test_sweep_matches_ungated(name, sched, monkeypatch):
    monkeypatch.setenv("TPUSHARE_SOCK_DIR", sched.sock_dir)
    monkeypatch.setenv("TPUSHARE_PURE_PYTHON", "1")
    prog, inp = programs()[name], inputs()
    baseline = _leaves(prog(inp))
    vmem.reset_arena()
    interpose._reset_client_for_tests()
    interpose.enable(device="cpu")
    try:
        before = _gated_total()
        got = _leaves(prog(inp))
        gated = _gated_total() - before
    finally:
        interpose.disable()
        interpose._reset_client_for_tests()
        vmem.reset_arena()
    assert gated > 0
    for want, have in zip(baseline, got, strict=True):
        np.testing.assert_array_equal(have, want)
    # Everything above executed under the device lock.
    assert "grants=1" in sched.ctl("-s").stdout


@pytest.mark.parametrize("name", sorted(programs()))
def test_sweep_agrees_with_the_jax_battery(name):
    inp = inputs()
    got = _leaves(programs()[name](inp))
    want = jax.tree_util.tree_leaves(jax_programs()[name](inp))
    want = [np.asarray(w, dtype=np.float64) for w in want]
    for w, g in zip(want, got, strict=True):
        np.testing.assert_allclose(g, w, rtol=JAX_RTOL[name],
                                   atol=JAX_RTOL[name] * np.abs(w).max())


def test_critical_section_gates_nothing_twice(gate_on, sched, monkeypatch):
    monkeypatch.setenv("TPUSHARE_SOCK_DIR", sched.sock_dir)
    torch.ones(1)
    c = interpose.client()
    va = vmem.arena().array(np.ones((16, 16), np.float32))
    gates = []
    orig = c.continue_with_lock
    monkeypatch.setattr(c, "continue_with_lock",
                        lambda: (gates.append(1), orig())[1])
    before = _gated_total()
    with interpose.critical_section():
        x = torch.ones(16, 16)
        (x @ x).sum()
    assert gates == [] and _gated_total() == before
    # vop gates once by itself; its ops run in its critical section.
    out = vmem.vop(lambda a: (a @ a) * 2.0)(va)
    assert gates == [1] and _gated_total() == before
    assert float(out.numpy()[0, 0]) == 32.0


def test_kernel_wrapper_is_one_gated_unit(gate_on, sched, monkeypatch):
    monkeypatch.setenv("TPUSHARE_SOCK_DIR", sched.sock_dir)
    a = torch.rand(256, 256)
    b = torch.rand(256, 256)
    c = interpose.client()
    arena = interpose.current_arena()
    trace = []
    orig_gate, orig_record = c.continue_with_lock, arena._record_pending
    monkeypatch.setattr(c, "continue_with_lock",
                        lambda: (trace.append("gate"), orig_gate())[1])
    monkeypatch.setattr(arena, "_record_pending",
                        lambda: (trace.append("record"), orig_record())[1])
    before = _gated_total()
    out = fused_mix(a, b, 0.3, 0.7)   # the plain version: several aten ops
    assert _gated_total() - before == 1
    assert trace == ["gate", "record"]
    torch.testing.assert_close(out, a * 0.3 + b * 0.7 + 0.125, rtol=0,
                               atol=0)
    # The unit's shape on the card: one gate, the launch inside the
    # critical section (counted as gated), its completion recorded after.
    from nvshare_tpu_torch.ops._build import LaunchCount

    count = LaunchCount()
    trace.clear()
    with interpose.launch_unit(torch.device("cpu")) as gated:
        torch.empty(4)
        trace.append("launch")
        count.add()
        assert interpose.in_gated_unit()
    assert gated and trace == ["gate", "launch", "record"]
    assert (count.value, count.gated) == (1, 1)
    assert not interpose.in_gated_unit()
    # Inside a vop (a critical section) the wrapper is not a unit.
    with interpose.critical_section():
        with interpose.launch_unit(torch.device("cpu")) as gated:
            pass
    assert not gated


def test_port_threads_run_ungated_and_user_threads_gated(
        gate_on, fast_sched, monkeypatch):
    """A peer takes the lock after a 1 s quantum: the handoff's eviction
    (torch copies on the client's message thread) must not be gated, or
    it would wait on the lock it is handing back. A thread the program
    starts from a gated thread is gated; one started in a critical
    section is not."""
    monkeypatch.setenv("TPUSHARE_SOCK_DIR", fast_sched.sock_dir)
    monkeypatch.setenv("TPUSHARE_REQUIRE_SCHEDULER", "1")
    seen = []
    orig = vmem.VirtualHBM._release_to_device

    def spy(self):
        seen.append((threading.current_thread().name,
                     interpose._carries_gate()))
        orig(self)

    monkeypatch.setattr(vmem.VirtualHBM, "_release_to_device", spy)
    va = vmem.arena("cpu").array(np.ones((64, 64), np.float32))
    bump = vmem.vop(lambda x: x + 1.0, donate_argnums=0)
    va = bump(va)   # resident and dirty: the eviction copies it out
    before = _gated_total()
    results = {}

    def user():
        results["user"] = float(torch.ones(4).sum())

    t = threading.Thread(target=user)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and results["user"] == 4.0
    assert _gated_total() - before == 3   # ones, sum, item on that thread
    with interpose.critical_section():
        t = threading.Thread(target=user)
        t.start()
    t.join(timeout=30)
    assert not t.is_alive() and _gated_total() - before == 3

    peer = PurePythonClient(job_name="peer")
    try:
        got = threading.Event()

        def want_lock():
            peer.continue_with_lock()
            got.set()

        w = threading.Thread(target=want_lock, daemon=True)
        with interpose.critical_section():
            w.start()
        assert got.wait(timeout=30), "the peer was never granted"
        peer.release_now()
        w.join(timeout=10)
    finally:
        peer.shutdown()
    assert seen and all(not gated for _, gated in seen), seen
    assert all(name != threading.main_thread().name for name, _ in seen)
    np.testing.assert_array_equal(va.numpy(), np.full((64, 64), 2.0))
