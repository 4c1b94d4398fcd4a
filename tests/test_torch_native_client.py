"""The port's client runtimes against the real scheduler, held to the JAX
package's. The native-client scenarios of ``tests/test_client_runtime.py``
(gate, early release, drop-and-reacquire, unmanaged, on-deck, horizon) run
once through ``nvshare_tpu.runtime.client.NativeClient`` and once through
the port's, each in a subprocess (the native runtime is per-process state)
against the same private scheduler with the same peers: the printed
outcomes, the callbacks' event lists and the scheduler's counters that the
run moved must be equal. ``make_client``'s choice is compared the same
way. Then the port's own deviations (a failing callback raised in the
tenant's thread, the bounded shutdown join of ``PurePythonClient``), and a
process tenant (``python -m nvshare_tpu_torch.bench_tenant``) on the CPU
held to the JAX package's add burner on the same chunks.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time

import pytest

from nvshare_tpu_torch.runtime.client import PurePythonClient
from nvshare_tpu_torch.runtime.protocol import MsgType, SchedulerLink
from tests.conftest import REPO_ROOT

pytestmark = pytest.mark.usefixtures("native_build")

# The reference first, then the port.
PACKAGES = ("nvshare_tpu", "nvshare_tpu_torch")


@pytest.fixture
def sock_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSHARE_SOCK_DIR", str(tmp_path))
    monkeypatch.setenv("TPUSHARE_RELEASE_CHECK_S", "1")
    return tmp_path


SCENARIO = r"""
import importlib, os, sys, time
sys.path.insert(0, sys.argv[1])
client = importlib.import_module(sys.argv[3] + ".runtime.client")
NativeClient, make_client = client.NativeClient, client.make_client
events = []
scenario = sys.argv[2]
callbacks = dict(
    sync_and_evict=lambda: events.append("evict"),
    prefetch=lambda: events.append("prefetch"),
    busy_probe=lambda: 0,
    on_deck=lambda ms: events.append(f"on_deck:{ms}"),
    on_horizon=lambda d, n, eta: events.append(f"horizon:{d}/{n}"),
)
if scenario == "make_client":
    c = make_client(**callbacks)
    print("OK", type(c).__name__, c.managed)
    c.shutdown()
    sys.exit(0)
if scenario == "callback_error":
    def fail():
        raise RuntimeError("device error during eviction")
    callbacks["sync_and_evict"] = fail
c = NativeClient(**callbacks)
if scenario == "gate":
    assert c.managed and c.scheduler_on
    c.continue_with_lock()
    assert c.owns_lock
    print("OK", c.client_id != 0, events)
elif scenario == "early_release":
    c.continue_with_lock()
    assert c.owns_lock
    t0 = time.time()
    while c.owns_lock and time.time() - t0 < 10:
        time.sleep(0.05)
    print("OK", not c.owns_lock, "evict" in events)
elif scenario == "drop_reacquire":
    c.continue_with_lock()
    got_drop = False
    t0 = time.time()
    while time.time() - t0 < 15:
        c.mark_activity()
        if not c.owns_lock:
            got_drop = True
            break
        time.sleep(0.02)
    c.continue_with_lock()   # must block until the lock comes back
    print("OK", got_drop, c.owns_lock, events.count("evict") >= 1)
elif scenario in ("on_deck", "horizon"):
    c.continue_with_lock()
    print("OK", c.owns_lock, events)
elif scenario == "unmanaged":
    print("OK", not c.managed)
    c.continue_with_lock()   # must be a no-op, not a hang
    print("GATE_PASSED")
elif scenario == "callback_error":
    c.continue_with_lock()
    try:
        c.release_now()
    except RuntimeError as e:
        print("RAISED", type(e.__cause__).__name__, e.__cause__)
    try:
        c.continue_with_lock()
    except RuntimeError:
        print("RAISED AGAIN")
c.shutdown()
"""


def run_scenario(scenario: str, env: dict = None,
                 package: str = "nvshare_tpu_torch") -> str:
    out = subprocess.run(
        [sys.executable, "-c", SCENARIO, str(REPO_ROOT), scenario, package],
        capture_output=True, text=True, timeout=60,
        env=dict(os.environ, **(env or {})))
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


# The scheduler's cumulative counters (``tpusharectl -s``) a scenario moves.
COUNTERS = ("grants", "drops", "early", "revoked")


def counters(sched) -> dict:
    """The scheduler's totals: the first line of ``tpusharectl -s``. The
    lines after it are one a connected client and repeat ``grants=`` and
    ``revoked=`` for that client alone; read with the totals, a client
    whose exit the scheduler has not yet seen (a loaded host) would
    replace them."""
    summary = sched.ctl("-s").stdout.splitlines()[0]
    fields = dict(kv.split("=", 1) for kv in summary.split() if "=" in kv)
    return {k: int(fields[k]) for k in COUNTERS}


def on_both(scenario: str, sched=None, env: dict = None, peers=None,
            compare=COUNTERS) -> str:
    """Run ``scenario`` through the JAX package's client, then the port's;
    ``peers()`` starts the scenario's other tenants before each run and
    returns a function that waits for them. Returns the port's stdout once
    both printed the same (the on-deck estimate's milliseconds, a timing,
    aside) and moved the scheduler's ``compare`` counters alike."""
    seen = {}
    for package in PACKAGES:
        before = counters(sched) if sched is not None else {}
        wait = peers() if peers is not None else None
        out = run_scenario(scenario, env, package)
        if wait is not None:
            wait()
        after = counters(sched) if sched is not None else {}
        seen[package] = (re.sub(r"on_deck:\d+", "on_deck:N", out),
                         {k: after[k] - before[k] for k in compare
                          if k in after})
    assert seen["nvshare_tpu_torch"] == seen["nvshare_tpu"], seen
    return seen["nvshare_tpu_torch"][0]


def start(fn):
    """Start ``fn`` on a thread; return the wait for it."""
    t = threading.Thread(target=fn)
    t.start()

    def wait():
        t.join(timeout=40)
        assert not t.is_alive(), "a peer of the scenario never finished"
    return wait


def test_native_gate_acquires_lock(sock_env, sched):
    out = on_both("gate", sched)
    assert "OK True" in out
    assert "prefetch" in out  # prefetch ran before the grant unblocked


def test_native_early_release_when_idle(sock_env, sched):
    out = on_both("early_release", sched)
    assert "OK True True" in out
    assert "early=2" in sched.ctl("-s").stdout  # one a package


def test_native_drop_lock_evicts_and_reacquires(sock_env, fast_sched):
    drops = []

    def contender():
        def contend():
            link = SchedulerLink(path=fast_sched.path, job_name="contender")
            link.register()
            try:
                deadline = time.time() + 30
                while time.time() < deadline:
                    if "held=1" in fast_sched.ctl("-s").stdout:
                        break
                    time.sleep(0.2)
                else:
                    return
                drops.append(counters(fast_sched)["drops"])
                link.send(MsgType.REQ_LOCK)
                while True:
                    m = link.recv(timeout=60)
                    if m.type == MsgType.LOCK_OK:
                        time.sleep(0.3)
                        link.send(MsgType.LOCK_RELEASED)
                        drops.append(counters(fast_sched)["drops"])
                        return
            finally:
                link.close()
        return start(contend)

    # The quantum is 1 s: a contender's 0.3 s hold stretched past it on a
    # loaded host would be dropped too, so the drop count is held per run
    # (the client's own drop) rather than between the packages.
    out = on_both("drop_reacquire", fast_sched, peers=contender,
                  compare=("early", "revoked"))
    assert "OK True True True" in out
    assert len(drops) == 4 and drops[1] > drops[0] and drops[3] > drops[2]


def test_native_unmanaged_when_no_scheduler(sock_env):
    out = on_both("unmanaged")
    assert "OK True" in out and "GATE_PASSED" in out


def holder(sched, waiter: bool = False):
    """The scenario's peers: a tenant that holds the lock when the
    client arrives and hands it on after 1.5 s, and with ``waiter`` one
    queued behind it, which takes the lock for 0.2 s next."""
    def peers():
        links = [SchedulerLink(path=sched.path, job_name="holder")]
        links[0].register()
        links[0].send(MsgType.REQ_LOCK)
        assert links[0].recv().type == MsgType.LOCK_OK
        if waiter:
            links.append(SchedulerLink(path=sched.path, job_name="waiter"))
            links[1].register()
            links[1].send(MsgType.REQ_LOCK)
            time.sleep(0.3)

        def drain():
            time.sleep(1.5)
            links[0].send(MsgType.LOCK_RELEASED)
            if waiter:
                while links[1].recv(timeout=30).type != MsgType.LOCK_OK:
                    pass
                time.sleep(0.2)
                links[1].send(MsgType.LOCK_RELEASED)

        wait = start(drain)

        def done():
            wait()
            for link in links:
                link.close()
        return done
    return peers


def test_native_on_deck_advisory_before_grant(sock_env, sched):
    out = on_both("on_deck", sched, peers=holder(sched))
    assert "OK True" in out and "on_deck:" in out, out
    events = out.split("[", 1)[1]
    assert events.index("on_deck") < events.index("prefetch"), out


def test_native_grant_horizon_staging_at_depth_two(sock_env, sched):
    out = on_both("horizon", sched, peers=holder(sched, waiter=True))
    assert "OK True" in out and "horizon:2/2" in out, out


@pytest.mark.parametrize("env,want", [
    ({}, "NativeClient"),
    ({"TPUSHARE_PURE_PYTHON": "1"}, "PurePythonClient"),
    ({"TPUSHARE_LIB_DIR": "/nonexistent"}, "PurePythonClient")])
def test_make_client_chooses_as_the_reference(sock_env, sched, env, want):
    """Native by default; ``$TPUSHARE_PURE_PYTHON=1`` or a missing
    library (``$TPUSHARE_LIB_DIR``) falls back to the Python client. The
    JAX package's ``make_client`` and the port's choose the same class
    under each environment, and either registers."""
    assert f"OK {want} True" in on_both("make_client", sched, env=env)


def test_native_callback_error_fails_the_tenant(sock_env, sched):
    """An exception in a callback on the native runtime's thread (here
    the eviction) is raised in the tenant's thread, at the call that
    ran it and at every gate after; the JAX package's wrapper leaves it
    to ctypes, which prints it and carries on."""
    out = run_scenario("callback_error")
    assert "RAISED RuntimeError device error during eviction" in out, out
    assert "RAISED AGAIN" in out


def test_pure_python_shutdown_join_is_bounded(sock_env, sched,
                                              monkeypatch):
    """A callback that blocks on purpose (the idle early release's
    eviction) holds a client thread; the port's ``shutdown`` gives up on
    the join after ``SHUTDOWN_JOIN_S`` and logs it. This deviates from
    the JAX package, whose ``PurePythonClient.shutdown`` joins without a
    bound (a wedged callback hangs process exit there); that reference
    stays as it is."""
    release = threading.Event()
    entered = threading.Event()

    def stuck():
        entered.set()
        release.wait(30)

    from nvshare_tpu_torch.runtime import client as client_mod

    monkeypatch.setattr(client_mod, "SHUTDOWN_JOIN_S", 0.5)
    c = PurePythonClient(sync_and_evict=stuck, job_name="stuck")
    try:
        c.continue_with_lock()
        assert entered.wait(20), "the eviction callback never ran"
        t0 = time.monotonic()
        c.shutdown()
        waited = time.monotonic() - t0
        assert 0.4 < waited < 5.0, waited
        # The thread inside the callback is left behind, not waited for.
        assert [t.name for t in (c._msg_thread, c._rel_thread)
                if t.is_alive()] == ["tpushare-release"]
    finally:
        release.set()
        c._rel_thread.join(timeout=10)
    assert not c._rel_thread.is_alive()


def test_bench_tenant_runs_a_gated_burner_on_the_cpu(sock_env, sched,
                                                    monkeypatch):
    """The process tenant registers through the native client (the
    default), runs the add burner on the process arena, writes its
    metrics textfile at exit and prints a RESULT whose checksum equals
    the JAX package's add burner over the same chunks (the port's seeded
    chunks, read back as numpy), within the 1e-6 relative tolerance of
    ``tests/test_torch_burner.py`` (XLA may fuse a multiply-add)."""
    import nvshare_tpu.vmem as jvmem
    from nvshare_tpu.models.burner import AddBurner as JAddBurner
    from nvshare_tpu_torch.colocate import Tenant
    from nvshare_tpu_torch.models.burner import AddBurner
    from tests.test_torch_burner import jax_burner

    wss, steps, chunks = 4 << 20, 6, 4
    args = ["add", str(wss), str(steps), str(chunks), "0.9",
            "--device", "cpu"]
    env = dict(os.environ, TPUSHARE_HBM_BYTES=str(64 << 20),
               TPUSHARE_METRICS_TEXTFILE=str(sock_env / "{job}.prom"))
    out = subprocess.run(
        [sys.executable, "-m", "nvshare_tpu_torch.bench_tenant", "bt",
         *args], cwd=REPO_ROOT, capture_output=True, text=True,
        timeout=120, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    line = next(ln for ln in out.stdout.splitlines()
                if ln.startswith("bt RESULT "))
    res = json.loads(line.split(" RESULT ", 1)[1])
    assert (res["client"], res["managed"], res["ok"]) == \
        ("NativeClient", True, True)
    assert res["launches"] == {"fused_mix": 0, "tiled_matmul": 0}  # CPU

    t = Tenant("bench-tenant-chunks", budget_bytes=64 << 20, device="cpu")
    try:
        arrays = t.run(lambda tenant: [
            c.numpy() for c in AddBurner(wss, chunks=chunks,
                                         arena=tenant.arena).chunks])
    finally:
        t.close()
    monkeypatch.setenv("TPUSHARE_HBM_BYTES", str(64 << 20))
    jvmem.reset_arena()
    try:
        burner = jax_burner(JAddBurner, arrays, jvmem.arena())
        burner.side = arrays[0].shape[0]
        want = burner.run(steps)
    finally:
        jvmem.reset_arena()
    assert want.passed
    assert res["checksum"] == pytest.approx(want.checksum, rel=1e-6)
    prom = (sock_env / "bt.prom").read_text()
    assert 'tpushare_lock_acquires_total{client="bt"}' in prom
