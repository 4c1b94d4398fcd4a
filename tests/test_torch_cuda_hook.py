"""The driver-API interposer (``libtpushare_cuda.so`` over the mock
``libcuda.so.1``) held to the JAX package's PJRT interposer
(``libtpushare.so`` over ``libtpushare_mockpjrt.so``).

Each scenario of ``tests/test_pjrt_hook.py`` runs through both, one after
the other, under one scheduler and with the same knobs: the JAX package's
``tpushare-hook-test`` and the port's ``tpushare-cuda-hook-test``, each
printing the same milestones. The test holds both to the same outcome
(launches, ``MEMLIMIT``, waiting for a contender's release, the fence's
bound, refusal or warning) and the scheduler's ``grants``/``drops`` moved
alike. Timings differ by nature only where a CUDA stream runs its work in
order (a wedged launch stalls the launches after it on its stream, where
the PJRT mock completes each execution on its own); the bounds asserted
are the reference test's, on both.

The port's own cases follow: every way a program reaches the driver (the
CUDA 12 runtime's ``cuGetProcAddress_v2``, ``dlsym`` at both glibc
versions, the per-thread-default-stream variants) is gated; a symbol the
hook does not wrap is the driver's own; allocation routes the hook does
not count fail loudly; ``TPUSHARE_CVMEM=1`` is refused; a capturing
stream's launch is not gated while the captured graph's launch is. Every
port run also checks that the mock saw no driver call without a current
context (the fence runs on the client's thread)."""

import os
import subprocess
import threading
import time
from dataclasses import dataclass

import pytest

from nvshare_tpu_torch.runtime import native
from nvshare_tpu_torch.runtime.protocol import MsgType, SchedulerLink
from tests.conftest import BUILD_DIR

JAX_HOOK = BUILD_DIR / "libtpushare.so"
JAX_MOCK = BUILD_DIR / "libtpushare_mockpjrt.so"
JAX_DRIVER = BUILD_DIR / "tpushare-hook-test"

pytestmark = pytest.mark.usefixtures("native_build")

NO_CONTEXT = "without a current context"


@pytest.fixture(scope="module")
def cuda_hook(native_build):
    return native.build()


@dataclass
class Run:
    events: dict
    out: str
    err: str
    wall: float
    rc: int


def parse(stdout: str) -> dict:
    events = {}
    for line in stdout.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] in ("CLIENT", "H2D", "D2H", "DONE", "MEMLIMIT", "C2D"):
            events[parts[0]] = int(parts[1])
        elif parts[0] == "EXEC":
            events.setdefault("EXEC", []).append(int(parts[2]))
    return events


def _run(cmd, env, timeout) -> Run:
    t0 = time.monotonic()
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=timeout)
    return Run(parse(out.stdout), out.stdout, out.stderr,
               time.monotonic() - t0, out.returncode)


def run_jax(sock_dir, n=4, scenario="", env=None, timeout=60) -> Run:
    full = dict(os.environ, TPUSHARE_SOCK_DIR=str(sock_dir),
                TPUSHARE_REAL_PLUGIN=str(JAX_MOCK), **(env or {}))
    cmd = [str(JAX_DRIVER), str(n), str(JAX_HOOK)]
    run = _run(cmd + ([scenario] if scenario else []), full, timeout)
    assert run.rc == 0, run.err
    return run


def run_port(build_dir, sock_dir, n=4, scenario="", env=None, timeout=60,
             rc=0) -> Run:
    mock = build_dir / "mock"
    base = dict(os.environ, LD_LIBRARY_PATH=str(mock), **(env or {}))
    full = native.preload_env(base, hook=build_dir / native.HOOK_NAME,
                              sock_dir=sock_dir,
                              real_libcuda=mock / "libcuda.so.1")
    cmd = [str(build_dir / native.TEST_DRIVER_NAME), str(n)]
    run = _run(cmd + ([scenario] if scenario else []), full, timeout)
    assert run.rc == rc, run.out + run.err
    assert native.preloaded(run.err), run.err
    assert NO_CONTEXT not in run.err, run.err
    return run


def counters(sched) -> dict:
    fields = dict(kv.split("=", 1) for kv in sched.ctl("-s").stdout.split()
                  if "=" in kv)
    return {k: int(fields[k]) for k in ("grants", "drops")}


def on_both(sched, build_dir, peers=None, **kw) -> tuple:
    """The scenario through the JAX package's interposer, then the
    port's; ``peers()`` starts the scenario's other tenants before each
    run and returns what to call after it (its result). Returns both
    runs, the scheduler counters each moved, and each peer's result."""
    runs, moved, peer_out = [], [], []
    for runner in (lambda: run_jax(sched.sock_dir, **kw),
                   lambda: run_port(build_dir, sched.sock_dir, **kw)):
        before = counters(sched)
        done = peers() if peers is not None else None
        runs.append(runner())
        peer_out.append(done() if done is not None else None)
        after = counters(sched)
        moved.append({k: after[k] - before[k] for k in after})
    return runs, moved, peer_out


def holder(sched, hold_s=4.0):
    """A contender that holds the lock when the driver starts and
    releases it after ``hold_s``; its result is the release time on the
    CLOCK_MONOTONIC ms the drivers print."""
    def peers():
        link = SchedulerLink(path=sched.path, job_name="holder")
        link.register()
        link.send(MsgType.REQ_LOCK)
        assert link.recv().type == MsgType.LOCK_OK
        state = {}

        def release_later():
            time.sleep(hold_s)
            state["release_ms"] = time.monotonic() * 1000
            link.send(MsgType.LOCK_RELEASED)

        t = threading.Thread(target=release_later)
        t.start()

        def done():
            t.join(timeout=30)
            assert not t.is_alive()
            link.close()
            return state["release_ms"]
        return done
    return peers


def idle_taker(sched, hold_s=2.0):
    """A contender that asks for the lock at once, is granted it when the
    driver idles (early release), holds it ``hold_s`` and releases."""
    def peers():
        link = SchedulerLink(path=sched.path, job_name="holder")
        link.register()
        state = {}

        def contend():
            link.send(MsgType.REQ_LOCK)
            m = link.recv(timeout=30)
            assert m.type == MsgType.LOCK_OK
            time.sleep(hold_s)
            state["release_ms"] = time.monotonic() * 1000
            link.send(MsgType.LOCK_RELEASED)

        t = threading.Thread(target=contend)
        t.start()

        def done():
            t.join(timeout=40)
            assert not t.is_alive()
            link.close()
            return state["release_ms"]
        return done
    return peers


# -- the scenarios of tests/test_pjrt_hook.py, on both interposers ----------

def test_passthrough_and_gating(sched, cuda_hook):
    (jax, port), moved, _ = on_both(sched, cuda_hook, n=4)
    for run in (jax, port):
        assert "DONE" in run.events and len(run.events["EXEC"]) == 4, run.out
    # Registered and granted (>= 1: a loaded host's early release may
    # hand the lock back mid-run and the driver re-acquires), never
    # dropped (no contender).
    assert [m["grants"] >= 1 for m in moved] == [True, True], moved
    assert moved[0]["drops"] == moved[1]["drops"] == 0, moved
    report = native.hook_report(port.err)
    assert (report["launches"], report["copies"]) == (4, 2), report
    assert "MOCK launches=4 " in port.out


def test_memory_stats_reserve_lie(sched, cuda_hook):
    (jax, port), _, _ = on_both(sched, cuda_hook)
    # Both mocks report 16 GiB; both interposers subtract 1536 MiB.
    assert jax.events["MEMLIMIT"] == port.events["MEMLIMIT"] == \
        (16 << 30) - (1536 << 20)


def test_execution_blocked_while_contender_holds(sched, cuda_hook):
    (jax, port), moved, released = on_both(sched, cuda_hook,
                                           peers=holder(sched), n=2)
    for run, release_ms in zip((jax, port), released):
        ev = run.events
        # The ungated bootstrap before the release, the first gated call
        # (the upload) only after it.
        assert ev["CLIENT"] < release_ms, run.out
        assert ev["H2D"] >= release_ms - 50, run.out
        assert ev["DONE"] - ev["H2D"] < 2000, run.out
    assert moved[0] == moved[1], moved


def test_window_fences_slow_executions(sched, cuda_hook):
    # 120 ms of device time per launch, the window starting at 1: the
    # fence inside call 0, none between 0 and 1, the next inside call 2.
    (jax, port), _, _ = on_both(sched, cuda_hook, n=3,
                                env={"TPUSHARE_MOCK_EXEC_MS": "120"})
    for run in (jax, port):
        ex = run.events["EXEC"]
        assert len(ex) == 3
        assert ex[2] - ex[1] >= 100, run.out
        assert ex[1] - ex[0] <= 60, run.out


def test_fence_bounded_on_wedged_device(sched, cuda_hook):
    # TPUSHARE_MOCK_EXEC_MS=-1: nothing ever completes. Every fence gives
    # up after TPUSHARE_FENCE_TIMEOUT_MS with a WARN.
    (jax, port), _, _ = on_both(
        sched, cuda_hook, n=2, timeout=45,
        env={"TPUSHARE_MOCK_EXEC_MS": "-1",
             "TPUSHARE_FENCE_TIMEOUT_MS": "400"})
    for run in (jax, port):
        assert "DONE" in run.events and len(run.events["EXEC"]) == 2
        assert "fence timed out" in run.err, run.err
        assert run.wall < 20, run.wall
    assert native.hook_report(port.err)["fence_timeouts"] >= 1


def test_alloc_policy_refuses_oversubscription(sched, cuda_hook):
    # 16 GiB less a 15 GiB reserve leaves 1 GiB: a ~1.5 GiB claim is
    # refused with the platform's out-of-memory code, a small one works.
    (jax, port), _, _ = on_both(sched, cuda_hook, n=1, scenario="policy",
                                env={"TPUSHARE_RESERVE_BYTES": "15GiB"})
    for run in (jax, port):
        assert "POLICY_REFUSED" in run.out and "SMALL_OK" in run.out
        assert "POLICY_DONE" in run.out
    assert "REFUSAL_CODE 8" in jax.out  # PJRT RESOURCE_EXHAUSTED
    assert "REFUSAL_CODE 2" in port.out  # CUDA_ERROR_OUT_OF_MEMORY
    assert "REFUSAL_MSG tpushare: refusing allocation" in jax.out
    assert "tpushare: refusing allocation" in port.err, port.err


def test_alloc_policy_single_oversub_optin(sched, cuda_hook):
    (jax, port), _, _ = on_both(
        sched, cuda_hook, n=1, scenario="policy",
        env={"TPUSHARE_RESERVE_BYTES": "15GiB",
             "TPUSHARE_ENABLE_SINGLE_OVERSUB": "1"})
    for run in (jax, port):
        assert "POLICY_ALLOWED" in run.out and "POLICY_DONE" in run.out
        assert "TPUSHARE_ENABLE_SINGLE_OVERSUB=1, proceeding" in run.err


def test_copy_to_device_gated(sched, cuda_hook):
    # The driver uploads (taking the lock), idles 4 s so that the early
    # release hands the lock to the contender, then copies device to
    # device: the copy waits for the contender's release. On the port the
    # early release fences on the client's thread, which has no context
    # of its own (run_port checks the mock saw none missing).
    (jax, port), moved, released = on_both(
        sched, cuda_hook, peers=idle_taker(sched), n=1, scenario="c2d",
        env={"TPUSHARE_TEST_SLEEP_MS": "4000",
             "TPUSHARE_RELEASE_CHECK_S": "1"})
    for run, release_ms in zip((jax, port), released):
        assert run.events["C2D"] >= release_ms - 50, (run.out, release_ms)
        assert "C2D_DONE" in run.out
    assert moved[0] == moved[1], moved
    assert native.hook_report(port.err)["fences"] >= 1


def test_copy_policy_host_dst_exempt(sched, cuda_hook):
    # A ~0.9 GiB buffer against a ~1 GiB cap: a second device copy of it
    # is refused, the same bytes in host memory (the JAX package's
    # host-memory space, the port's pinned host allocations) are not.
    env = {"TPUSHARE_RESERVE_BYTES": "15GiB",
           "TPUSHARE_TEST_C2M_DIM": "15360"}
    jax = run_jax(sched.sock_dir, n=1, scenario="c2m", env=env)
    port = run_port(cuda_hook, sched.sock_dir, n=1, scenario="hostalloc",
                    env=env)
    outcome = [("SRC_OK" in jax.out, "C2D_REFUSED" in jax.out,
                "C2M_HOST_OK" in jax.out, "C2M_DONE" in jax.out),
               ("SRC_OK" in port.out, "DEV_REFUSED" in port.out,
                "HOST_OK" in port.out, "HOSTALLOC_DONE" in port.out)]
    assert outcome[0] == outcome[1] == (True,) * 4, (jax.out, port.out)


@pytest.mark.parametrize("no_onready", [False, True],
                         ids=["stuck_execution", "never_ready_event"])
def test_one_stuck_execution_does_not_stall_every_fence(sched, cuda_hook,
                                                        no_onready):
    # Only the first launch is wedged. Each stuck unit of work gets one
    # full fence budget (3 s) in all; later fences retry ~1 s instead of
    # paying the budget again (>= 15 s). The JAX package's second case
    # takes its polling fallback (no OnReady); CUDA events are always
    # polled, so the port runs the same case again. On a CUDA stream the
    # launches after the wedged one are stuck behind it; the bound holds.
    env = {"TPUSHARE_FENCE_TIMEOUT_MS": "3000", "TPUSHARE_MOCK_WEDGE_NTH": "0"}
    if no_onready:
        env["TPUSHARE_MOCK_NO_ONREADY"] = "1"
    (jax, port), _, _ = on_both(sched, cuda_hook, n=5, timeout=45, env=env)
    for run in (jax, port):
        assert "DONE" in run.events and len(run.events["EXEC"]) == 5
        assert "fence timed out" in run.err, run.err
        assert run.wall < 12, (run.wall, run.out)
        if not no_onready:
            assert run.wall >= 3, (run.wall, run.out)


# -- the port's own cases -----------------------------------------------------

@pytest.mark.parametrize("route,stream", [
    ("getproc", "legacy"), ("dlsym", "legacy"), ("dlsym225", "legacy"),
    ("getproc", "ptsz"), ("dlsym", "ptsz"), ("getproc", "created")])
def test_each_route_is_gated(sched, cuda_hook, route, stream):
    """The CUDA 12 runtime's route (``cuGetProcAddress_v2`` on the symbol
    that ``dlsym`` gave), ``dlsym`` of each symbol at GLIBC_2.34 and at
    GLIBC_2.2.5, the per-thread-default-stream variants (``_ptsz`` /
    ``_v2_ptds``) and a created stream: each waits for a contender's
    release at its first gated call, and the hook counts every launch."""
    done = holder(sched, hold_s=3.0)()
    run = run_port(cuda_hook, sched.sock_dir, n=3,
                   env={"TPUSHARE_TEST_RESOLVE": route,
                        "TPUSHARE_TEST_STREAM": stream})
    release_ms = done()
    assert run.events["CLIENT"] < release_ms, run.out
    assert run.events["H2D"] >= release_ms - 50, run.out
    report = native.hook_report(run.err)
    assert (report["launches"], report["copies"]) == (3, 2), report
    ptsz = 3 if stream == "ptsz" else 0
    assert f"MOCK launches=3 ptsz={ptsz} " in run.out, run.out


@pytest.mark.parametrize("route", ["getproc", "dlsym"])
def test_unwrapped_symbol_resolves_to_the_driver(sched, cuda_hook, route):
    run = run_port(cuda_hook, sched.sock_dir, n=1, scenario="passthru",
                   env={"TPUSHARE_TEST_RESOLVE": route})
    for name, same in (("cuCtxGetCurrent", 1), ("cuEventQuery", 1),
                       ("cuLaunchKernel", 0), ("cuGetProcAddress", 0)):
        assert f"RESOLVED {name} same={same}" in run.out, run.out
    assert "PASSTHRU_DONE" in run.out


def test_untracked_allocation_routes_fail_loudly(sched, cuda_hook):
    run = run_port(cuda_hook, sched.sock_dir, n=1, scenario="untracked")
    for line in ("ALLOC_ASYNC 801", "MEM_CREATE 801", "MANAGED 801"):
        assert line in run.out, run.out  # CUDA_ERROR_NOT_SUPPORTED
    for route in ("cuMemAllocAsync", "cuMemCreate", "cuMemAllocManaged"):
        assert f"tpushare: {route} is an allocation route" in run.err
    assert native.hook_report(run.err)["refused"] == 3


def test_cvmem_is_refused(sched, cuda_hook):
    run = run_port(cuda_hook, sched.sock_dir, n=1, rc=3,
                   env={"TPUSHARE_CVMEM": "1"})
    assert "INIT_FAILED 801" in run.out, run.out
    assert "TPUSHARE_CVMEM=1 (paging under the hook) is not implemented" \
        in run.err


def test_capturing_launch_is_not_gated(sched, cuda_hook):
    """A launch on a capturing stream executes nothing, so it passes the
    gate while a contender holds the lock; the graph's launch waits."""
    done = holder(sched, hold_s=3.0)()
    run = run_port(cuda_hook, sched.sock_dir, n=1, scenario="capture")
    release_ms = done()
    captured = int(run.out.split("CAPTURED ")[1].split()[0])
    graph = int(run.out.split("GRAPH ")[1].split()[0])
    assert captured < release_ms <= graph + 50, (run.out, release_ms)
    assert "MOCK launches=1 ptsz=0 captured=1 graphs=1" in run.out
    assert native.hook_report(run.err)["launches"] == 1


def test_window_grows_to_its_cap_and_counts(sched, cuda_hook):
    """Fast launches double the window from 1 (fences after launches 1,
    3, 7, 15, ...): 3000 launches fence 11 times and reach the 2048 cap,
    the reference's bound for kernels."""
    run = run_port(cuda_hook, sched.sock_dir, n=3000, timeout=120)
    report = native.hook_report(run.err)
    assert report["launches"] == 3000
    assert report["window_max"] == 2048
    assert report["fences"] == 11, report
    assert report["callers"] == {native.TEST_DRIVER_NAME: 3000}
