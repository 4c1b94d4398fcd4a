"""The port's chaos layer (``nvshare_tpu_torch.runtime.chaos``) against the
JAX package's: the spec grammar, the seeded fault schedule of one
``ChaosSocket`` (the same frames dropped, frame for frame), the wrap of
every ``SchedulerLink`` under ``$TPUSHARE_CHAOS``, and two port scripted
tenants under deterministic frame loss against the real scheduler.
"""

import socket

import pytest

from nvshare_tpu.runtime import chaos as ref_chaos
from nvshare_tpu_torch.runtime import chaos as port_chaos
from nvshare_tpu_torch.runtime.protocol import FRAME_SIZE


@pytest.mark.parametrize("spec", [
    "", "drop:0.1,delay:5,trunc:0.01,seed:7", "drop:0.04,seed:11",
    " drop:0.5 , ", "trunc:1.0", "drop:1.5", "bogus:1", "drop:x",
    "seed:3"])
def test_config_parse_matches_reference(spec):
    def parse(mod):
        try:
            c = mod.ChaosConfig.parse(spec)
        except ValueError:
            return "ValueError"
        return (c.drop_p, c.delay_ms, c.trunc_p, c.seed, c.active)

    assert parse(port_chaos) == parse(ref_chaos)


def _schedule(mod, config, ordinal, frames=200):
    """Indices of dropped and truncated frames, and the final stats."""
    a, b = socket.socketpair()
    b.setblocking(False)
    try:
        cs = mod.ChaosSocket(a, config, ordinal=ordinal)
        dropped, cut = [], []
        for i in range(frames):
            before = dict(cs.stats)
            cs.sendall(bytes([i % 251]) * 16)
            if cs.stats["dropped"] > before["dropped"]:
                dropped.append(i)
            if cs.stats["truncated"] > before["truncated"]:
                cut.append(i)
            try:
                b.recv(1 << 16)
            except BlockingIOError:
                pass
        return dropped, cut, cs.stats
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("spec,ordinal", [
    ("drop:0.04,seed:11", 0), ("drop:0.04,seed:11", 1),
    ("drop:0.3,seed:9", 0), ("drop:0.1,trunc:0.1,seed:5", 3)])
def test_fault_schedule_matches_reference(spec, ordinal):
    got = _schedule(port_chaos, port_chaos.ChaosConfig.parse(spec), ordinal)
    want = _schedule(ref_chaos, ref_chaos.ChaosConfig.parse(spec), ordinal)
    assert got == want
    assert got[0], "the schedule dropped nothing"


def test_process_stats_count_every_link(monkeypatch, tmp_path):
    """``process_stats`` (the port's addition, for a run's report) sums
    the per-link stats over every link the process wrapped."""
    before = port_chaos.process_stats()
    cfg = port_chaos.ChaosConfig.parse("drop:0.3,seed:9")
    stats = [_schedule(port_chaos, cfg, o, frames=50)[2] for o in (0, 1)]
    after = port_chaos.process_stats()
    assert after["links"] - before["links"] == 2
    for key in ("sent", "dropped", "truncated", "delayed"):
        assert after[key] - before[key] == sum(s[key] for s in stats)


def test_scheduler_link_is_wrapped_under_chaos_env(monkeypatch, sched):
    """$TPUSHARE_CHAOS, formerly refused, wraps the link's socket as the
    JAX package does; unset, the socket is the plain one. A truncated
    registration frame makes the scheduler drop the connection."""
    from nvshare_tpu_torch.runtime.protocol import SchedulerLink

    monkeypatch.delenv("TPUSHARE_CHAOS", raising=False)
    with SchedulerLink(path=sched.path, job_name="clean") as link:
        assert isinstance(link.sock, socket.socket)
        link.register()
    monkeypatch.setenv("TPUSHARE_CHAOS", "trunc:1.0,seed:3")
    with SchedulerLink(path=sched.path, job_name="cut") as link:
        assert isinstance(link.sock, port_chaos.ChaosSocket)
        with pytest.raises((OSError, ConnectionError, ValueError)):
            link.register()
        assert link.sock.stats["truncated"] == 1
    assert FRAME_SIZE == 304


def test_scripted_tenants_hold_alone_and_progress_under_frame_loss(
        tmp_path, monkeypatch, native_build):
    """Two port scripted tenants under ``drop:0.04`` (the reference chaos
    soak's schedule) with the gate retry and the lease absorbing lost
    frames: both make progress and their audited hold windows never
    overlap."""
    from tests.conftest import SchedulerProc

    s = SchedulerProc(tmp_path, tq_sec=1,
                      extra_env={"TPUSHARE_REVOKE_GRACE_S": "1"})
    monkeypatch.setenv("TPUSHARE_SOCK_DIR", s.sock_dir)
    env = {"TPUSHARE_CHAOS": "drop:0.04,seed:11",
           "TPUSHARE_RECONNECT": "1", "TPUSHARE_RECONNECT_S": "1",
           "TPUSHARE_REQ_RETRY_S": "0.5", "TPUSHARE_RELEASE_CHECK_S": "1"}
    logs = {n: tmp_path / f"{n}.log" for n in ("pa", "pb")}
    procs = {n: port_chaos.spawn_tenant(n, logs[n], seconds=4.0, env=env)
             for n in logs}
    try:
        for p in procs.values():
            assert p.wait(timeout=60) == 0
        ticks = {n: port_chaos.count_ticks(p) for n, p in logs.items()}
        assert all(t > 10 for t in ticks.values()), ticks
        a_ev, b_ev = (port_chaos.read_progress(logs[n]) for n in logs)
        assert port_chaos.hold_windows(a_ev) and \
            port_chaos.hold_windows(b_ev)
        assert not port_chaos.windows_overlap(
            port_chaos.hold_windows(a_ev), port_chaos.hold_windows(b_ev))
        assert ref_chaos.read_progress(logs["pa"]) == a_ev
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        s.stop()
