"""A process tenant's handoff eviction gives its memory back to the card.

PyTorch's caching allocator belongs to one process: blocks a handoff
eviction frees stay reserved on the card for that process, where a peer
PROCESS granted the lock cannot allocate them. The process's own arena
(``vmem.arena()``, the one ``interpose.client()`` wires) therefore
releases them after the writebacks (``_release_to_device``); the arenas
of in-process ``colocate.Tenant``s share one allocator and do not. On
the CPU the release has no cache to empty, so the test reads that it was
reached, and where: the process tenant and a ``colocate.Tenant`` take
turns under a 1 s quantum, and only the process arena's handoffs
release.
"""

import threading
import time

import numpy as np

from nvshare_tpu_torch import interpose, vmem
from nvshare_tpu_torch.colocate import Tenant


def test_process_arena_releases_on_handoff_and_tenant_arena_does_not(
        fast_sched, monkeypatch):
    monkeypatch.setenv("TPUSHARE_SOCK_DIR", fast_sched.sock_dir)
    monkeypatch.setenv("TPUSHARE_PURE_PYTHON", "1")
    monkeypatch.setenv("TPUSHARE_REQUIRE_SCHEDULER", "1")
    monkeypatch.setenv("TPUSHARE_RESERVE_BYTES", "0")
    released = []
    orig = vmem.VirtualHBM._release_to_device

    def spy(self):
        released.append(self.name)
        orig(self)

    monkeypatch.setattr(vmem.VirtualHBM, "_release_to_device", spy)
    vmem.reset_arena()
    interpose._reset_client_for_tests()
    proc_arena = vmem.arena("cpu")
    tenant = Tenant("release-peer", device="cpu", budget_bytes=64 << 20)
    bump = vmem.vop(lambda x: x * 1.0001 + 1.0, donate_argnums=0)

    def work(arena, steps):
        # ~2.5 s of lock-held work each: several 1 s quanta apiece.
        va = arena.array(np.ones((128, 128), np.float32))
        for _ in range(steps):
            va = bump(va)
            time.sleep(0.005)
        return steps, float(va.numpy()[0, 0])

    try:
        out = {}
        peer = threading.Thread(
            target=lambda: out.setdefault(
                "peer", tenant.run(lambda t: work(t.arena, 400))))
        interpose.client()           # register the process tenant first
        peer.start()
        out["proc"] = work(proc_arena, 400)
        interpose.client().release_now()
        peer.join(timeout=60)
        assert not peer.is_alive()
        peer_drops = int(tenant.client._m["drops"].value)
    finally:
        tenant.close()
        interpose._reset_client_for_tests()
        vmem.reset_arena()
    err = fast_sched.stop()
    assert "DROP_LOCK" in err, err
    assert proc_arena.release_on_handoff and not \
        tenant.arena.release_on_handoff
    assert proc_arena.stats["handoff_evicts"] > 0
    assert proc_arena.device_releases >= 1
    assert peer_drops >= 1 and tenant.arena.stats["handoff_evicts"] > 0
    assert tenant.arena.device_releases == 0
    assert set(released) == {proc_arena.name}, released
    assert out["proc"] == out["peer"]   # paging changed no bit
