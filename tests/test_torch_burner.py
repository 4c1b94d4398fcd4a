"""The slice as a whole, solo: the port's burners against the JAX
package's on one seeded working set.

Both packages take the same numpy chunks (3 chunks of 256x256 f32, adopted
through ``nvshare_tpu_torch.convert`` on the port side) and run 3 steps
through ``vop`` under a budget smaller than the working set, with a full
handoff (evict everything, prefetch it back) after every step, as a
co-located tenant would see. The final chunks, the checksum and the paging
counters are compared.
"""

import numpy as np
import pytest

import nvshare_tpu.vmem as jvmem
import nvshare_tpu_torch.vmem as tvmem
from nvshare_tpu.models import burner as jburner
from nvshare_tpu_torch.models import burner as tburner

KB = 1 << 10
SIDE = 256
STEPS = 3


def chunks(seed=0, n=3):
    rng = np.random.RandomState(seed)
    return [rng.rand(SIDE, SIDE).astype(np.float32) for _ in range(n)]


def jax_burner(cls, arrays, arena):
    """The JAX burner over given chunks (its constructor only generates
    them on the device, so set up what __init__ would)."""
    b = cls.__new__(cls)
    b.arena = arena
    b.dtype = np.float32
    b.device_ratio = 0.9
    b.side = SIDE
    b.chunks = [arena.array(x) for x in arrays]
    b.wss_bytes = sum(c.nbytes for c in b.chunks)
    return b


def handoff(arena):
    def hook(_step):
        arena.sync_and_evict_all()
        arena.prefetch_hot()
    return hook


def run_both(kind, monkeypatch, pallas):
    monkeypatch.setenv("TPUSHARE_HBM_BYTES", str(512 * KB))  # < 768 KiB WSS
    monkeypatch.setenv("TPUSHARE_RESERVE_BYTES", "0")
    if pallas:
        monkeypatch.setenv("TPUSHARE_PALLAS_MATMUL", "1")
    else:
        monkeypatch.delenv("TPUSHARE_PALLAS_MATMUL", raising=False)
    arrays = chunks()
    out = {}
    for name, vm, mod in (("jax", jvmem, jburner), ("torch", tvmem, tburner)):
        vm.reset_arena()
        arena = vm.arena(device="cpu") if vm is tvmem else vm.arena()
        cls = getattr(mod, kind)
        b = (cls.from_numpy(arrays, arena) if vm is tvmem
             else jax_burner(cls, arrays, arena))
        res = b.run(STEPS, step_hook=handoff(arena))
        out[name] = (res, [c.numpy() for c in b.chunks], dict(arena.stats))
        vm.reset_arena()
    return out


# Per kind: the tolerance of the final chunks and checksum, and why.
CASES = [
    # Elementwise f32, same operation order; XLA may fuse a multiply-add
    # into one FMA, a last-place difference per step.
    ("AddBurner", False, 1e-6),
    ("MixBurner", False, 1e-6),
    # bf16 operands, f32 sums in another order: a last-place difference in
    # one step can move an element's bf16 rounding in the next (2^-8
    # relative on that element), diluted over the 256-term products.
    ("MatmulBurner", True, 2e-3),
    ("MatmulBurner", False, 2e-3),
]


@pytest.mark.parametrize("kind,pallas,rtol", CASES,
                         ids=["add", "mix", "matmul-kernel", "matmul-plain"])
def test_burner_matches_reference(kind, pallas, rtol, monkeypatch):
    out = run_both(kind, monkeypatch, pallas)
    (jres, jchunks, jstats), (tres, tchunks, tstats) = (out["jax"],
                                                        out["torch"])
    assert tres.passed and jres.passed
    assert tres.steps == jres.steps == STEPS
    for i, (t, j) in enumerate(zip(tchunks, jchunks)):
        np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * 1e-2,
                                   err_msg=f"chunk {i}")
    assert tres.checksum == pytest.approx(jres.checksum, rel=rtol)
    # Same paging decisions (the budget holds two of the three chunks, so
    # each prefetch brings two back and the step faults the third in).
    assert tstats == jstats
    assert tstats["handoff_evicts"] > 0 and tstats["prefetches"] > 0
    assert tstats["page_out"] > 0 and tstats["page_in"] > 0


def test_matmul_flops_and_shape_match_reference():
    arena = tvmem.VirtualHBM(device="cpu", budget_bytes=1 << 30)
    b = tburner.MatmulBurner.from_numpy(chunks(), arena)
    assert b.side == SIDE and len(b.chunks) == 3
    assert b.flops_per_step() == 3 * 2.0 * SIDE ** 3
    assert b.wss_bytes == 3 * SIDE * SIDE * 4
    arena.close()


def test_device_generated_chunks_follow_chunk_side():
    """The constructor's own path: chunks generated on the arena's device
    from seeded generators, sized as the JAX burner sizes them."""
    import torch

    arena = tvmem.VirtualHBM(device="cpu", budget_bytes=1 << 30)
    from nvshare_tpu_torch import interpose
    from nvshare_tpu_torch.runtime.client import PurePythonClient

    class _Unmanaged(PurePythonClient):
        def __init__(self):  # no registration: always allowed to run
            self.managed = False

        def continue_with_lock(self):
            pass

    with interpose.tenant_context(_Unmanaged(), arena):
        b = tburner.AddBurner(5 * 300 * 300 * 4, chunks=5, arena=arena)
        again = tburner.AddBurner(5 * 300 * 300 * 4, chunks=5, arena=arena)
    assert b.side == jburner._chunk_side(300 * 300 * 4, np.float32) == 256
    assert len(b.chunks) == 5
    assert torch.equal(b.chunks[2].host(), again.chunks[2].host())
    assert not torch.equal(b.chunks[0].host(), b.chunks[1].host())
    arena.close()
