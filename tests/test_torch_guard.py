"""The port's multi-process guard against the JAX package's.

A table of world size x ``TPUSHARE_GANG_ID`` x
``TPUSHARE_FORCE_MULTIHOST`` must give the same gating decision from
``nvshare_tpu_torch.parallel.guard.multihost_guard`` (world size from
``$WORLD_SIZE``, as ``torchrun`` sets it before any process group
exists) as from ``nvshare_tpu.parallel.guard.multihost_guard`` (whose
distributed state is monkeypatched to the same process count), and
neither may initialise a backend.
"""

import itertools

import pytest
import torch.distributed as dist

from nvshare_tpu.parallel import guard as ref_guard
from nvshare_tpu_torch import interpose
from nvshare_tpu_torch.parallel import guard, multihost_guard

CASES = list(itertools.product((1, 2, 4), (None, "gang-a"), (None, "1")))


@pytest.mark.parametrize("world,gang,force", CASES)
def test_decision_matches_reference(world, gang, force, monkeypatch):
    from jax._src import distributed

    monkeypatch.setenv("WORLD_SIZE", str(world))
    for var, val in (("TPUSHARE_GANG_ID", gang),
                     ("TPUSHARE_FORCE_MULTIHOST", force)):
        if val is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, val)
    monkeypatch.setattr(distributed.global_state, "num_processes", world)
    want = ref_guard.multihost_guard()
    assert multihost_guard() == want
    assert want == (world == 1 or gang is not None or force == "1")
    assert not dist.is_initialized()


def test_world_size_without_any_backend(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert guard.world_size() == 1
    monkeypatch.setenv("WORLD_SIZE", "8")
    assert guard.world_size() == 8
    assert not dist.is_initialized()


def test_enable_stays_unmanaged_when_the_guard_refuses(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("TPUSHARE_GANG_ID", raising=False)
    monkeypatch.delenv("TPUSHARE_FORCE_MULTIHOST", raising=False)
    interpose.enable(device="cpu")
    try:
        assert not interpose.enabled()
    finally:
        interpose.disable()
