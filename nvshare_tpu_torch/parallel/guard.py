"""Multi-process interaction guard: the port of
``nvshare_tpu/parallel/guard.py``.

A per-host FCFS device lock composed with a multi-process program is a
deadlock machine: host A's tenant can hold A's card while blocked in a
collective that needs host B's card, whose scheduler gave the lock to a
different tenant. tpushare detects the situation and refuses to gate
unless explicitly forced.

The JAX package reads the process count from JAX's distributed service;
here the world size comes from ``torch.distributed`` when a process group
exists, and otherwise from ``$WORLD_SIZE``, which ``torchrun`` sets before
the program calls ``init_process_group``. Neither initialises a backend:
the guard runs at import time (``nvshare_tpu_torch.autoload``).
"""

from __future__ import annotations

import os

from nvshare_tpu_torch.utils import get_logger

log = get_logger("guard")


def world_size() -> int:
    """The number of processes of this program (1 when it is not a
    distributed run), read without initialising any backend."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    try:
        return max(1, int(os.environ.get("WORLD_SIZE", "1")))
    except ValueError:
        return 1


def multihost_guard() -> bool:
    """True: gating is safe (a single process). False: a multi-process
    run was detected, and the caller must stay unmanaged (free-run).

    ``TPUSHARE_GANG_ID`` (the per-host schedulers grant the whole gang
    together) and ``TPUSHARE_FORCE_MULTIHOST=1`` (for operators who
    schedule whole multi-process jobs as one gang) allow it.
    """
    n = world_size()
    if n <= 1:
        return True
    if os.environ.get("TPUSHARE_GANG_ID"):
        log.info(
            "multi-process PyTorch (%d processes) gated as gang '%s': the "
            "per-host schedulers escalate to the gang coordinator so every "
            "host's lock is granted in the same global round.", n,
            os.environ["TPUSHARE_GANG_ID"])
        return True
    if os.environ.get("TPUSHARE_FORCE_MULTIHOST") == "1":
        log.warning(
            "multi-process PyTorch (%d processes) with forced gating — "
            "ensure all hosts' locks are granted as a gang or collectives "
            "may deadlock", n)
        return True
    log.warning(
        "multi-process PyTorch detected (%d processes): tpushare gating "
        "disabled for safety (a per-host device lock can deadlock "
        "cross-host collectives). Set TPUSHARE_FORCE_MULTIHOST=1 to "
        "override.", n)
    return False
