"""Handoff wiring between an arena and a client runtime.

Only :func:`client_callbacks` is ported: the arena's four synchronous
hooks, the JAX package's pager-less path (``pager/engine.py``). The
proactive pager (async writeback, on-deck prefetch) comes later.
"""


def client_callbacks(arena) -> dict:
    """The callback set a client runtime is built with — the one wiring
    site shared by :func:`nvshare_tpu_torch.interpose.client` and
    :class:`nvshare_tpu_torch.colocate.Tenant`."""
    return dict(
        sync_and_evict=arena.sync_and_evict_all,
        prefetch=arena.prefetch_hot,
        busy_probe=arena.busy_probe,
        timed_sync_ms=arena.timed_sync_ms,
    )
