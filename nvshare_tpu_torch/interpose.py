"""Gating of device work on the tpushare device lock.

The port of the gate half of ``nvshare_tpu/interpose.py``: every managed
computation (:func:`nvshare_tpu_torch.vmem.vop`, device-born arrays) calls
:func:`gate` first, which blocks until this process — or, inside a
:class:`tenant_context`, this tenant — holds the lock (≙ the reference's
``continue_with_lock``, client.c:73-106).

The JAX package can also interpose unmodified programs at one choke point
(``enable()``); PyTorch has no such point, and gating process tenants
through a ``TorchDispatchMode`` is not ported yet.
"""

from __future__ import annotations

import threading

from nvshare_tpu_torch.utils import get_logger

log = get_logger("interpose")

_lock = threading.Lock()
_client = None


def client():
    """The process's client runtime, wired to the process arena's
    fence/evict/prefetch hooks. Created on first use (registration blocks
    on the scheduler, ≙ reference client.c:196)."""
    global _client
    with _lock:
        if _client is None:
            from nvshare_tpu_torch import vmem
            from nvshare_tpu_torch.pager import client_callbacks
            from nvshare_tpu_torch.runtime.client import make_client

            _client = make_client(**client_callbacks(vmem.arena()))
        return _client


_tl = threading.local()


class critical_section:
    """Marks a paging/submit critical section on this thread: nested gate()
    calls become no-ops, so work submitted while the arena lock is held
    never re-gates (a concurrent DROP_LOCK eviction needs that lock)."""

    def __enter__(self):
        self._prev = getattr(_tl, "in_critical", False)
        _tl.in_critical = True
        return self

    def __exit__(self, *exc):
        _tl.in_critical = self._prev


class tenant_context:
    """Route gating AND arena bookkeeping on this thread through a
    specific tenant (in-process multi-tenant mode,
    :mod:`nvshare_tpu_torch.colocate`)."""

    def __init__(self, tenant_client, tenant_arena=None):
        self._client = tenant_client
        self._arena = tenant_arena

    def __enter__(self):
        self._prev = (getattr(_tl, "client_override", None),
                      getattr(_tl, "arena_override", None))
        _tl.client_override = self._client
        _tl.arena_override = self._arena
        return self

    def __exit__(self, *exc):
        _tl.client_override, _tl.arena_override = self._prev


def current_arena():
    """The arena gated work on this thread accounts against: the tenant's
    (inside a tenant_context) or the process singleton."""
    override = getattr(_tl, "arena_override", None)
    if override is not None:
        return override
    from nvshare_tpu_torch import vmem

    return vmem.arena()


def gate() -> None:
    """Block until this process (or tenant) may use the device. No-op
    when unmanaged or inside a critical section."""
    if getattr(_tl, "in_critical", False):
        return
    override = getattr(_tl, "client_override", None)
    if override is not None:
        override.continue_with_lock()
        return
    client().continue_with_lock()
