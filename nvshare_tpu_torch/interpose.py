"""Gating of device work on the tpushare device lock.

The port of ``nvshare_tpu/interpose.py``. Work reaches the gate
(:func:`gate`, which blocks until this process — or, inside a
:class:`tenant_context`, this tenant — holds the lock, ≙ the reference's
``continue_with_lock``, client.c:73-106) by two ways:

  * managed computations (:func:`nvshare_tpu_torch.vmem.vop`, device-born
    arrays) call it themselves, inside a :class:`critical_section`;
  * an unmodified program is gated by :func:`enable` (one line:
    ``import nvshare_tpu_torch.autoload``). PyTorch has no single choke
    point like JAX's ``ExecuteReplicated.__call__``, so ``enable``
    installs a ``TorchDispatchMode`` that sees every aten op: each op
    that reads, writes or creates a tensor on the gated device is gated
    before it runs (≙ gating ``cuLaunchKernel`` and ``cuMemcpy*``,
    hook.c:766-971), its completion is recorded for the handoff fence
    and the adaptive window afterwards (≙ hook.c:782-838), and it is
    counted in ``tpushare_gated_executions_total``.

The port's CUDA kernels launch through ctypes, which dispatch never sees,
so each kernel wrapper runs as one gated unit (:func:`launch_unit`):
gated once, its allocations and launch inside a critical section, its
completion recorded after the launch.

What the gate reaches. A dispatch mode belongs to one thread. ``enable``
enters it on the calling thread; the autograd engine carries it onto the
threads that run a backward (they take the caller's thread-local state);
and while the gate is on, a ``threading.Thread`` started from a gated
thread outside a critical section enters it too. It does not reach
threads started before ``enable`` or by native code, nor graphs compiled
by ``torch.compile``, whose Triton kernels launch without aten dispatch.
The port's own threads (the client's message and release threads, the
pager's) are started by the client's bootstrap inside a critical section
and never carry it: they hand the lock back, and gating them would wait
on the lock they are returning.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)

from nvshare_tpu_torch.device import DeviceLike, resolve_device
from nvshare_tpu_torch.utils import get_logger

log = get_logger("interpose")

_lock = threading.Lock()
_client = None
_enabled = False
_device = None  # the gated device (enable's); None until enabled: cuda
_saved = {}


def _exec_counter():
    """tpushare_gated_executions_total{client} — fetched per call (not
    cached at import) so a test-reset registry is re-wired transparently;
    the registry's get-or-create makes this one dict lookup."""
    from nvshare_tpu_torch import telemetry

    return telemetry.registry().counter(
        "tpushare_gated_executions_total",
        "compiled-program executions routed through the device-lock gate",
        ["client"])


def client():
    """The process's client runtime, wired to the process arena's
    fence/evict/prefetch hooks. Created on first use (registration blocks
    on the scheduler, ≙ reference client.c:196)."""
    global _client
    with _lock:
        if _client is None:
            # The bootstrap runs torch ops and starts the port's threads;
            # neither may be gated (see the module docstring).
            with critical_section():
                from nvshare_tpu_torch import vmem
                from nvshare_tpu_torch.pager import (
                    client_callbacks,
                    maybe_attach_pager,
                )
                from nvshare_tpu_torch.runtime.client import make_client

                a = vmem.arena(_device)
                # $TPUSHARE_PAGER=1: the proactive pager takes over the
                # handoff policy; its threads start only at bind_client,
                # after registration.
                pager = maybe_attach_pager(a)
                _client = make_client(**client_callbacks(a, pager))
                if pager is not None:
                    pager.bind_client(_client)
        return _client


_tl = threading.local()


class critical_section:
    """Marks a paging/submit critical section on this thread: nested gate()
    calls become no-ops, and the dispatch mode passes ops straight
    through, so work submitted while the arena lock is held never re-gates
    (a concurrent DROP_LOCK eviction needs that lock)."""

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

    return vmem.arena(_device)


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


# -- unmodified programs: the dispatch-mode gate ------------------------------

def _on_device(dev: torch.device, args, kwargs) -> bool:
    """Does an op with these arguments read, write or create a tensor on
    ``dev``? Tensors among the arguments (and one level into lists, as
    ``cat`` takes them), tensors among the keyword arguments (``out=``),
    and a factory op's ``device=``."""
    for x in args:
        if isinstance(x, torch.Tensor):
            if x.device == dev:
                return True
        elif isinstance(x, (list, tuple)):
            for y in x:
                if isinstance(y, torch.Tensor) and y.device == dev:
                    return True
    for key, x in kwargs.items():
        if isinstance(x, torch.Tensor):
            if x.device == dev:
                return True
        elif key == "device" and x is not None and torch.device(x) == dev:
            return True
    return False


def _submitted(work: bool) -> None:
    """Bookkeeping after a gated op or kernel unit, in the reference's
    order (nvshare_tpu/interpose.py:176-181): its completion event for
    the handoff fence (``work``: the op may have queued device work; a
    view queues none), the adaptive window, and telemetry LAST, so a
    metrics failure never skips the fence or the window."""
    try:
        with critical_section():
            a = current_arena()
            if work:
                with a._lock:
                    a._record_pending()
            a.after_submit()
            _exec_counter().labels(client=a.name).inc()
    except Exception:  # never break the app over bookkeeping
        log.debug("post-execute bookkeeping failed", exc_info=True)


class _GateMode(TorchDispatchMode):
    """The gate over aten dispatch; one instance per thread it runs on
    (a mode keeps per-instance state while it is entered)."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = device

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (not _enabled or getattr(_tl, "in_critical", False)
                or not _on_device(self.device, args, kwargs)):
            return func(*args, **kwargs)
        gate()
        out = func(*args, **kwargs)
        _submitted(not func.is_view)
        return out


def _carries_gate() -> bool:
    """Is this thread's work gated by the mode right now?"""
    if not _enabled or getattr(_tl, "in_critical", False):
        return False
    return any(isinstance(m, _GateMode)
               for m in _get_current_dispatch_mode_stack())


@contextlib.contextmanager
def launch_unit(device: torch.device):
    """One gated unit of a kernel wrapper on a tensor of ``device``: when
    this thread's ops are gated (:func:`enable`), gate once, run the body
    (allocation and launch) in a critical section, then record its
    completion, AFTER the launch, so a DROP_LOCK fence covers the kernel.
    Inside a :func:`~nvshare_tpu_torch.vmem.vop` (already a critical
    section) or without the gate, the body runs as it is. Yields whether
    the unit was gated."""
    if device != _device or not _carries_gate():
        yield False
        return
    gate()
    with critical_section():
        _tl.in_unit = True
        try:
            yield True
        finally:
            _tl.in_unit = False
    _submitted(True)


def in_gated_unit() -> bool:
    """Is this thread inside the body of a gated :func:`launch_unit`?"""
    return getattr(_tl, "in_unit", False)


def _start_gated(self) -> None:
    """``threading.Thread.start`` while the gate is on: a thread started
    from a gated thread, outside a critical section, runs under its own
    instance of the mode."""
    if _carries_gate():
        run, dev = self.run, _device

        def run_gated():
            with _GateMode(dev):
                run()

        self.run = run_gated
    _saved["start"](self)


def enable(device: DeviceLike = None) -> None:
    """Gate this program's device ops on the scheduler's lock. Idempotent.

    ``device`` is resolved as every entry point resolves it (``cuda``
    unless the caller asks for ``cpu``; raises without a card). Refuses
    to gate a multi-process run (a per-host device lock can deadlock its
    collectives) unless ``TPUSHARE_GANG_ID`` or
    ``TPUSHARE_FORCE_MULTIHOST=1`` allow it; it then stays unmanaged, and
    the guard has logged why.
    """
    global _enabled, _device
    dev = resolve_device(device)
    with _lock:
        if _enabled:
            return
        from nvshare_tpu_torch.parallel.guard import multihost_guard

        if not multihost_guard():
            return
        _device = dev
        if getattr(_tl, "mode", None) is None:
            _tl.mode = _GateMode(dev)
            _tl.mode.__enter__()
        else:  # re-enabled on the thread whose mode disable() left inert
            _tl.mode.device = dev
        _saved["start"] = threading.Thread.start
        threading.Thread.start = _start_gated
        _enabled = True
        log.info("PyTorch dispatch interposition enabled on %s", dev)


def disable() -> None:
    """Stop gating. Idempotent. Every thread's mode turns inert at once;
    the calling thread's leaves its dispatch stack when it is on top."""
    global _enabled, _device
    with _lock:
        if not _enabled:
            return
        _enabled = False
        _device = None
        threading.Thread.start = _saved["start"]
        mode = getattr(_tl, "mode", None)
        stack = _get_current_dispatch_mode_stack()
        if mode is not None and stack and stack[-1] is mode:
            mode.__exit__(None, None, None)
            _tl.mode = None
        log.info("PyTorch dispatch interposition disabled")


def enabled() -> bool:
    return _enabled


def _reset_client_for_tests() -> None:
    global _client
    with _lock:
        old, _client = _client, None
    if old is not None:
        try:
            old.shutdown()
        except Exception:
            pass
