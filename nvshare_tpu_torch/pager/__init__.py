"""Proactive pager: background writeback + scheduler-coordinated on-deck
prefetch, the port of ``nvshare_tpu/pager``.

Public surface:

  * :class:`Pager` / :func:`maybe_attach_pager` — the engine and the
    env-gated ($TPUSHARE_PAGER=1) wiring helper;
  * :func:`client_callbacks` — the callback set a client runtime is built
    with, the pager's or the arena's synchronous hooks;
  * :func:`pager_enabled` / :func:`first_touch_enabled` — the gates the
    wiring layers consult;
  * :mod:`~nvshare_tpu_torch.pager.policy` — the ordering policies
    ($TPUSHARE_PAGER_POLICY=lru|lfu|wss).
"""

from nvshare_tpu_torch.pager.engine import (  # noqa: F401
    Pager,
    client_callbacks,
    first_touch_enabled,
    maybe_attach_pager,
    pager_enabled,
)
from nvshare_tpu_torch.pager.policy import (  # noqa: F401
    LFUPolicy,
    LRUPolicy,
    PagerPolicy,
    WSSPolicy,
    make_policy,
)
