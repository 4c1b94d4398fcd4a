"""QoS arbitration subsystem (client side).

Tenants declare a latency class + entitlement weight
(``TPUSHARE_QOS=class:weight``, e.g. ``interactive:2`` / ``batch:1``) at
REGISTER time; the scheduler's pluggable WFQ policy turns the weights
into occupancy shares and the classes into target latencies + bounded
preemption. Unset keeps the byte-for-byte reference FIFO wire exchange.

* :mod:`nvshare_tpu_torch.qos.spec` — the spec parser/validator/encoder shared
  by ``colocate.Tenant``, both client runtimes, and ``interpose``.
* :mod:`nvshare_tpu_torch.qos.report` — replay a fleet trace into
  achieved-vs-entitled shares and per-class gate-wait percentiles.

Scheduler-side design: docs/SCHEDULING.md (the scheduler is shared
with the JAX package).
"""

from nvshare_tpu_torch.qos.spec import (  # noqa: F401
    CLASS_IDS,
    ENV,
    QosSpec,
    coerce,
    entitled_shares,
    from_env,
    parse_qos,
)
