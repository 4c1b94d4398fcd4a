"""tpushare telemetry for the port: the metrics registry and the event
ring (copies of the JAX package's stdlib-only modules).

The metric names and event kinds are the JAX package's, so tooling that
reads one package's snapshot reads the other's. The exporters (Prometheus
text over HTTP, Chrome trace) are not part of the port yet: the
``$TPUSHARE_METRICS_*`` variables that would start them are refused.
"""

from nvshare_tpu_torch.telemetry import events  # noqa: F401
from nvshare_tpu_torch.telemetry.events import (  # noqa: F401
    EventRing,
    record,
    reset_ring,
    ring,
)
from nvshare_tpu_torch.telemetry.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    registry,
    reset_registry,
)
from nvshare_tpu_torch.utils.config import refuse_env


def refuse_exporters() -> None:
    """Raise if the environment asks for an exporter the port lacks
    (called where the JAX package would start one: arena and client
    creation)."""
    for name in ("TPUSHARE_METRICS_PORT", "TPUSHARE_METRICS_TEXTFILE"):
        refuse_env(name, "the metrics exporter")
