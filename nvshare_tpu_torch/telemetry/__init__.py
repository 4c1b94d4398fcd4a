"""tpushare telemetry: metrics registry, event-ring tracing, exporters.

The port's copy of the JAX package's stdlib-only telemetry: the metric
names, event kinds and wire encodings are the same, so tooling that reads
one package's output reads the other's. Three layers:

  * **registry** — thread-safe counters/gauges/histograms with labels
    (``tpushare_page_faults_total{client="job-a"}``), process-global via
    :func:`registry`;
  * **event ring** — fixed-size trace buffer (:func:`record`,
    :data:`events.KINDS`: LOCK_ACQUIRE/RELEASE, DROP_LOCK, FAULT, EVICT,
    PREFETCH, HANDOFF, OOM_RETRY) with negligible hot-path cost;
  * **exporters** — Prometheus text over HTTP/textfile
    (:func:`start_http_server`, :func:`write_textfile`) and Chrome
    ``trace_event`` JSON (:func:`export_chrome_trace`) for Perfetto
    timelines.

Wired through VirtualHBM paging, the client runtimes' lock transitions,
the interposer's gate, and the scheduler STATS plane
(``python -m nvshare_tpu_torch.telemetry.dump``). See docs/TELEMETRY.md
(the JAX package's, whose formats these are).
"""

from nvshare_tpu_torch.telemetry import events  # noqa: F401
from nvshare_tpu_torch.telemetry.chrome_trace import (  # noqa: F401
    build_trace,
    export_chrome_trace,
    lock_spans,
    spans_overlap,
)
from nvshare_tpu_torch.telemetry.events import (  # noqa: F401
    EventRing,
    record,
    reset_ring,
    ring,
)
from nvshare_tpu_torch.telemetry.fleet import (  # noqa: F401
    FleetCollector,
    FleetStreamer,
    fetch_fleet_stats,
    fleet_enabled,
    fleet_to_registry,
    handoff_summaries,
    maybe_start_streamer,
    merge_trace,
    occupancy_shares,
)
from nvshare_tpu_torch.telemetry.prometheus import (  # noqa: F401
    MetricsServer,
    maybe_start_from_env,
    render_text,
    start_http_server,
    write_textfile,
)
from nvshare_tpu_torch.telemetry.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    registry,
    reset_registry,
)
