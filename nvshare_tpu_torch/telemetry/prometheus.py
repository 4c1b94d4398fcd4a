"""Prometheus text exposition for the telemetry registry.

Two transports, both stdlib-only:

  * :func:`start_http_server` — a tiny ``http.server`` thread serving
    ``GET /metrics`` (text/plain; version=0.0.4), for live scrapes and
    the ``python -m nvshare_tpu_torch.telemetry.check`` smoke;
  * :func:`write_textfile` — an atomic snapshot file for the node-exporter
    textfile collector (batch jobs that exit before any scrape lands).

Enable the server transparently in any tenant with
``TPUSHARE_METRICS_PORT=<port>`` (0 picks an ephemeral port and logs it);
``TPUSHARE_METRICS_ADDR`` overrides the bind address (default loopback;
set 0.0.0.0 for in-cluster Prometheus scrapes of a pod IP).
``TPUSHARE_METRICS_TEXTFILE=<path>`` arms an atexit snapshot; ``{pid}``
and ``{job}`` in the path expand per process, so several co-located
tenant processes sharing one environment each keep their own snapshot
instead of clobbering a single file (node-exporter globs ``*.prom``).
"""

from __future__ import annotations

import math
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from nvshare_tpu_torch.telemetry.registry import (
    HistogramChild,
    Registry,
    registry,
)
from nvshare_tpu_torch.utils.log import get_logger

log = get_logger("telemetry")

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_label_value(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _fmt_labels(names, values, extra: Optional[dict] = None) -> str:
    parts = [f'{n}="{_escape_label_value(str(v))}"'
             for n, v in zip(names, values)]
    if extra:
        parts += [f'{n}="{_escape_label_value(str(v))}"'
                  for n, v in extra.items()]
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 2**53 else repr(f)


def render_text(reg: Optional[Registry] = None) -> str:
    """The full exposition, one HELP/TYPE header per family."""
    reg = reg if reg is not None else registry()
    lines = []
    for fam in sorted(reg.collect(), key=lambda f: f.name):
        if fam.help:
            lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for key, child in sorted(fam.samples()):
            if isinstance(child, HistogramChild):
                hsum, hcount, buckets = child.snapshot_state()
                for ub, cum in buckets:
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_fmt_labels(fam.labelnames, key, {'le': _fmt_value(ub)})}"
                        f" {cum}")
                labels = _fmt_labels(fam.labelnames, key)
                lines.append(f"{fam.name}_sum{labels} "
                             f"{_fmt_value(hsum)}")
                lines.append(f"{fam.name}_count{labels} {hcount}")
            else:
                lines.append(f"{fam.name}"
                             f"{_fmt_labels(fam.labelnames, key)} "
                             f"{_fmt_value(child.value)}")
    return "\n".join(lines) + "\n"


def write_textfile(path: str, reg: Optional[Registry] = None) -> None:
    """Atomic exposition snapshot (write-rename), the textfile-collector
    contract: a scraper never sees a half-written file."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(render_text(reg))
    os.replace(tmp, path)


class _MetricsHandler(BaseHTTPRequestHandler):
    reg: Optional[Registry] = None  # set per-server subclass

    def do_GET(self):  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        if path in ("/metrics", "/"):
            try:
                body = render_text(self.reg).encode()
                code, ctype = 200, CONTENT_TYPE
            except Exception as e:  # surface, don't kill the server thread
                body = f"# exposition failed: {e}\n".encode()
                code, ctype = 500, "text/plain"
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif path == "/healthz":
            self.send_response(200)
            self.send_header("Content-Length", "3")
            self.end_headers()
            self.wfile.write(b"ok\n")
        else:
            self.send_error(404)

    def log_message(self, fmt, *args):  # quiet: scrapes are periodic
        log.debug("metrics http: " + fmt, *args)


class MetricsServer:
    """A running /metrics endpoint. ``port`` is the bound port (useful
    with port=0)."""

    def __init__(self, port: int = 0, addr: str = "127.0.0.1",
                 reg: Optional[Registry] = None):
        handler = type("_BoundHandler", (_MetricsHandler,),
                       {"reg": reg if reg is not None else registry()})
        self._httpd = ThreadingHTTPServer((addr, port), handler)
        self._httpd.daemon_threads = True
        self.addr = addr
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="tpushare-metrics")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.addr}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def start_http_server(port: int = 0, addr: str = "127.0.0.1",
                      reg: Optional[Registry] = None) -> MetricsServer:
    srv = MetricsServer(port=port, addr=addr, reg=reg)
    log.info("metrics exporter listening on %s", srv.url)
    return srv


_auto_server: Optional[MetricsServer] = None
_auto_lock = threading.Lock()


def _expand_textfile_path(path: str) -> str:
    """``{pid}``/``{job}`` placeholders -> this process's values, so
    N processes sharing one TPUSHARE_METRICS_TEXTFILE setting write N
    files instead of last-exit-wins clobbering one (the node-exporter
    textfile collector reads every ``*.prom`` in its directory)."""
    if "{" not in path:
        return path
    from nvshare_tpu_torch.runtime.protocol import default_job_name

    return path.replace("{pid}", str(os.getpid())).replace(
        "{job}", default_job_name())


def maybe_start_from_env() -> Optional[MetricsServer]:
    """Honor $TPUSHARE_METRICS_PORT / $TPUSHARE_METRICS_ADDR /
    $TPUSHARE_METRICS_TEXTFILE once. Called from the wiring points
    (arena/client creation) so any tenant — bench subprocess, notebook,
    interposed job — can opt in without code changes. Idempotent;
    returns the server if one is (already) up."""
    global _auto_server
    with _auto_lock:
        textfile = os.environ.get("TPUSHARE_METRICS_TEXTFILE")
        if textfile and not getattr(maybe_start_from_env, "_armed", False):
            maybe_start_from_env._armed = True
            import atexit

            atexit.register(_write_textfile_best_effort,
                            _expand_textfile_path(textfile))
        port = os.environ.get("TPUSHARE_METRICS_PORT")
        if _auto_server is not None or port is None:
            return _auto_server
        addr = os.environ.get("TPUSHARE_METRICS_ADDR", "127.0.0.1")
        try:
            _auto_server = start_http_server(port=int(port), addr=addr)
        except Exception as e:
            log.warning("metrics exporter failed to start: %s", e)
        return _auto_server


def _write_textfile_best_effort(path: str) -> None:
    try:
        write_textfile(path)
    except Exception as e:
        log.warning("metrics textfile snapshot failed: %s", e)
