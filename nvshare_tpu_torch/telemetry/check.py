"""Telemetry self-check: boot the exporter on an ephemeral port and
assert /metrics serves a non-empty exposition.

``python -m nvshare_tpu_torch.telemetry.check`` — the tier-1-safe
smoke that proves the registry → exposition → HTTP path works with
nothing but the stdlib (no scheduler, no device work, no network beyond
loopback). Exits 0 on success.
"""

from __future__ import annotations

import sys
import urllib.request

from nvshare_tpu_torch.telemetry import (
    record,
    registry,
    render_text,
    ring,
    start_http_server,
)
from nvshare_tpu_torch.telemetry import events as ev


def selfcheck(verbose: bool = True) -> int:
    reg = registry()
    reg.counter("tpushare_selfcheck_total",
                "telemetry self-check runs", ["client"]).labels(
                    client="check").inc()
    reg.histogram("tpushare_selfcheck_seconds",
                  "self-check latency histogram").observe(0.001)
    record(ev.LOCK_ACQUIRE, "check")
    record(ev.LOCK_RELEASE, "check")
    srv = start_http_server(port=0)
    try:
        with urllib.request.urlopen(srv.url, timeout=10) as resp:
            body = resp.read().decode()
            ctype = resp.headers.get("Content-Type", "")
        assert resp.status == 200
        assert body.strip(), "/metrics served an empty exposition"
        assert "text/plain" in ctype, f"bad content type {ctype!r}"
        assert "tpushare_selfcheck_total" in body, body[:400]
        assert 'client="check"' in body, body[:400]
        assert "tpushare_selfcheck_seconds_bucket" in body, body[:400]
        # The offline path must agree with the served one.
        assert "tpushare_selfcheck_total" in render_text(reg)
        assert len(ring()) >= 2
    finally:
        srv.close()
    if verbose:
        print(f"telemetry-check OK: {srv.url} served "
              f"{len(body.splitlines())} exposition lines")
    return 0


if __name__ == "__main__":
    sys.exit(selfcheck())
