"""One process tenant: a burner on the process arena, gated through the
process's client runtime.

    python -m nvshare_tpu_torch.bench_tenant <name> <kind> <wss_bytes> \
        <steps> <chunks> <device_ratio> [--device cpu]

``kind`` is ``matmul``, ``add`` or ``mix`` (:mod:`models.burner`). The
tenant registers through :func:`nvshare_tpu_torch.interpose.client` —
the native runtime unless ``$TPUSHARE_PURE_PYTHON=1`` — wired to the
process arena (:func:`nvshare_tpu_torch.vmem.arena`), so every step
gates on the device lock and every handoff evicts and prefetches the
working set. ``$TPUSHARE_JOB_NAME`` defaults to ``<name>``, which labels
the arena, the client and a ``{job}`` metrics textfile path. The
exporters start from the environment (``$TPUSHARE_METRICS_PORT``,
``$TPUSHARE_METRICS_TEXTFILE``, the latter written at exit). At its end
the tenant drops its working set without writing it back and returns
the card memory before it hands the lock on: a process's device memory
is freed only when its CUDA context goes, after its connection's close
would already have granted a peer, whose page-in would then find the
card still full.

Prints ``<name> RESULT <json>``: walls, the burner's checksum, the client
class, the arena's paging counters, the chaos link's fault counts, the
client's REQ_LOCK re-sends, the kernel wrappers' launch counts, and the
arena's handoffs, the releases of their freed blocks to the card and the
most device memory the process still reserved after one. Exits 1 when
the checksum is not finite.
The port's counterpart of the JAX package's ``tools/bench_tenant.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nvshare_tpu_torch.bench_tenant",
        description="One burner tenant in its own process.")
    ap.add_argument("name")
    ap.add_argument("kind", choices=("matmul", "add", "mix"))
    ap.add_argument("wss_bytes", type=int)
    ap.add_argument("steps", type=int)
    ap.add_argument("chunks", type=int)
    ap.add_argument("device_ratio", type=float)
    ap.add_argument("--device", default=None,
                    help="the arena's device (default cuda)")
    args = ap.parse_args(argv)
    os.environ.setdefault("TPUSHARE_JOB_NAME", args.name)

    import torch

    from nvshare_tpu_torch import interpose, telemetry, vmem
    from nvshare_tpu_torch.models.burner import (
        AddBurner,
        MatmulBurner,
        MixBurner,
    )
    from nvshare_tpu_torch.ops import fused_mix, tiled_matmul
    from nvshare_tpu_torch.runtime import chaos

    telemetry.maybe_start_from_env()
    t_start = time.time()
    arena = vmem.arena(args.device)
    client = interpose.client()
    cls = {"matmul": MatmulBurner, "add": AddBurner,
           "mix": MixBurner}[args.kind]
    burner = cls(args.wss_bytes, chunks=args.chunks, arena=arena,
                 device_ratio=args.device_ratio)
    t_begin = time.time()
    res = burner.run(args.steps,
                     step_hook=lambda _s: client.mark_activity())
    t_end = time.time()
    # Drop the working set (no writeback) and return its memory before
    # the lock goes on (see the module docstring).
    arena.close()
    if arena.cuda:
        torch.cuda.empty_cache()
    client.release_now()
    result = {
        "name": args.name, "kind": args.kind, "ok": res.passed,
        "wall_s": round(t_end - t_start, 3),
        "run_s": round(t_end - t_begin, 3),
        "t_begin": round(t_begin, 3), "t_end": round(t_end, 3),
        "chunks": args.chunks, "steps": args.steps,
        "checksum": res.checksum, "device_s": round(res.device_s, 3),
        "client": type(client).__name__,
        "managed": bool(client.managed),
        "paging": arena.telemetry_snapshot(),
        "chaos": chaos.process_stats(),
        "req_resends": getattr(client, "req_resends", None),
        "launches": {"fused_mix": fused_mix.launches.value,
                     "tiled_matmul": tiled_matmul.launches.value},
        "handoffs": arena._handoff_seq,
        "releases": arena.device_releases,
        "reserved_after_release": arena.reserved_after_release,
    }
    print(f"{args.name} RESULT {json.dumps(result)}", flush=True)
    return 0 if res.passed else 1


if __name__ == "__main__":
    sys.exit(main())
