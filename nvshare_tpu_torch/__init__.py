"""nvshare_tpu_torch — tpushare on PyTorch and CUDA (NVIDIA Hopper).

The second package of the repository, beside the JAX package
``nvshare_tpu``, which stays the reference. It speaks the same wire
protocol to the same ``tpushare-scheduler`` and keeps the same paging
semantics and telemetry names; its hot ops are CUDA C++ kernels written
for ``sm_90a`` (``csrc/``), each with a plain PyTorch version beside it.

This package never imports ``jax`` or ``nvshare_tpu``: it keeps its own
copies of the jax-free modules it needs (protocol, client runtimes, QoS
declarations, chaos faults, telemetry, env config, logging).

Public surface:
  * :mod:`nvshare_tpu_torch.device` — explicit device resolution
    (``cuda`` unless the caller asks for ``cpu``; never a silent fallback).
  * :mod:`nvshare_tpu_torch.vmem` — virtual device memory: residency
    tracking, LRU paging to pinned host shadows, handoff evict/prefetch;
    ``vop`` over nested dicts, lists and tuples of managed arrays.
  * :mod:`nvshare_tpu_torch.interpose` — the device-lock gate.
  * :mod:`nvshare_tpu_torch.colocate` — in-process multi-tenant harness
    (burner, LM serving and LM training workloads).
  * :mod:`nvshare_tpu_torch.models.burner` — the co-location burners.
  * :mod:`nvshare_tpu_torch.models.transformer` and
    :mod:`nvshare_tpu_torch.models.decode` — the transformer LM's scoring
    forward, KV-cache decoding and training step.
  * :mod:`nvshare_tpu_torch.ops` — ``fused_mix``, ``tiled_matmul`` and
    flash attention forward and backward (CUDA kernels on the card, plain
    PyTorch on the CPU), and ``rope_rotate``.
  * :mod:`nvshare_tpu_torch.convert` — carry numpy state (arrays, LM
    parameters, KV caches, training state) across.
  * :mod:`nvshare_tpu_torch.runtime.client` — the native client
    (``libtpushare_client.so`` over ctypes) and the pure-Python one,
    :func:`~nvshare_tpu_torch.runtime.client.make_client` picking;
    :mod:`nvshare_tpu_torch.runtime.chaos` — ``$TPUSHARE_CHAOS`` faults.
  * :mod:`nvshare_tpu_torch.qos` — ``TPUSHARE_QOS=class:weight``
    declarations and the achieved-vs-entitled report.
  * :mod:`nvshare_tpu_torch.telemetry` — metrics registry, event ring,
    Prometheus and Chrome-trace exporters, the fleet plane, ``dump`` and
    ``top``.
  * :mod:`nvshare_tpu_torch.bench_tenant` — one burner tenant in its own
    process.
"""

__version__ = "0.1.0"
