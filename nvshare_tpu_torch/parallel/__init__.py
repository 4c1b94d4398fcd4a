"""Multi-process interaction guard (the port of ``nvshare_tpu/parallel``).

For now only :func:`multihost_guard`: a per-host device lock composed
with a multi-process program can deadlock its collectives, so gating is
refused there unless forced. The mesh, ring attention, MoE, sequence and
pipeline parallel steps of the JAX package are not ported yet.
"""

from nvshare_tpu_torch.parallel.guard import multihost_guard  # noqa: F401
