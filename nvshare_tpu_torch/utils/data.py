"""Input pipeline: host→device prefetch, the port of
``nvshare_tpu/utils/data.py``.

Keep the next batches' host-to-device copies in flight while the current
step computes, so the device never idles on input. On a shared card this
matters twice: transfer time under tpushare is also lock-held time, and
an input-starved tenant holds the quantum for nothing.

JAX's ``device_put`` is asynchronous by itself, so the reference's deque
of in-flight batches is the whole pipeline. Here each batch is staged
into pinned host buffers and copied with ``non_blocking`` copies on a side
CUDA stream; the consuming stream waits on the copy's event before it
reads the batch. No thread is needed either.
"""

from __future__ import annotations

import collections
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from nvshare_tpu_torch.device import DeviceLike, resolve_device
from nvshare_tpu_torch.vmem import _tree_map


def prefetch_to_device(batches: Iterable[Any], size: int = 2,
                       device: DeviceLike = None) -> Iterator[Any]:
    """Yield batches with ``size`` host-to-device copies kept in flight.

    ``batches``: any iterable of nested dicts, lists and tuples of numpy
    arrays or CPU tensors. ``device``: where they land (default ``cuda``;
    on ``cpu`` the pipeline is the plain deque of tensors).
    """
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    dev = resolve_device(device)
    it = iter(batches)
    queue: collections.deque = collections.deque()
    cuda = dev.type == "cuda"
    side = torch.cuda.Stream(device=dev) if cuda else None

    def host(x) -> torch.Tensor:
        t = torch.from_numpy(np.asarray(x)) if not isinstance(
            x, torch.Tensor) else x
        return t.pin_memory() if cuda else t

    def enqueue(n: int) -> None:
        for _ in range(n):
            try:
                batch = next(it)
            except StopIteration:
                return
            staged = _tree_map(host, batch)
            if not cuda:
                queue.append((staged, None))
                continue
            # The pinned source stays reserved until its copy is done
            # (the host allocator records the copy's stream).
            with torch.cuda.stream(side):
                out = _tree_map(
                    lambda t: t.to(dev, non_blocking=True), staged)
                done = torch.cuda.Event()
                done.record(side)
            queue.append((out, done))

    enqueue(size)
    while queue:
        out, done = queue.popleft()
        if done is not None:
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(done)
            # Allocated on the side stream, used on this one: the caching
            # allocator must not hand the blocks out again before this
            # stream is done with them.
            _tree_map(lambda t: t.record_stream(cur), out)
        enqueue(1)  # refill BEFORE the caller computes on `out`
        yield out


def synthetic_token_batches(model, batch: int, n_batches: int,
                            seed: int = 0) -> Iterator[np.ndarray]:
    """Host-side batch stream of the ramp corpus (one fresh batch per
    step), the reference's bit for bit, for feeding
    :func:`prefetch_to_device`."""
    from nvshare_tpu_torch.models.transformer import synthetic_tokens

    for i in range(n_batches):
        yield synthetic_tokens(model, batch, seed=seed * 100003 + i)
