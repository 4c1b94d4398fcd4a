"""Carry state across from numpy into the port.

The JAX package's arenas generate working sets with ``jax.random``, whose
bits no PyTorch generator reproduces. State that both packages must share
(the parity tests' working sets, a checkpoint) travels as numpy arrays,
which :func:`varrays_from_numpy` adopts as one arena's managed arrays
(``VArray.numpy`` reads them back).
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np

from nvshare_tpu_torch import vmem


def varrays_from_numpy(arrays: Iterable[np.ndarray],
                       arena: vmem.VirtualHBM) -> List[vmem.VArray]:
    """Adopt each numpy array as a host-resident :class:`VArray` of
    ``arena`` (copied into shadows the arena owns; paged in on first
    use)."""
    return [arena.array(np.asarray(x)) for x in arrays]
