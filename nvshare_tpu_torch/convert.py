"""Carry state across from numpy into the port.

The JAX package's arenas and models draw their state with ``jax.random``,
whose bits no PyTorch generator reproduces. State that both packages must
share (the parity tests' working sets and parameters, a checkpoint)
travels as numpy arrays: :func:`varrays_from_numpy` adopts them as one
arena's managed arrays (``VArray.numpy`` reads them back), and
:func:`transformer_params_from_numpy` and :func:`kv_cache_from_numpy` make
a language model's parameter and cache dicts of them.
"""

from __future__ import annotations

from typing import Iterable, List, Mapping

import numpy as np
import torch

from nvshare_tpu_torch import vmem
from nvshare_tpu_torch.device import DeviceLike, resolve_device


def varrays_from_numpy(arrays: Iterable[np.ndarray],
                       arena: vmem.VirtualHBM) -> List[vmem.VArray]:
    """Adopt each numpy array as a host-resident :class:`VArray` of
    ``arena`` (copied into shadows the arena owns; paged in on first
    use)."""
    return [arena.array(np.asarray(x)) for x in arrays]


def _tensors(arrays: Mapping[str, np.ndarray], dtype: torch.dtype,
             device: DeviceLike) -> dict:
    dev = resolve_device(device)
    # Through f32: numpy has no bfloat16 of its own, and a bf16 array read
    # from JAX widens to f32 exactly.
    return {name: torch.from_numpy(np.array(x, dtype=np.float32))
            .to(device=dev, dtype=dtype)
            for name, x in arrays.items()}


def transformer_params_from_numpy(params: Mapping[str, np.ndarray],
                                  device: DeviceLike = None) -> dict:
    """A :class:`~nvshare_tpu_torch.models.transformer.Transformer`
    parameter dict (f32 tensors on ``device``, default ``cuda``) from
    numpy arrays under the JAX package's names (``embed``, ``qkv{i}``,
    ``proj{i}``, ``up{i}``, ``down{i}``, ``ln1_{i}``, ``ln2_{i}``,
    ``ln_f``)."""
    return _tensors(params, torch.float32, device)


def kv_cache_from_numpy(cache: Mapping[str, np.ndarray],
                        device: DeviceLike = None) -> dict:
    """A KV-cache dict (``k{i}``/``v{i}`` bf16 tensors [B, L, H, Dh] on
    ``device``, default ``cuda``) from numpy arrays."""
    return _tensors(cache, torch.bfloat16, device)
