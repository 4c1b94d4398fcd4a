"""Carry state across from numpy into the port.

The JAX package's arenas and models draw their state with ``jax.random``,
whose bits no PyTorch generator reproduces. State that both packages must
share (the parity tests' working sets and parameters, a checkpoint)
travels as numpy arrays: :func:`varrays_from_numpy` adopts them as one
arena's managed arrays (``VArray.numpy`` reads them back), and
:func:`transformer_params_from_numpy`, :func:`kv_cache_from_numpy` and
:func:`lm_state_from_numpy` make a language model's parameter, cache and
training-state dicts of them, :func:`mlp_params_from_numpy` an MLP's
parameters, :func:`moe_lm_state_from_numpy` the MoE LM's nested training
state, and :func:`pipeline_params_from_numpy` one rank's slice of stacked
pipeline-stage parameters.
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


def lm_state_from_numpy(params: Mapping[str, np.ndarray],
                        opt_state: Mapping[str, Mapping[str, np.ndarray]],
                        device: DeviceLike = None) -> tuple[dict, dict]:
    """A training state ``(params, {"m": momentum})`` of f32 tensors on
    ``device`` (default ``cuda``) from the numpy leaves of a JAX
    ``init_lm_state`` pair (or of any later step's state)."""
    return (transformer_params_from_numpy(params, device),
            {"m": _tensors(opt_state["m"], torch.float32, device)})


def mlp_params_from_numpy(params: Mapping[str, np.ndarray],
                          device: DeviceLike = None) -> dict:
    """An :class:`~nvshare_tpu_torch.models.mlp.MLP` parameter dict (f32
    tensors on ``device``, default ``cuda``) from numpy arrays under the
    JAX package's names (``w{i}``, ``b{i}``)."""
    return _tensors(params, torch.float32, device)


def _nested(tree: Mapping, dtype: torch.dtype, device: DeviceLike) -> dict:
    return {k: (_nested(v, dtype, device) if isinstance(v, Mapping)
                else _tensors({k: v}, dtype, device)[k])
            for k, v in tree.items()}


def moe_lm_state_from_numpy(params: Mapping, opt_state: Mapping,
                            device: DeviceLike = None) -> tuple[dict, dict]:
    """A :class:`~nvshare_tpu_torch.models.moe_transformer.MoETransformer`
    training state ``(params, {"m": momentum})`` of f32 tensors on
    ``device`` (default ``cuda``) from the numpy leaves of a JAX
    ``init_moe_lm_state`` pair: the dense names plus the nested ``moe{i}``
    dicts of ``router``, ``w_up`` and ``w_down``."""
    return (_nested(params, torch.float32, device),
            {"m": _nested(opt_state["m"], torch.float32, device)})


def pipeline_params_from_numpy(params: Mapping[str, np.ndarray], rank: int,
                               device: DeviceLike = None) -> dict:
    """Rank ``rank``'s slice [1, ...] of stacked stage parameters [S, ...]
    (f32 tensors on ``device``, default ``cuda``): the local view a
    pipeline rank holds, as the JAX step's ``P(axis)`` shard."""
    return _tensors({k: np.asarray(v)[rank:rank + 1]
                     for k, v in params.items()}, torch.float32, device)
