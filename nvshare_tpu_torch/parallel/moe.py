"""Expert parallelism: a mixture-of-experts FFN sharded over a mesh axis
with static-shape capacity routing (the Switch/GShard recipe), the port of
``nvshare_tpu/parallel/moe.py``.

* Top-1 routing with a FIXED per-expert capacity: dispatch and combine
  are one-hot products over static shapes. ``argmax`` takes the first
  maximum, a token's place in its expert's queue is a cumsum over the
  tokens (priority by position), and a token past the capacity is
  dropped: its output is zero (the caller adds the residual).
* Experts live sharded over the axis (each rank computes E/n expert
  FFNs); tokens reach their expert's rank and come back through two
  all-to-alls.
* The expert FFN computes bf16 x bf16 products with f32 results, as the
  JAX ``preferred_element_type=f32`` einsums do, through
  :func:`~nvshare_tpu_torch.models.transformer._matmul_f32` one expert at
  a time (PyTorch's bf16 ``bmm`` would round its result to bf16).

A deviation from the reference, on purpose: :func:`moe_ffn_ep` and
:func:`moe_ffn_sharded` raise a ``ValueError`` when the experts do not
divide over the axis, where the JAX layer fails later, inside its
all-to-all.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from nvshare_tpu_torch.device import DeviceLike, resolve_device
from nvshare_tpu_torch.device import generator as _seeded
from nvshare_tpu_torch.models.transformer import _matmul_f32
from nvshare_tpu_torch.parallel.collectives import (
    Mesh,
    all_to_all,
    gather,
    pmean,
    psum_grad,
    shard,
)

_CDT = torch.bfloat16


def init_moe_params(n_experts: int, d_model: int, d_hidden: int,
                    generator: Optional[torch.Generator] = None,
                    seed: int = 0, device: DeviceLike = None) -> dict:
    """Router + per-expert FFN stacks: ``router`` [D, E], ``w_up`` [E, D,
    H], ``w_down`` [E, H, D], f32 normal with std ``fan_in ** -0.5``, drawn
    on ``device`` (default ``cuda``) from ``generator`` (default: one
    seeded with ``seed``). The bits differ from ``jax.random``'s; state
    shared with the JAX package travels through ``convert``."""
    if generator is None:
        generator = _seeded(resolve_device(device), seed)
    dev = generator.device

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return w.mul_((1.0 / fan_in) ** 0.5)

    return {"router": normal((d_model, n_experts), d_model),
            "w_up": normal((n_experts, d_model, d_hidden), d_model),
            "w_down": normal((n_experts, d_hidden, d_model), d_hidden)}


def _route_top1(params: dict, x: torch.Tensor, n_experts: int,
                capacity: int):
    """Top-1 routing with capacity: (dispatch [T, E, C] one-hot, combine
    [T, E, C] gate-weighted, aux scalar), for tokens x [T, D]."""
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)                    # [T, E]
    expert = torch.argmax(probs, dim=-1)                     # first max
    onehot = F.one_hot(expert, n_experts).float()            # [T, E]
    gate = (probs * onehot).sum(dim=-1)                      # [T]
    # Position of each token in its expert's queue (0-based).
    pos = (torch.cumsum(onehot, dim=0) * onehot - onehot).sum(dim=-1)
    pos = pos.to(torch.int64)
    keep = pos < capacity                                    # drop past C
    onehot = onehot * keep[:, None].float()
    # jax.nn.one_hot of an index past the end is all zeros.
    pos_oh = (pos[:, None] == torch.arange(capacity, device=x.device)
              ).float()                                      # [T, C]
    dispatch = onehot[:, :, None] * pos_oh[:, None, :]
    combine = dispatch * gate[:, None, None]
    # Switch load balancing: E * sum_e fraction_e * mean_prob_e.
    frac = onehot.mean(dim=0)
    mean_p = probs.mean(dim=0)
    aux = (frac * mean_p).sum() * n_experts
    return dispatch, combine, aux


def _expert_ffn(w_up: torch.Tensor, w_down: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """x [E_local, C_total, D] through each local expert's gelu FFN: bf16
    products with f32 results, tanh gelu (``jax.nn.gelu``'s default)."""
    outs = []
    for e in range(x.shape[0]):
        h = _matmul_f32(x[e].to(_CDT), w_up[e].to(_CDT))
        h = F.gelu(h, approximate="tanh")
        outs.append(_matmul_f32(h.to(_CDT), w_down[e].to(_CDT)))
    return torch.stack(outs)


def _capacity(capacity_factor: float, tokens: int, n_experts: int) -> int:
    return int(math.ceil(capacity_factor * tokens / n_experts))


def moe_ffn_reference(params: dict, x: torch.Tensor, n_experts: int,
                      capacity_factor: float = 1.25):
    """Single-device MoE forward (the exactness oracle): tokens [T, D] ->
    (out [T, D] in x's dtype, aux). Dropped tokens give zero."""
    capacity = _capacity(capacity_factor, x.shape[0], n_experts)
    dispatch, combine, aux = _route_top1(params, x, n_experts, capacity)
    xin = torch.einsum("tec,td->ecd", dispatch, x.float())
    yout = _expert_ffn(params["w_up"], params["w_down"], xin)
    out = torch.einsum("tec,ecd->td", combine, yout)
    return out.to(x.dtype), aux


def _check_divisible(n_experts: int, n: int, axis: str) -> None:
    if n_experts % n:
        raise ValueError(f"{n_experts} experts do not divide over the {n} "
                         f"ranks of axis '{axis}' (experts % ranks must be "
                         "0: the all-to-all shards experts evenly)")


def moe_ffn_ep(params: dict, x: torch.Tensor, *, mesh: Mesh, axis: str,
               n_experts: int, capacity_factor: float = 1.25):
    """Expert-parallel MoE forward inside a rank: x is this rank's token
    shard [T/n, D]; params are replicated, but this rank computes only
    its E/n experts, after an all-to-all. Routing is per shard, with the
    capacity sized to the shard: the result equals ``moe_ffn_reference``
    applied to each shard alone. Returns (out [T/n, D], aux [1], this
    shard's)."""
    n = mesh.axis_size(axis)
    _check_divisible(n_experts, n, axis)
    capacity = _capacity(capacity_factor, x.shape[0], n_experts)
    dispatch, combine, aux = _route_top1(params, x, n_experts, capacity)
    xin = torch.einsum("tec,td->ecd", dispatch, x.float())   # [E, C, D]
    # Experts to their home ranks, every shard's queue for ours:
    # [E, C, D] -> [E/n, n*C, D].
    xin = all_to_all(xin, mesh, axis, split_dim=0, concat_dim=1)
    per = n_experts // n
    e_lo = mesh.axis_index(axis) * per
    yout = _expert_ffn(params["w_up"][e_lo:e_lo + per],
                       params["w_down"][e_lo:e_lo + per], xin)
    # Results back: [E/n, n*C, D] -> [E, C, D].
    yout = all_to_all(yout, mesh, axis, split_dim=1, concat_dim=0)
    out = torch.einsum("tec,ecd->td", combine, yout)
    return out.to(x.dtype), aux.reshape(1)


def moe_ffn_sharded(mesh: Mesh, n_experts: int, *, axis: str = "ep",
                    capacity_factor: float = 1.25):
    """Expert-parallel MoE over ``mesh`` on whole tensors: ``fn(params,
    x)`` takes all tokens [T, D] and the replicated params on every rank,
    and returns (out [T, D], the shards' mean aux), the same on every
    rank. Differentiable as the JAX function is: a loss every rank
    computes alike gets whole gradients of the params and x."""
    _check_divisible(n_experts, mesh.axis_size(axis), axis)

    def fn(params: dict, x: torch.Tensor):
        params = {k: psum_grad(v, mesh, axis) for k, v in params.items()}
        out, aux = moe_ffn_ep(params, shard(x, mesh, axis, 0), mesh=mesh,
                              axis=axis, n_experts=n_experts,
                              capacity_factor=capacity_factor)
        return gather(out, mesh, axis, 0), pmean(aux, mesh, axis)[0]

    return fn
