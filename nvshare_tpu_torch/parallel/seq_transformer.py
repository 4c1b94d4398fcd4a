"""Sequence-parallel transformer LM training over a mesh: the port of
``nvshare_tpu/parallel/seq_transformer.py``.

Activations are sharded along the sequence axis (every rank holds [B,
S/n, ...] of every layer), parameters are replicated, and attention, the
only op that mixes positions, runs as ring attention or Ulysses. Inputs
and targets are shifted GLOBALLY (``tokens[:, :-1]`` and ``tokens[:,
1:]``) before each rank takes its block, so the one-token halo between
blocks needs no exchange.

Gradients follow the JAX note on psum inside a gradient: each rank
differentiates only its LOCAL, unreduced loss (the only collectives the
autograd graph holds are the attention's ppermutes and all-to-alls, and
the MoE's all-to-alls); the gradients and the loss are then summed with
ONE explicit all-reduce outside autograd, over one flat buffer, and
divided by ``n * targets.numel()``. The update is the shared momentum SGD,
or a ``torch.optim`` optimizer over the replicated parameters (the
counterpart of the JAX step's optax ``tx``).

A deviation from the reference, on purpose: ``lr`` defaults to ``None``,
and an explicit ``lr`` beside an optimizer is refused (the JAX step's
sentinel, ``lr != 1e-2``, lets ``lr=1e-2`` through with a ``tx``).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import set_checkpoint_early_stop

from nvshare_tpu_torch.models.transformer import (
    Transformer,
    init_lm_state,
    sgd_momentum_update,
    synthetic_tokens,
    transformer_forward,
)
from nvshare_tpu_torch.parallel.collectives import Mesh, all_reduce_sum
from nvshare_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ulysses_attention,
)

_LR = 1e-2  # the built-in momentum SGD's rate when none is given


def _seq_attn_fn(attn: str, mesh: Mesh, axis: str, rope: bool = False):
    """The sequence-parallel attention of the dense and MoE steps ("ring"
    or "ulysses"), with RoPE at GLOBAL positions ``rank * blk +
    arange(blk)`` for a rope model (rotation before the ring or the
    all-to-all, as on one device). Fails fast on a bad name."""
    try:
        base = {"ring": ring_attention,
                "ulysses": ulysses_attention}[attn]
    except KeyError:
        raise ValueError(f"unknown sequence-parallel attention {attn!r}"
                         " (want 'ring' or 'ulysses')") from None
    base = partial(base, mesh=mesh, axis=axis, causal=True)
    if not rope:
        return base

    def with_rope(q, k, v):
        from nvshare_tpu_torch.ops.rope import rope_rotate

        blk = q.shape[1]
        pos = mesh.axis_index(axis) * blk + torch.arange(blk,
                                                          device=q.device)
        return base(rope_rotate(q, pos), rope_rotate(k, pos), v)

    return with_rope


def _local_block(mesh: Mesh, tokens: torch.Tensor, axis: str,
                 batch_axis: Optional[str]):
    """This rank's (inputs, targets) blocks of the globally shifted
    tokens [B, S+1]: the sequence over ``axis``, the batch over
    ``batch_axis``."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    s = inputs.shape[1]
    if s % n:
        raise ValueError(f"sequence {s} does not shard over {n} ranks")
    cols = slice(i * (s // n), (i + 1) * (s // n))
    rows = slice(None)
    if batch_axis is not None:
        nb, ib = mesh.axis_size(batch_axis), mesh.axis_index(batch_axis)
        b = inputs.shape[0]
        if b % nb:
            raise ValueError(f"batch {b} does not shard over {nb} ranks")
        rows = slice(ib * (b // nb), (ib + 1) * (b // nb))
    return inputs[rows, cols], targets[rows, cols]


def _local_lm_nll(params: dict, model: Transformer, inputs, targets, *,
                  mesh: Mesh, axis: str, attn: str) -> torch.Tensor:
    """Summed (not averaged) next-token NLL of this rank's block, with no
    collective beyond the attention's (see the module docstring)."""
    logits = transformer_forward(
        params, model, inputs,
        attn_fn=_seq_attn_fn(attn, mesh, axis,
                             rope=getattr(model, "rope", False)))
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long().unsqueeze(-1)).sum()


def _reduce(mesh: Mesh, axes, loss: torch.Tensor, grads: list,
            denom: float) -> torch.Tensor:
    """Sum the loss and the gradients over ``axes`` in one all-reduce,
    then divide both by ``denom``; returns the loss."""
    packed = [g.contiguous() for g in grads] + [loss.detach().reshape(1)]
    all_reduce_sum(mesh, axes, packed)
    for g in packed:
        g.div_(denom)
    grads[:] = packed[:-1]
    return packed[-1][0]


def seq_sharded_lm_step(mesh: Mesh, model: Transformer, *,
                        axis: str = "seq", attn: str = "ring",
                        lr: Optional[float] = None,
                        optimizer: Optional[torch.optim.Optimizer] = None,
                        batch_axis: Optional[str] = None):
    """A sequence-parallel LM train step over ``mesh``.

    Returns ``step(params, opt_state, tokens) -> (params, opt_state,
    loss)``: tokens are the GLOBAL [B, S+1] (the same on every rank, S
    divisible by the axis), params and the momentum replicated and updated
    in place; the loss is the global token mean, the same on every rank.
    ``attn``: "ring" or "ulysses" (heads % ranks == 0). The same math as
    the single-device ``lm_train_step``.

    ``batch_axis``: a second mesh axis to shard the batch over (dp x sp):
    attention collectives stay within a sequence row, the gradient sum
    spans both axes.

    ``optimizer``: a ``torch.optim`` optimizer over the parameter tensors
    (``requires_grad`` leaves) replacing the built-in momentum SGD; it
    steps on the summed gradients, and ``opt_state`` passes through
    untouched. ``lr`` belongs to the built-in SGD (default 1e-2): an
    explicit ``lr`` with an optimizer is refused.
    """
    if optimizer is not None and lr is not None:
        raise ValueError("lr applies to the built-in momentum SGD only; "
                         "with an optimizer, set the learning rate in it")
    rate = _LR if lr is None else lr
    _seq_attn_fn(attn, mesh, axis)            # fail fast on a bad name
    axes = (axis,) if batch_axis is None else (batch_axis, axis)
    n = mesh.axis_size(axes)

    def step(params: dict, opt_state: dict, tokens: torch.Tensor):
        inputs, targets = _local_block(mesh, tokens, axis, batch_axis)
        with torch.enable_grad(), set_checkpoint_early_stop(False):
            leaves = {k: p.detach().requires_grad_()
                      for k, p in params.items()}
            nll = _local_lm_nll(leaves, model, inputs, targets, mesh=mesh,
                                axis=axis, attn=attn)
            grads = list(torch.autograd.grad(nll, list(leaves.values())))
        loss = _reduce(mesh, axes, nll, grads, float(n * targets.numel()))
        if optimizer is None:
            sgd_momentum_update(params, opt_state,
                                dict(zip(leaves, grads)), rate)
        else:
            for p, g in zip(params.values(), grads):
                p.grad = g
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
        return params, opt_state, loss

    return step


def dp_seq_sharded_lm_step(mesh: Mesh, model: Transformer, *,
                           batch_axis: str = "data", axis: str = "seq",
                           attn: str = "ring", lr: Optional[float] = None,
                           optimizer: Optional[torch.optim.Optimizer] = None):
    """2D data x sequence parallelism in one LM step: each rank holds a
    (batch block, sequence block) tile of the tokens. A thin alias of
    :func:`seq_sharded_lm_step` with ``batch_axis`` set."""
    return seq_sharded_lm_step(mesh, model, axis=axis, attn=attn, lr=lr,
                               optimizer=optimizer, batch_axis=batch_axis)


def seq_sharded_moe_lm_step(mesh: Mesh, model, *, axis: str = "seq",
                            attn: str = "ring", lr: float = _LR):
    """Sequence-parallel + expert-parallel MoE LM train step: ONE mesh
    axis carries both (the EP group is the SP group). Attention runs as
    ``attn`` over sequence blocks; each block's MoE FFN routes this
    rank's tokens and sends them to their experts' ranks. Each rank
    differentiates its share of the global objective, ``nll / (n *
    targets.numel()) + aux_coef * aux / n``; the sum over ranks (one
    all-reduce, outside autograd) is the objective and its gradient.
    ``model`` is a ``MoETransformer`` with ``experts % ranks == 0``."""
    from nvshare_tpu_torch.models.moe_transformer import (
        flatten,
        moe_transformer_forward,
        unflatten,
    )
    from nvshare_tpu_torch.parallel.moe import moe_ffn_ep

    n = mesh.axis_size(axis)
    if model.experts % n:
        raise ValueError(
            f"MoETransformer.experts={model.experts} must divide over the "
            f"{n} ranks of '{axis}' (experts % ranks == 0): the all-to-all "
            "dispatch shards experts evenly")
    attn_fn = _seq_attn_fn(attn, mesh, axis,
                           rope=getattr(model, "rope", False))

    def moe_fn(mp, x2d):
        out, aux = moe_ffn_ep(mp, x2d, mesh=mesh, axis=axis,
                              n_experts=model.experts,
                              capacity_factor=model.capacity_factor)
        return out, aux[0]

    def step(params: dict, opt_state: dict, tokens: torch.Tensor):
        inputs, targets = _local_block(mesh, tokens, axis, None)
        flat = flatten(params)
        with torch.enable_grad(), set_checkpoint_early_stop(False):
            leaves = {k: p.detach().requires_grad_()
                      for k, p in flat.items()}
            logits, aux = moe_transformer_forward(
                unflatten(leaves), model, inputs, attn_fn, moe_fn)
            logp = F.log_softmax(logits.float(), dim=-1)
            nll = -logp.gather(-1, targets.long().unsqueeze(-1)).sum()
            obj = nll / (n * targets.numel()) + model.aux_coef * aux / n
            grads = list(torch.autograd.grad(obj, list(leaves.values())))
        loss = _reduce(mesh, axis, obj, grads, 1.0)
        sgd_momentum_update(flat, {"m": flatten(opt_state["m"])},
                            dict(zip(leaves, grads)), lr)
        return params, opt_state, loss

    return step


def seq_sharded_lm_setup(mesh: Mesh, model: Transformer, batch: int,
                         seed: int = 0):
    """Replicated (params, opt_state, tokens) for
    :func:`seq_sharded_lm_step` on ``mesh.device``: the parameters drawn
    from ``seed`` on every rank (the same values), the synthetic tokens
    [batch, seq + 1] whole on every rank (the step takes each rank's
    block)."""
    params, opt = init_lm_state(model, seed, device=mesh.device)
    toks = torch.from_numpy(synthetic_tokens(model, batch, seed)
                            ).to(mesh.device)
    return params, opt, toks
