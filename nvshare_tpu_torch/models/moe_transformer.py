"""A mixture-of-experts causal transformer LM: the port of
``nvshare_tpu/models/moe_transformer.py``.

The dense LM's blocks (:func:`~nvshare_tpu_torch.models.transformer.forward_blocks`)
with a capacity-routed MoE FFN in the FFN slot. On one device the FFN is
:func:`~nvshare_tpu_torch.parallel.moe.moe_ffn_reference` and attention
the local flash kernel; under
:func:`~nvshare_tpu_torch.parallel.seq_transformer.seq_sharded_moe_lm_step`
one mesh axis carries both sequence parallelism for attention and expert
parallelism for the FFNs (the DeepSpeed-MoE layout). f32 master
parameters, bf16 compute.

Parameters are a nested dict with the JAX package's names: the dense
LM's ``embed``, ``qkv{i}``, ``proj{i}``, ``ln1_{i}``, ``ln2_{i}``,
``ln_f``, and ``moe{i}`` = {``router``, ``w_up``, ``w_down``}
(:func:`nvshare_tpu_torch.convert.moe_lm_state_from_numpy` carries a JAX
tree across).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from nvshare_tpu_torch.device import DeviceLike
from nvshare_tpu_torch.device import generator as _seeded
from nvshare_tpu_torch.models.transformer import (  # noqa: F401
    forward_blocks,
    local_attn,
    model_device,
    sgd_momentum_update,
    synthetic_tokens,
)
from nvshare_tpu_torch.parallel.moe import init_moe_params, moe_ffn_reference


@dataclass(frozen=True)
class MoETransformer:
    vocab: int = 256
    dim: int = 128
    heads: int = 4
    depth: int = 2
    seq: int = 128
    experts: int = 8
    mlp_mult: int = 4
    capacity_factor: float = 1.25
    aux_coef: float = 0.01
    remat: bool = False  # recompute blocks in the backward (forward_blocks)
    rope: bool = False   # rotary position embeddings on q/k (ops/rope.py)

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    def init(self, seed: int = 0, device: DeviceLike = None,
             generator: Optional[torch.Generator] = None) -> dict:
        """f32 parameters with the JAX package's names and scales, drawn on
        ``device`` (default ``cuda``) from ``generator`` (default: one
        seeded with ``seed``). The bits differ from ``jax.random``'s."""
        dev = model_device(device)
        gen = generator if generator is not None else _seeded(dev, seed)

        def dense(shape, fan_in):
            w = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev)
            return w.mul_((1.0 / fan_in) ** 0.5)

        d = self.dim
        params = {"embed": dense((self.vocab, d), d)}
        for i in range(self.depth):
            params[f"qkv{i}"] = dense((d, 3 * d), d)
            params[f"proj{i}"] = dense((d, d), d)
            params[f"moe{i}"] = init_moe_params(
                self.experts, d, self.mlp_mult * d, generator=gen)
            params[f"ln1_{i}"] = torch.ones(d, dtype=torch.float32,
                                            device=dev)
            params[f"ln2_{i}"] = torch.ones(d, dtype=torch.float32,
                                            device=dev)
        params["ln_f"] = torch.ones(d, dtype=torch.float32, device=dev)
        return params


def flatten(tree: dict, prefix: str = "") -> dict:
    """The leaves of a nested dict by path (``moe0/router``); the tensors
    themselves, not copies."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def unflatten(flat: dict) -> dict:
    """The nested dict of :func:`flatten`'s paths."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def moe_transformer_forward(params: dict, model: MoETransformer,
                            tokens: torch.Tensor,
                            attn_fn: Optional[Callable] = None,
                            moe_fn: Optional[Callable] = None):
    """tokens [B, S] -> (logits [B, S, vocab] f32, mean aux).

    ``attn_fn``/``moe_fn`` swap in the sequence-parallel and
    expert-parallel ops inside a rank; ``moe_fn(moe_params, x2d) -> (y2d,
    aux)`` takes the flattened [tokens, D]."""
    if attn_fn is None:
        attn_fn = local_attn(model)
    if moe_fn is None:
        def moe_fn(p, x2d):
            return moe_ffn_reference(p, x2d, model.experts,
                                     capacity_factor=model.capacity_factor)
    b, s = tokens.shape

    def ffn_fn(p, i, x):
        y2d, aux = moe_fn(p[f"moe{i}"], x.reshape(b * s, model.dim))
        return y2d.reshape(b, s, model.dim), aux.reshape(())

    return forward_blocks(params, model, tokens, attn_fn, ffn_fn)


def moe_lm_objective(params: dict, model: MoETransformer,
                     tokens: torch.Tensor) -> torch.Tensor:
    """Single-device objective of tokens [B, S+1]: token-mean NLL +
    aux_coef * aux."""
    logits, aux = moe_transformer_forward(params, model, tokens[:, :-1])
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:].long().unsqueeze(-1)).mean()
    return nll + model.aux_coef * aux


def moe_lm_train_step(params: dict, opt_state: dict, tokens: torch.Tensor,
                      model: MoETransformer, lr: float = 1e-2) -> tuple:
    """One momentum-SGD step of :func:`moe_lm_objective`: ``(params,
    opt_state, loss)``, updated in place as ``lm_train_step`` is."""
    flat = flatten(params)
    with torch.enable_grad():
        leaves = {k: p.detach().requires_grad_() for k, p in flat.items()}
        loss = moe_lm_objective(unflatten(leaves), model, tokens)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    sgd_momentum_update(flat, {"m": flatten(opt_state["m"])},
                        dict(zip(leaves, grads)), lr)
    return params, opt_state, loss.detach()


def init_moe_lm_state(model: MoETransformer, seed: int = 0,
                      device: DeviceLike = None) -> tuple[dict, dict]:
    """(params, {"m": zero momentum}) on ``device`` (default ``cuda``)."""
    params = model.init(seed, device=device)
    return params, {"m": unflatten({k: torch.zeros_like(v) for k, v
                                    in flatten(params).items()})}
