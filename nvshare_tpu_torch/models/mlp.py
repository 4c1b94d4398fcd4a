"""A bf16 MLP classifier with a full train step: the port of
``nvshare_tpu/models/mlp.py``, the JAX package's representative training
workload for the framework's integration points (gated stepping, the
input pipeline, checkpoints).

f32 master parameters; the forward computes in bf16 with f32
accumulation through :func:`~nvshare_tpu_torch.models.transformer._matmul_f32`
(PyTorch's ``mm`` with ``out_dtype`` has no derivative). The products are
library matmuls: the JAX model's are XLA dots, outside any Pallas kernel.
Parameters are a dict with the JAX package's names (``w{i}``, ``b{i}``),
so :func:`nvshare_tpu_torch.convert.mlp_params_from_numpy` carries a JAX
parameter tree across.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from nvshare_tpu_torch.device import DeviceLike
from nvshare_tpu_torch.device import generator as _seeded
from nvshare_tpu_torch.models.transformer import (
    _matmul_f32,
    model_device,
    sgd_momentum_update,
)

_CDT = torch.bfloat16


@dataclass(frozen=True)
class MLP:
    in_dim: int = 1024
    hidden_dim: int = 4096
    out_dim: int = 256
    depth: int = 4

    def dims(self) -> list:
        return ([self.in_dim] + [self.hidden_dim] * (self.depth - 1)
                + [self.out_dim])

    def init(self, seed: int = 0, device: DeviceLike = None,
             generator: Optional[torch.Generator] = None) -> dict:
        """f32 parameters with the JAX package's names and scales (He
        normal weights, zero biases) on ``device`` (default ``cuda``),
        drawn from ``generator`` (default: one seeded with ``seed``). The
        bits differ from ``jax.random``'s for the same seed."""
        dev = model_device(device)
        gen = generator
        if gen is None and dev.type != "meta":
            gen = _seeded(dev, seed)
        params = {}
        dims = self.dims()
        for i, (d_in, d_out) in enumerate(zip(dims, dims[1:])):
            w = torch.randn((d_in, d_out), generator=gen,
                            dtype=torch.float32, device=dev)
            params[f"w{i}"] = w.mul_((2.0 / d_in) ** 0.5)
            params[f"b{i}"] = torch.zeros(d_out, dtype=torch.float32,
                                          device=dev)
        return params


def mlp_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits (f32) of ``x`` [B, in_dim]: bf16 products with f32
    accumulation, the bias added in f32, a tanh-gelu between layers
    (``jax.nn.gelu``'s default) rounded to bf16."""
    h = x.to(_CDT)
    n_layers = len(params) // 2
    for i in range(n_layers):
        h = _matmul_f32(h, params[f"w{i}"].to(_CDT)) + params[f"b{i}"]
        if i < n_layers - 1:
            h = F.gelu(h, approximate="tanh").to(_CDT)
    return h


def mlp_loss(params: dict, x: torch.Tensor, y: torch.Tensor
             ) -> torch.Tensor:
    """Mean cross-entropy of the logits against the labels ``y`` [B]."""
    logp = F.log_softmax(mlp_forward(params, x).float(), dim=-1)
    return -logp.gather(1, y.long().unsqueeze(1)).mean()


def train_step(params: dict, opt_state: dict, x: torch.Tensor,
               y: torch.Tensor, lr: float = 1e-3) -> tuple:
    """One SGD-with-momentum step (momentum 0.9): ``(params, opt_state,
    loss)``. As :func:`~nvshare_tpu_torch.models.transformer.lm_train_step`,
    the update runs in place on the state it is given (PyTorch has no
    donation); the loss comes back detached."""
    with torch.enable_grad():
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss = mlp_loss(leaves, x, y)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    sgd_momentum_update(params, opt_state, dict(zip(leaves, grads)), lr)
    return params, opt_state, loss.detach()


def init_train_state(model: MLP, seed: int = 0,
                     device: DeviceLike = None) -> tuple[dict, dict]:
    """(params, {"m": zero momentum}) on ``device`` (default ``cuda``)."""
    params = model.init(seed, device=device)
    return params, {"m": {k: torch.zeros_like(p) for k, p in params.items()}}


def synthetic_batch(model: MLP, batch: int, seed: int = 0):
    """A numpy batch ``(x [B, in_dim] f32, y [B] int32)``, the JAX
    package's bit for bit (host-side; callers place it on their device)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(batch, model.in_dim).astype(np.float32)
    y = rng.randint(0, model.out_dim, size=(batch,)).astype(np.int32)
    return x, y
