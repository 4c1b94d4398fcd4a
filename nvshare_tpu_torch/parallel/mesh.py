"""Mesh construction and the sharded MLP training step: the port of
``nvshare_tpu/parallel/mesh.py``.

The sharding layout is the standard 2D (data, model) recipe: batches
split over the ``data`` axis, the output features of every layer (``w_i``
columns and ``b_i``) split over ``model``. XLA inserts the collectives of
that layout in the JAX package; here they are written out
(:func:`mlp_forward_tp`): each layer's output shards are all-gathered
over ``model`` (whose backward, with the :func:`psum_grad` on the next
layer's input, is a reduce-scatter), and the gradients are summed over
``data`` once a step.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from nvshare_tpu_torch.device import DeviceLike
from nvshare_tpu_torch.models.mlp import MLP, synthetic_batch
from nvshare_tpu_torch.models.transformer import (
    _matmul_f32,
    sgd_momentum_update,
)
from nvshare_tpu_torch.parallel.collectives import (
    Mesh,
    all_reduce_sum,
    gather,
    psum_grad,
    world_size,
)

_CDT = torch.bfloat16


def make_mesh(n_devices: int | None = None,
              axes: Sequence[str] = ("data", "model"),
              device: DeviceLike = None) -> Mesh:
    """A 2D mesh over ``n_devices`` ranks (default: the whole program),
    data-major.

    Shape heuristic, the JAX package's: the model axis gets the largest
    power-of-two divisor <= sqrt(n) (4 ranks -> 2x2, 8 -> 4x2, 16 ->
    4x4). A mesh spans every rank of the program: the ranks come from
    :func:`~nvshare_tpu_torch.parallel.collectives.init_ranks` (a program
    of one process needs none). JAX's fallback to virtual CPU devices has
    no counterpart; the caller passes ``device="cpu"`` instead.
    """
    world = world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(
            f"requested {n_devices} ranks, have {world}: start the program "
            f"as {n_devices} processes and call init_ranks in each "
            "(a mesh spans every rank)")
    model = 1
    while model * 2 <= int(np.sqrt(n_devices)) and \
            n_devices % (model * 2) == 0:
        model *= 2
    return Mesh((n_devices // model, model), tuple(axes), device=device)


def _shard_dim(name: str) -> int:
    # w_i: (in, out) -> the output features over `model`; b_i likewise.
    return 1 if name.startswith("w") else 0


def _local(mesh: Mesh, name: str, x: torch.Tensor) -> torch.Tensor:
    n, i = mesh.axis_size("model"), mesh.axis_index("model")
    dim = _shard_dim(name)
    if x.shape[dim] % n:
        raise ValueError(f"{name} {tuple(x.shape)}: dim {dim} does not "
                         f"shard over {n} model ranks")
    blk = x.shape[dim] // n
    return x.narrow(dim, i * blk, blk).contiguous()


def sharded_train_setup(mesh: Mesh, model: MLP, batch: int, seed: int = 0):
    """This rank's (params, opt_state, x, y): the parameters drawn from
    ``seed`` on every rank (the same values), then cut to this rank's
    ``model`` shard; the batch (``synthetic_batch``) cut to its ``data``
    shard."""
    params = {k: _local(mesh, k, v)
              for k, v in model.init(seed, device=mesh.device).items()}
    opt_state = {"m": {k: torch.zeros_like(v) for k, v in params.items()}}
    x, y = synthetic_batch(model, batch, seed)
    n, i = mesh.axis_size("data"), mesh.axis_index("data")
    if batch % n:
        raise ValueError(f"batch {batch} does not shard over {n} data ranks")
    blk = batch // n
    x = torch.from_numpy(x[i * blk:(i + 1) * blk]).to(mesh.device)
    y = torch.from_numpy(y[i * blk:(i + 1) * blk]).to(mesh.device)
    return params, opt_state, x, y


def mlp_forward_tp(params: dict, x: torch.Tensor, mesh: Mesh
                   ) -> torch.Tensor:
    """``models.mlp.mlp_forward`` with every layer's output features
    sharded over ``model``: this rank's columns, then an all-gather of the
    whole activation (f32 logits, the same on every model rank)."""
    h = x.to(_CDT)
    n_layers = len(params) // 2
    for i in range(n_layers):
        h = psum_grad(h, mesh, "model")
        z = _matmul_f32(h, params[f"w{i}"].to(_CDT)) + params[f"b{i}"]
        h = gather(z, mesh, "model", dim=-1)
        if i < n_layers - 1:
            h = F.gelu(h, approximate="tanh").to(_CDT)
    return h


def sharded_mlp_step(mesh: Mesh, model: MLP, lr: float = 1e-3):
    """The MLP's momentum-SGD train step over ``mesh``: dp over ``data``,
    tp over ``model``. ``step(params, opt_state, x, y) -> (params,
    opt_state, loss)`` on this rank's shards (:func:`sharded_train_setup`),
    updated in place; the loss is the global batch mean, the same on
    every rank."""
    n_data = mesh.axis_size("data")

    def step(params, opt_state, x, y):
        with torch.enable_grad():
            leaves = {k: p.detach().requires_grad_()
                      for k, p in params.items()}
            logits = mlp_forward_tp(leaves, x, mesh)
            logp = F.log_softmax(logits.float(), dim=-1)
            loss = -logp.gather(1, y.long().unsqueeze(1)).mean()
            grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = [g.contiguous() for g in grads]
        # The global mean over the data shards: one sum, then / n.
        packed = grads + [loss.detach().reshape(1)]
        all_reduce_sum(mesh, "data", packed)
        for g in packed:
            g.div_(n_data)
        sgd_momentum_update(params, opt_state, dict(zip(leaves, grads)), lr)
        return params, opt_state, packed[-1][0]

    return step
