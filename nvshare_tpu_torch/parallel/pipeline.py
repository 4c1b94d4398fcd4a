"""Pipeline parallelism: a GPipe fill-drain schedule over a mesh axis, the
port of ``nvshare_tpu/parallel/pipeline.py``.

Stage s of the network lives on rank s of the axis; microbatches stream
through M + n - 1 ticks, and activations hop stage to stage with
:func:`~nvshare_tpu_torch.parallel.collectives.ppermute`. Every tick runs
the SAME stage computation on every rank (SPMD): a rank in the bubble
computes on garbage that is never recorded, and the selects that feed
stage 0 and record the last stage's outputs are tensor selects, not
per-rank branches. So every rank's autograd graph has the same chain of
ppermutes, and the backward is backward pipelining: each ppermute's
backward is the reversed hop, run by every rank in the same order.

The training step differentiates a LAST-STAGE-ONLY loss (a masked zero
elsewhere), and every rank calls the backward, so the reversed hops pair
up; each rank ends with its own stage's gradient, and no gradient
collective is needed.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from nvshare_tpu_torch.device import DeviceLike, resolve_device
from nvshare_tpu_torch.device import generator as _seeded
from nvshare_tpu_torch.models.transformer import (
    _matmul_f32,
    dense_ffn,
    transformer_block,
)
from nvshare_tpu_torch.ops.attention import flash_attention
from nvshare_tpu_torch.parallel.collectives import (
    Mesh,
    all_reduce_sum,
    ppermute,
    ring_perm,
)

_CDT = torch.bfloat16


def mlp_stage(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The default stage: one residual gelu-MLP block, params {"w": [D,
    D], "b": [D]}; same shape in and out."""
    h = _matmul_f32(x.to(_CDT), params["w"].to(_CDT))
    return (x.float() + F.gelu(h + params["b"], approximate="tanh")
            ).to(x.dtype)


def transformer_stage(params: dict, x: torch.Tensor, *, heads: int = 4,
                      compute_dtype: torch.dtype = _CDT) -> torch.Tensor:
    """A pre-norm transformer block as a stage: flash attention (causal)
    and the gelu MLP on hidden states x [mb, S, D], in ``compute_dtype``
    (bf16 in production; f32 pins the schedule's exactness in tests).
    params: {"qkv" [D,3D], "proj" [D,D], "up" [D,4D], "down" [4D,D],
    "ln1" [D], "ln2" [D]}."""
    cdt = compute_dtype
    h, _ = transformer_block(
        params, x.to(cdt), heads=heads,
        attn_fn=partial(flash_attention, causal=True),
        ffn=lambda z: (dense_ffn(params["up"], params["down"], z,
                                 compute_dtype=cdt),
                       torch.zeros((), dtype=torch.float32,
                                   device=z.device)),
        compute_dtype=cdt)
    return h.to(x.dtype)


def _normal(gen, shape, fan_in):
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_((1.0 / fan_in) ** 0.5)


def init_transformer_stage_params(n_stages: int, d: int, mlp_mult: int = 4,
                                  generator: Optional[torch.Generator] = None,
                                  seed: int = 0,
                                  device: DeviceLike = None) -> dict:
    """Stacked per-stage transformer-block params (leading axis = stage)
    on ``device`` (default ``cuda``), from ``generator`` (default: one
    seeded with ``seed``)."""
    gen = generator if generator is not None else _seeded(
        resolve_device(device), seed)
    dev = gen.device
    f = mlp_mult * d
    stacks = {k: [] for k in ("qkv", "proj", "up", "down")}
    for _ in range(n_stages):
        stacks["qkv"].append(_normal(gen, (d, 3 * d), d))
        stacks["proj"].append(_normal(gen, (d, d), d))
        stacks["up"].append(_normal(gen, (d, f), d))
        stacks["down"].append(_normal(gen, (f, d), f))
    params = {k: torch.stack(v) for k, v in stacks.items()}
    params["ln1"] = torch.ones((n_stages, d), dtype=torch.float32,
                               device=dev)
    params["ln2"] = torch.ones((n_stages, d), dtype=torch.float32,
                               device=dev)
    return params


def init_pipeline_params(n_stages: int, d: int,
                         generator: Optional[torch.Generator] = None,
                         seed: int = 0, device: DeviceLike = None) -> dict:
    """Stacked :func:`mlp_stage` params: ``w`` [S, D, D], ``b`` [S, D]."""
    gen = generator if generator is not None else _seeded(
        resolve_device(device), seed)
    ws = torch.stack([_normal(gen, (d, d), d) for _ in range(n_stages)])
    return {"w": ws, "b": torch.zeros((n_stages, d), dtype=torch.float32,
                                      device=gen.device)}


def local_stage(mesh: Mesh, params: dict, axis: str = "pp") -> dict:
    """A copy of this rank's slice [1, ...] of stacked stage params [S,
    ...] (a copy: the train step updates it in place)."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    out = {}
    for k, v in params.items():
        if v.shape[0] != n:
            raise ValueError(f"{k}: {v.shape[0]} stages over {n} ranks "
                             "(one stage a rank)")
        out[k] = v[i:i + 1].clone()
    return out


def _pipeline_local(stage_fn: Callable, my_params: dict, xs: torch.Tensor,
                    mesh: Mesh, axis: str) -> torch.Tensor:
    """The fill-drain schedule on this rank. xs: [M, mb, ...] (the same
    on every rank). Returns this rank's output buffer [M, mb, ...] f32:
    zeros except on the LAST stage, where slot i holds microbatch i's
    output."""
    n, idx = mesh.axis_size(axis), mesh.axis_index(axis)
    m = xs.shape[0]
    first = torch.tensor(idx == 0, device=xs.device)
    last = torch.tensor(idx == n - 1, device=xs.device)
    act = torch.zeros_like(xs[0])
    slots = [None] * m
    for t in range(m + n - 1):
        # Stage 0 feeds microbatch t (clipped: past-the-end feeds are
        # computed, never recorded); later stages take the hop in.
        x_cur = torch.where(first, xs[min(t, m - 1)], act)
        y = stage_fn(my_params, x_cur)
        out_t = t - (n - 1)
        if 0 <= out_t < m:
            slots[out_t] = torch.where(last, y.float(), 0.0)
        # The hop to the next stage (the wrap to stage 0 carries bubble
        # garbage, which the feed select discards). The last tick's hop
        # reaches nothing, on every rank alike, so it is not made.
        if t < m + n - 2:
            act = ppermute(y, mesh, axis, ring_perm(n))
    return torch.stack(slots)


def _unstack(params_local: dict) -> dict:
    return {k: v[0] for k, v in params_local.items()}


def pipeline_forward(stage_fn: Callable, params_local: dict,
                     xs: torch.Tensor, *, mesh: Mesh,
                     axis: str = "pp") -> torch.Tensor:
    """Forward inside a rank: this rank's stage params [1, ...], xs [M,
    mb, ...] replicated. Returns the replicated [M, mb, ...] f32 output
    (a sum over the axis of the masked buffers, outside autograd)."""
    with torch.no_grad():
        outbuf = _pipeline_local(stage_fn, _unstack(params_local), xs,
                                 mesh, axis)
        all_reduce_sum(mesh, axis, [outbuf])
    return outbuf


def pipeline_forward_sharded(mesh: Mesh, stage_fn: Callable = mlp_stage, *,
                             axis: str = "pp"):
    """``fn(params, xs)``: stacked stage params [S, ...] (whole, the same
    on every rank; each rank runs its slice) and microbatches [M, mb, ...]
    in, the replicated [M, mb, ...] output out."""
    def fn(params: dict, xs: torch.Tensor) -> torch.Tensor:
        return pipeline_forward(stage_fn, local_stage(mesh, params, axis),
                                xs, mesh=mesh, axis=axis)

    return fn


def pipeline_train_step(mesh: Mesh, stage_fn: Callable = mlp_stage, *,
                        axis: str = "pp", lr: float = 1e-2):
    """A pipeline-parallel SGD step: ``step(params_local, xs, ys) ->
    (params_local, loss)``, this rank's stage params [1, ...] updated in
    place, xs/ys [M, mb, ...] replicated. Every rank differentiates the
    last stage's MSE (a masked zero on the others), so cotangents reach
    earlier stages through the reversed hops; the loss comes back the
    same on every rank."""
    def step(params_local: dict, xs: torch.Tensor, ys: torch.Tensor):
        n, idx = mesh.axis_size(axis), mesh.axis_index(axis)
        with torch.enable_grad():
            leaves = {k: p.detach().requires_grad_()
                      for k, p in params_local.items()}
            outbuf = _pipeline_local(stage_fn, _unstack(leaves), xs, mesh,
                                     axis)
            mse = ((outbuf - ys.float()) ** 2).mean()
            loss = torch.where(torch.tensor(idx == n - 1,
                                            device=mse.device), mse, 0.0)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            for p, g in zip(params_local.values(), grads):
                p.sub_(lr * g)
            total = loss.detach().reshape(1).clone()
        all_reduce_sum(mesh, axis, [total])      # only the last is nonzero
        return params_local, total[0]

    return step
