"""Every parallel axis of the package, run as ranks: the counterpart of
``__graft_entry__.dryrun_multichip``.

    python -m nvshare_tpu_torch.parallel.dryrun --world N [--device cuda|cpu]

starts N rank processes (gloo on the CPU, or on one card shared by the
ranks; NCCL when every rank has a card of its own, by
:func:`~nvshare_tpu_torch.parallel.collectives.choose_backend`) that run
the battery at small shapes: dp x tp MLP step, ring and Ulysses attention
(exact against single-device attention, the kernel-tile ring included),
the sequence-parallel LM step with RoPE, the expert-parallel MoE FFN
(exact against the per-shard reference), the pipeline step, the
sequence-parallel MoE LM step and dp x sp. It prints each rank's result
line and one ``dryrun(N): OK`` line, and exits non-zero if any rank
failed.

:func:`spawn` is the engine: it runs a list of cases (``CASES``) in
``world`` rank processes and returns each rank's results (numpy arrays
and numbers, through files) and a meta record per case: the backend, the
bytes and seconds of each collective kind, the case's seconds, its peak
device memory and the flash kernels' launches by route. The tests
(``device="cpu"``) and ``chip_smoke.py`` (on the card) drive it. A rank
that fails, or outlives the time limit, fails the run: the other ranks
are stopped, and the error carries the rank's output.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from nvshare_tpu_torch.device import resolve_device
from nvshare_tpu_torch.parallel.collectives import (
    Mesh,
    init_ranks,
    shutdown_ranks,
)

PKG_ROOT = Path(__file__).resolve().parents[2]

# -- helpers -----------------------------------------------------------------

TILE_ROWS = 64


def tile_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest norm-wise relative error ||got - want|| / ||want|| over
    the tiles of TILE_ROWS rows of one head of a [B, S, H, D] tensor. A
    wrong or skipped tile shows wherever it lies. A tile whose reference
    is below 1e-6 of the largest tile's norm (causal dK, dV of keys no
    query sees) is measured against that floor."""
    b, s, h, d = want.shape
    rows = min(TILE_ROWS, s)
    shape = (b, s // rows, rows, h, d)
    diff = (got.float() - want.float()).reshape(shape).norm(dim=(2, 4))
    ref = want.float().reshape(shape).norm(dim=(2, 4))
    floor = max(1e-6 * ref.max().item(), torch.finfo(torch.float32).tiny)
    return (diff / ref.clamp(min=floor)).max().item()


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| over the whole tensor."""
    want = want.float()
    return ((got.float() - want).norm()
            / want.norm().clamp(min=1e-30)).item()


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def _tensor(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype)


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _normal(gen, shape, scale=1.0, dtype=torch.float32) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


def _inputs(inputs: dict, prefix: str) -> dict:
    """The arrays under ``prefix/`` with the prefix taken off, nested
    dicts rebuilt from further ``/``."""
    out: dict = {}
    for key, v in inputs.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        *parents, leaf = key[len(prefix) + 1:].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _sums(tree: dict) -> tuple:
    """(f64 sum, f64 sum of |x|) over every tensor of a nested dict."""
    from nvshare_tpu_torch.models.moe_transformer import flatten

    s = a = 0.0
    for t in flatten(tree).values():
        s += t.double().sum().item()
        a += t.double().abs().sum().item()
    return s, a


def _flat_arrays(tree: dict, prefix: str) -> dict:
    from nvshare_tpu_torch.models.moe_transformer import flatten

    return {f"{prefix}/{k}": _np(v) for k, v in flatten(tree).items()}


# -- cases -------------------------------------------------------------------
# Each case runs in every rank: case(cfg, inputs, device) -> (results, mesh),
# the mesh None for the single-process references (``*_single``). Results
# are numpy arrays and numbers; cfg and inputs are the same on every rank.

def case_attention(cfg: dict, inputs: dict, device):
    """Ring or Ulysses attention (``cfg["impl"]``) on whole [B, S, H, D]
    tensors, from ``inputs`` (``<cfg["qkv"]>/q``, ``/k``, ``/v`` and the
    cotangent ``/do``) or drawn from ``cfg["seed"]``.
    ``grads``: also the gradients of sum(out * dO). ``check``: rank 0
    holds the output and gradients against ``reference_attention`` in f32
    and returns the errors instead of the arrays; ``digest``: every rank
    returns the SHA-256 of each result's bytes."""
    from nvshare_tpu_torch.ops.attention import reference_attention
    from nvshare_tpu_torch.parallel.ring_attention import (
        make_seq_mesh,
        ring_attention_sharded,
        ulysses_attention_sharded,
    )

    mesh = make_seq_mesh(device=device)
    dtype = _dtype(cfg.get("dtype", "float32"))
    if cfg.get("qkv"):
        q, k, v, do = (_tensor(inputs[f"{cfg['qkv']}/{n}"], mesh.device,
                               dtype)
                       for n in ("q", "k", "v", "do"))
    else:
        gen = _gen(mesh.device, cfg.get("seed", 0))
        q, k, v, do = (_normal(gen, cfg["shape"], 0.5, dtype)
                       for _ in range(4))
    fn = {"ring": ring_attention_sharded,
          "ulysses": ulysses_attention_sharded}[cfg["impl"]](
        mesh, causal=cfg["causal"])
    grads = cfg.get("grads", False)
    with torch.enable_grad():
        prim = [x.detach().requires_grad_(grads) for x in (q, k, v)]
        out = fn(*prim)
        res = {"dtype": str(out.dtype)}
        if grads:
            g = torch.autograd.grad((out.float() * do.float()).sum(), prim)
    if cfg.get("check"):
        if mesh.rank == 0:
            with torch.enable_grad():
                ref_in = [x.detach().float().requires_grad_(grads)
                          for x in (q, k, v)]
                want = reference_attention(*ref_in, causal=cfg["causal"])
                res["err_out"] = tile_rel_err(out, want)
                if grads:
                    wg = torch.autograd.grad((want * do.float()).sum(),
                                             ref_in)
                    for n, a, b in zip("qkv", g, wg):
                        res[f"err_d{n}"] = tile_rel_err(a, b)
        return res, mesh
    named = [("out", out)] + (list(zip(("dq", "dk", "dv"), g)) if grads
                              else [])
    if cfg.get("digest"):
        # The bits of each result, to compare two runs exactly.
        res.update({f"sha/{n}": _digest(x) for n, x in named})
    elif mesh.rank == 0:
        res.update({n: _np(x) for n, x in named})
    return res, mesh


def _digest(x: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(x.detach().contiguous().view(torch.uint8)
                          .cpu().numpy().tobytes()).hexdigest()


def _lm_model(cfg: dict):
    from nvshare_tpu_torch.models.transformer import Transformer

    return Transformer(**cfg["model"])


def _lm_state(cfg: dict, inputs: dict, model, device):
    from nvshare_tpu_torch.convert import lm_state_from_numpy
    from nvshare_tpu_torch.models.transformer import init_lm_state

    if cfg.get("params"):   # carried in, with zero momentum
        p = _inputs(inputs, cfg["params"])
        return lm_state_from_numpy(
            p, {"m": {k: np.zeros_like(v) for k, v in p.items()}},
            device=device)
    return init_lm_state(model, cfg.get("seed", 0), device=device)


def _tokens(cfg: dict, inputs: dict, model, device) -> torch.Tensor:
    from nvshare_tpu_torch.models.transformer import synthetic_tokens

    if cfg.get("tokens"):
        toks = inputs[cfg["tokens"]]
    else:
        toks = synthetic_tokens(model, cfg["batch"], cfg.get("seed", 0))
    return torch.from_numpy(np.asarray(toks, dtype=np.int32)).to(device)


def _train_result(cfg, losses, params, opt) -> dict:
    res = {"losses": np.asarray(losses, dtype=np.float64)}
    res["param_sum"], res["param_abs"] = _sums(params)
    res["m_sum"], res["m_abs"] = _sums(opt["m"])
    if cfg.get("arrays"):
        res.update(_flat_arrays(params, "params"))
        res.update(_flat_arrays(opt["m"], "m"))
    return res


def _mesh_of(cfg: dict, device) -> Mesh:
    shape = cfg.get("mesh")
    if shape is None:
        from nvshare_tpu_torch.parallel.ring_attention import make_seq_mesh

        return make_seq_mesh(device=device)
    return Mesh(shape, cfg.get("axes", ("data", "seq")), device=device)


def case_seq_lm(cfg: dict, inputs: dict, device):
    """``seq_sharded_lm_step`` (``cfg["attn"]``; dp x sp when
    ``cfg["mesh"]`` is 2D) for ``cfg["steps"]`` steps from the same
    tokens; ``cfg["optimizer"]`` ("adam" or "adamw", arguments
    ``cfg["opt_args"]``) steps that instead of the momentum SGD."""
    from nvshare_tpu_torch.parallel.seq_transformer import (
        seq_sharded_lm_step,
    )

    model = _lm_model(cfg)
    mesh = _mesh_of(cfg, device)
    params, opt = _lm_state(cfg, inputs, model, mesh.device)
    toks = _tokens(cfg, inputs, model, mesh.device)
    optimizer = None
    if cfg.get("optimizer"):
        for p in params.values():
            p.requires_grad_()
        optimizer = {"adam": torch.optim.Adam, "adamw": torch.optim.AdamW}[
            cfg["optimizer"]](list(params.values()),
                              **cfg.get("opt_args", {}))
    batch_axis = "data" if len(mesh.shape) == 2 else None
    step = seq_sharded_lm_step(mesh, model, attn=cfg.get("attn", "ring"),
                               lr=cfg.get("lr"), optimizer=optimizer,
                               batch_axis=batch_axis)
    losses, step_s = [], []
    for _ in range(cfg.get("steps", 1)):
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, toks)
        losses.append(loss.item())
        step_s.append(time.perf_counter() - t0)
    with torch.no_grad():
        res = _train_result(cfg, losses, params, opt)
    res["step_s"] = np.asarray(step_s)
    return res, mesh


def case_lm_single(cfg: dict, inputs: dict, device):
    """The single-device ``lm_train_step`` (the reference of
    ``case_seq_lm``), in one rank."""
    from nvshare_tpu_torch.models.transformer import lm_train_step

    model = _lm_model(cfg)
    dev = resolve_device(device)
    params, opt = _lm_state(cfg, inputs, model, dev)
    toks = _tokens(cfg, inputs, model, dev)
    losses, step_s = [], []
    for _ in range(cfg.get("steps", 1)):
        t0 = time.perf_counter()
        params, opt, loss = lm_train_step(params, opt, toks, model,
                                          lr=cfg.get("lr") or 1e-2)
        losses.append(loss.item())
        step_s.append(time.perf_counter() - t0)
    with torch.no_grad():
        res = _train_result(cfg, losses, params, opt)
    res["step_s"] = np.asarray(step_s)
    return res, None


def _moe_params(cfg, inputs, device):
    from nvshare_tpu_torch.parallel.moe import init_moe_params

    if cfg.get("params"):
        return {k: _tensor(v, device)
                for k, v in _inputs(inputs, cfg["params"]).items()}
    return init_moe_params(cfg["experts"], cfg["d"], cfg["hidden"],
                           seed=cfg.get("seed", 0), device=device)


def case_moe_ffn(cfg: dict, inputs: dict, device):
    """``moe_ffn_sharded`` on whole tokens [T, D]. ``grads``: the params'
    gradients of sum(out^2) + 0.01 aux. ``check``: each rank holds its
    token shard of the output against ``moe_ffn_reference`` on that shard
    alone (JAX's contract) and returns the errors."""
    from nvshare_tpu_torch.parallel.moe import (
        moe_ffn_reference,
        moe_ffn_sharded,
    )
    from nvshare_tpu_torch.parallel.ring_attention import make_seq_mesh

    mesh = make_seq_mesh(axis="ep", device=device)
    params = _moe_params(cfg, inputs, mesh.device)
    if cfg.get("x"):
        x = _tensor(inputs[cfg["x"]], mesh.device)
    else:
        x = _normal(_gen(mesh.device, cfg.get("seed", 0) + 1),
                    (cfg["tokens"], cfg["d"]), 0.5)
    cf = cfg.get("capacity_factor", 1.25)
    fn = moe_ffn_sharded(mesh, cfg["experts"], axis="ep",
                         capacity_factor=cf)
    grads = cfg.get("grads", False)
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(grads)
                  for k, v in params.items()}
        out, aux = fn(leaves, x)
        if grads:
            loss = (out.float() ** 2).sum() + 0.01 * aux
            g = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
    res = {"aux": aux.item()}
    if cfg.get("check"):
        n, i = mesh.axis_size("ep"), mesh.axis_index("ep")
        blk = x.shape[0] // n
        with torch.no_grad():
            want, want_aux = moe_ffn_reference(
                params, x[i * blk:(i + 1) * blk], cfg["experts"], cf)
        got = out[i * blk:(i + 1) * blk]
        res["max_abs_err"] = (got - want).abs().max().item()
        res["rel_err"] = rel_err(got, want)
        res["aux_shard"] = want_aux.item()
        res["dropped_rows"] = int((want == 0).all(dim=-1).sum().item())
        return res, mesh
    if mesh.rank == 0:
        res["out"] = _np(out)
        if grads:
            res.update({f"grad/{k}": _np(v) for k, v in g.items()})
    return res, mesh


def _moe_model(cfg):
    from nvshare_tpu_torch.models.moe_transformer import MoETransformer

    return MoETransformer(**cfg["model"])


def _moe_state(cfg, inputs, model, device):
    from nvshare_tpu_torch.convert import moe_lm_state_from_numpy
    from nvshare_tpu_torch.models.moe_transformer import init_moe_lm_state

    if cfg.get("params"):
        p = _inputs(inputs, cfg["params"])
        zeros = {k: ({kk: np.zeros_like(vv) for kk, vv in v.items()}
                     if isinstance(v, dict) else np.zeros_like(v))
                 for k, v in p.items()}
        return moe_lm_state_from_numpy(p, {"m": zeros}, device=device)
    return init_moe_lm_state(model, cfg.get("seed", 0), device=device)


def case_moe_lm(cfg: dict, inputs: dict, device):
    """``seq_sharded_moe_lm_step`` for ``cfg["steps"]`` steps."""
    from nvshare_tpu_torch.parallel.ring_attention import make_seq_mesh
    from nvshare_tpu_torch.parallel.seq_transformer import (
        seq_sharded_moe_lm_step,
    )

    model = _moe_model(cfg)
    mesh = make_seq_mesh(device=device)
    params, opt = _moe_state(cfg, inputs, model, mesh.device)
    toks = _tokens(cfg, inputs, model, mesh.device)
    step = seq_sharded_moe_lm_step(mesh, model, attn=cfg.get("attn", "ring"),
                                   lr=cfg.get("lr", 1e-2))
    losses, step_s = [], []
    for _ in range(cfg.get("steps", 1)):
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, toks)
        losses.append(loss.item())
        step_s.append(time.perf_counter() - t0)
    with torch.no_grad():
        res = _train_result(cfg, losses, params, opt)
    res["step_s"] = np.asarray(step_s)
    return res, mesh


def case_moe_forward(cfg: dict, inputs: dict, device):
    """The composed sequence-parallel MoE LM forward (ring attention),
    with the expert-parallel layer (``cfg["ep"]``) or every rank routing
    and computing its shard's experts itself (``moe_ffn_reference``):
    (logits gathered whole, this shard's aux)."""
    from functools import partial

    from nvshare_tpu_torch.models.moe_transformer import (
        moe_transformer_forward,
    )
    from nvshare_tpu_torch.parallel.collectives import gather
    from nvshare_tpu_torch.parallel.moe import moe_ffn_ep, moe_ffn_reference
    from nvshare_tpu_torch.parallel.ring_attention import (
        make_seq_mesh,
        ring_attention,
    )
    from nvshare_tpu_torch.parallel.seq_transformer import _local_block

    model = _moe_model(cfg)
    mesh = make_seq_mesh(device=device)
    params, _ = _moe_state(cfg, inputs, model, mesh.device)
    toks = _tokens(cfg, inputs, model, mesh.device)
    inputs_blk, _ = _local_block(mesh, toks, "seq", None)

    def moe_fn(mp, x2d):
        if cfg["ep"]:
            out, aux = moe_ffn_ep(mp, x2d, mesh=mesh, axis="seq",
                                  n_experts=model.experts,
                                  capacity_factor=model.capacity_factor)
            return out, aux[0]
        return moe_ffn_reference(mp, x2d, model.experts,
                                 capacity_factor=model.capacity_factor)

    with torch.no_grad():
        logits, aux = moe_transformer_forward(
            params, model, inputs_blk,
            partial(ring_attention, mesh=mesh, axis="seq", causal=True),
            moe_fn)
        logits = gather(logits, mesh, "seq", 1)
    res = {"aux": aux.item()}
    if mesh.rank == 0:
        res["logits"] = _np(logits)
    return res, mesh


def case_moe_lm_single(cfg: dict, inputs: dict, device):
    """The single-device ``moe_lm_train_step``, in one rank."""
    from nvshare_tpu_torch.models.moe_transformer import moe_lm_train_step

    model = _moe_model(cfg)
    dev = resolve_device(device)
    params, opt = _moe_state(cfg, inputs, model, dev)
    toks = _tokens(cfg, inputs, model, dev)
    losses, step_s = [], []
    for _ in range(cfg.get("steps", 1)):
        t0 = time.perf_counter()
        params, opt, loss = moe_lm_train_step(params, opt, toks, model,
                                              lr=cfg.get("lr", 1e-2))
        losses.append(loss.item())
        step_s.append(time.perf_counter() - t0)
    with torch.no_grad():
        res = _train_result(cfg, losses, params, opt)
    res["step_s"] = np.asarray(step_s)
    return res, None


def _stage_fn(cfg):
    from functools import partial

    from nvshare_tpu_torch.parallel.pipeline import (
        mlp_stage,
        transformer_stage,
    )

    if cfg.get("stage", "mlp") == "mlp":
        return mlp_stage
    return partial(transformer_stage, heads=cfg["heads"],
                   compute_dtype=_dtype(cfg.get("compute", "bfloat16")))


def _stage_params(cfg, inputs, n_stages, device):
    from nvshare_tpu_torch.parallel.pipeline import (
        init_pipeline_params,
        init_transformer_stage_params,
    )

    if cfg.get("params"):
        return {k: _tensor(v, device)
                for k, v in _inputs(inputs, cfg["params"]).items()}
    if cfg.get("stage", "mlp") == "mlp":
        return init_pipeline_params(n_stages, cfg["d"],
                                    seed=cfg.get("seed", 0), device=device)
    return init_transformer_stage_params(n_stages, cfg["d"],
                                         seed=cfg.get("seed", 0),
                                         device=device)


def _sequential(stage_fn, params: dict, xs: torch.Tensor) -> torch.Tensor:
    """Every microbatch through every stage in order, on one device."""
    outs = []
    for i in range(xs.shape[0]):
        h = xs[i]
        for s in range(next(iter(params.values())).shape[0]):
            h = stage_fn({k: v[s] for k, v in params.items()}, h)
        outs.append(h.float())
    return torch.stack(outs)


def case_pipeline(cfg: dict, inputs: dict, device):
    """``pipeline_forward_sharded`` (``cfg["mode"] == "forward"``) or
    ``cfg["steps"]`` of ``pipeline_train_step`` (``"train"``), one stage
    a rank. ``check``: each rank holds the output, or its stage's first
    gradient, against the sequential stages on one device (all stages'
    params are drawn on every rank) and returns the errors."""
    from nvshare_tpu_torch.parallel.pipeline import (
        local_stage,
        pipeline_forward_sharded,
        pipeline_train_step,
    )
    from nvshare_tpu_torch.parallel.ring_attention import make_seq_mesh

    mesh = make_seq_mesh(axis="pp", device=device)
    stage_fn = _stage_fn(cfg)
    params = _stage_params(cfg, inputs, mesh.size, mesh.device)
    if cfg.get("xs"):
        xs = _tensor(inputs[cfg["xs"]], mesh.device)
        ys = _tensor(inputs[cfg["ys"]], mesh.device)
    else:
        gen = _gen(mesh.device, cfg.get("seed", 0) + 1)
        xs = _normal(gen, cfg["xs_shape"], 0.5)
        ys = xs if cfg.get("ys_is_xs") else _normal(gen, cfg["xs_shape"],
                                                    0.5)
    res = {}
    if cfg.get("mode", "train") == "forward":
        out = pipeline_forward_sharded(mesh, stage_fn, axis="pp")(params, xs)
        if cfg.get("check"):
            with torch.no_grad():
                want = _sequential(stage_fn, params, xs)
            res["rel_err"] = rel_err(out, want)
        elif mesh.rank == 0:
            res["out"] = _np(out)
        return res, mesh
    # A check reads each gradient back from its update, (before - after)
    # / lr: at lr 1 the f32 subtraction keeps the gradient's digits.
    lr = 1.0 if cfg.get("check") else cfg.get("lr", 1e-2)
    local = local_stage(mesh, params, "pp")
    before = {k: v.clone() for k, v in local.items()} \
        if cfg.get("check") else None
    step = pipeline_train_step(mesh, stage_fn, axis="pp", lr=lr)
    losses = []
    for _ in range(cfg.get("steps", 1)):
        local, loss = step(local, xs, ys)
        losses.append(loss.item())
    res["losses"] = np.asarray(losses)
    if cfg.get("check"):
        i = mesh.axis_index("pp")
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_()
                      for k, v in params.items()}
            want = _sequential(stage_fn, leaves, xs)
            mse = ((want - ys.float()) ** 2).mean()
            g = dict(zip(leaves, torch.autograd.grad(
                mse, list(leaves.values()))))
        res["loss_want"] = mse.item()
        for k in local:
            got = (before[k] - local[k])[0] / lr
            res[f"rel_err/{k}"] = rel_err(got, g[k][i])
        return res, mesh
    res.update({f"params/{k}": _np(v) for k, v in local.items()})
    return res, mesh


def case_mlp(cfg: dict, inputs: dict, device):
    """``sharded_mlp_step`` on ``make_mesh`` (dp x tp) for
    ``cfg["steps"]`` steps; returns the losses and this rank's shards."""
    from nvshare_tpu_torch.convert import mlp_params_from_numpy
    from nvshare_tpu_torch.models.mlp import MLP
    from nvshare_tpu_torch.parallel.mesh import (
        _local,
        make_mesh,
        sharded_mlp_step,
        sharded_train_setup,
    )

    model = MLP(**cfg["model"])
    mesh = make_mesh(device=device)
    params, opt, x, y = sharded_train_setup(mesh, model, cfg["batch"],
                                            cfg.get("seed", 0))
    if cfg.get("params"):
        full = mlp_params_from_numpy(_inputs(inputs, cfg["params"]),
                                     device=mesh.device)
        params = {k: _local(mesh, k, v) for k, v in full.items()}
        opt = {"m": {k: torch.zeros_like(v) for k, v in params.items()}}
    step = sharded_mlp_step(mesh, model, lr=cfg.get("lr", 1e-3))
    losses = []
    for _ in range(cfg.get("steps", 1)):
        params, opt, loss = step(params, opt, x, y)
        losses.append(loss.item())
    res = {"losses": np.asarray(losses), "coords": np.asarray(mesh.coords),
           "shape": np.asarray(mesh.shape)}
    res.update({f"params/{k}": _np(v) for k, v in params.items()})
    return res, mesh


def case_mlp_single(cfg: dict, inputs: dict, device):
    """The single-process MLP ``train_step`` (the reference of
    ``case_mlp``)."""
    from nvshare_tpu_torch.models.mlp import (
        MLP,
        init_train_state,
        synthetic_batch,
        train_step,
    )

    model = MLP(**cfg["model"])
    dev = resolve_device(device)
    params, opt = init_train_state(model, cfg.get("seed", 0), device=dev)
    x, y = synthetic_batch(model, cfg["batch"], cfg.get("seed", 0))
    x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    losses = []
    for _ in range(cfg.get("steps", 1)):
        params, opt, loss = train_step(params, opt, x, y,
                                       lr=cfg.get("lr", 1e-3))
        losses.append(loss.item())
    res = {"losses": np.asarray(losses)}
    res.update({f"params/{k}": _np(v) for k, v in params.items()})
    return res, None


def case_gated_attention(cfg: dict, inputs: dict, device):
    """``case_attention`` with this rank a tenant of the scheduler at
    ``$TPUSHARE_SOCK_DIR``: the dispatch-mode gate on for the run
    (``TPUSHARE_FORCE_MULTIHOST=1`` lets the guard gate a multi-process
    program). Returns the result and the client's grants and releases by
    reason."""
    from nvshare_tpu_torch import interpose
    from nvshare_tpu_torch.telemetry.prometheus import render_text

    interpose.enable(device=resolve_device(device))
    if not interpose.enabled():
        raise RuntimeError("the gate refused this multi-process run (set "
                           "TPUSHARE_FORCE_MULTIHOST=1)")
    try:
        res, mesh = case_attention(cfg, inputs, device)
        counts = {}
        for line in render_text().splitlines():
            if line.startswith(("tpushare_lock_acquires_total",
                                "tpushare_lock_releases_total")):
                name, value = line.rsplit(" ", 1)
                counts[name] = float(value)
        res["lock_counts"] = json.dumps(counts)
    finally:
        interpose.disable()
        interpose._reset_client_for_tests()
    return res, mesh


def case_collectives(cfg: dict, inputs: dict, device):
    """The raw collectives on small known tensors: a ring ppermute, a
    partial permutation (0 -> n-1, 1 -> 0), a tiled all-to-all, and the
    gradients of sum(y * y.detach()) through the ring and the all-to-all,
    which the inverse collectives must bring back to x itself."""
    from nvshare_tpu_torch.parallel.collectives import (
        all_to_all,
        ppermute,
        ring_perm,
    )
    from nvshare_tpu_torch.parallel.ring_attention import make_seq_mesh

    mesh = make_seq_mesh(device=device)
    n, i = mesh.size, mesh.rank
    x = torch.arange(n * 4 * 6, dtype=torch.float32).reshape(n * 4, 6)
    x = x[i * 4:(i + 1) * 4].to(mesh.device)
    xa = torch.arange(n * 4 * 8, dtype=torch.float32).reshape(n * 4, 8)
    xa = xa[i * 4:(i + 1) * 4].to(mesh.device)
    res = {"part": _np(ppermute(x, mesh, "seq", [(0, n - 1), (1, 0)]))}
    with torch.enable_grad():
        xr = x.clone().requires_grad_()
        y = ppermute(xr, mesh, "seq", ring_perm(n))
        (g,) = torch.autograd.grad((y * y.detach()).sum(), xr)
        res.update(ring=_np(y), ring_grad=_np(g), ring_grad_want=_np(x))
        xg = xa.clone().requires_grad_()
        y = all_to_all(xg, mesh, "seq", split_dim=1, concat_dim=0)
        (g,) = torch.autograd.grad((y * y.detach()).sum(), xg)
        res.update(a2a=_np(y), a2a_grad=_np(g), a2a_grad_want=_np(xa))
    # all_reduce_sum over tensors of 5, 13 and 3 entries (one flat
    # buffer), against one all-reduce of their concatenation, on integers
    # so that the sums are exact in any order.
    from nvshare_tpu_torch.parallel.collectives import all_reduce_sum

    _, group = mesh.group("seq")
    flats = [(torch.arange(k, dtype=torch.float32) * (i + 1) + k)
             .to(mesh.device) for k in (5, 13, 3)]
    want = torch.cat(flats)
    torch.distributed.all_reduce(want, group=group)
    all_reduce_sum(mesh, "seq", flats)
    res.update(summed=_np(torch.cat(flats)), summed_want=_np(want))
    return res, mesh


def case_guard(cfg: dict, inputs: dict, device):
    """``interpose.enable`` in a multi-process run: the guard's decision
    (without ``TPUSHARE_FORCE_MULTIHOST`` it refuses, and the rank stays
    unmanaged)."""
    from nvshare_tpu_torch import interpose

    interpose.enable(device=resolve_device(device))
    res = {"gated": interpose.enabled()}
    interpose.disable()
    return res, None


CASES = {
    "attention": case_attention,
    "guard": case_guard,
    "collectives": case_collectives,
    "gated_attention": case_gated_attention,
    "seq_lm": case_seq_lm,
    "lm_single": case_lm_single,
    "moe_ffn": case_moe_ffn,
    "moe_lm": case_moe_lm,
    "moe_forward": case_moe_forward,
    "moe_lm_single": case_moe_lm_single,
    "pipeline": case_pipeline,
    "mlp": case_mlp,
    "mlp_single": case_mlp_single,
}


# -- the rank process --------------------------------------------------------

def _launch_counts() -> dict:
    from nvshare_tpu_torch.ops.attention import (
        flash_attention,
        flash_backward_dkv,
        flash_backward_dq,
    )

    return {name: {route: c.value for route, c in fn.route_launches.items()}
            for name, fn in (("flash_attention", flash_attention),
                             ("flash_backward_dq", flash_backward_dq),
                             ("flash_backward_dkv", flash_backward_dkv))}


def _diff(after: dict, before: dict) -> dict:
    return {k: {r: n - before[k][r] for r, n in v.items()}
            for k, v in after.items()}


def run_cases(cases: List[dict], inputs: dict, device, rank: int = 0,
              world: int = 1, backend: str = "none") -> tuple:
    """Run ``cases`` in this process, as rank ``rank`` of ``world`` (the
    process group, if any, already joined). Returns (arrays by
    ``<case>/<key>``, meta: the backend, and per case its seconds, the
    collectives' bytes and seconds, the flash kernels' launches by route,
    peak device memory and the non-array results)."""
    dev = resolve_device(device)
    arrays: Dict[str, np.ndarray] = {}
    meta = {"rank": rank, "world": world, "backend": backend,
            "device": str(dev), "cases": {}}
    for spec in cases:
        cfg = dict(spec)
        name, fn = cfg.pop("name"), CASES[spec["case"]]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        before = _launch_counts()
        t0 = time.perf_counter()
        if cfg.pop("expect_error", False):
            # A case that must refuse its arguments, before any
            # collective: record the refusal instead of failing.
            try:
                fn(cfg, inputs, device)
                res = {"error": ""}
            except (ValueError, TypeError) as e:
                res = {"error": f"{type(e).__name__}: {e}"}
            mesh = None
        else:
            res, mesh = fn(cfg, inputs, device)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rec = {"seconds": time.perf_counter() - t0,
               "backend": backend,
               "staged": bool(mesh and mesh.staged),
               "transport": mesh.stats.as_dict() if mesh else {},
               "launches": _diff(_launch_counts(), before),
               "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else 0),
               "scalars": {}}
        for k, v in res.items():
            if isinstance(v, np.ndarray):
                arrays[f"{name}/{k}"] = v
            else:
                rec["scalars"][k] = v
        meta["cases"][name] = rec
        print(f"rank {rank} {name}: " + json.dumps(
            {k: rec[k] for k in ("seconds", "backend", "transport",
                                 "peak_bytes")}), flush=True)
        del res, mesh
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return arrays, meta


def _result(meta: dict, arrays: dict, log: str = "") -> dict:
    """One rank's results as :func:`spawn` returns them."""
    res: dict = {"meta": meta, "log": log}
    for name, rec in meta["cases"].items():
        res[name] = dict(rec["scalars"])
    for key, v in arrays.items():
        name, k = key.split("/", 1)
        res[name][k] = v
    return res


def run_local(cases: List[dict], *, device: str = "cuda",
              inputs: Optional[Dict[str, np.ndarray]] = None) -> dict:
    """``cases`` at world 1 in this process (no process group, no process
    start): the result of one rank, as :func:`spawn` returns it."""
    arrays, meta = run_cases(cases, inputs or {}, device)
    return _result(meta, arrays)


def rank_main(rank: int, world: int, device: str, init_file: str,
              out_dir: str) -> int:
    """One rank: join the group, run the cases of ``out_dir/cases.json``
    on the arrays of ``out_dir/inputs.npz``, write ``rank<r>.npz`` and
    ``rank<r>.json``."""
    out = Path(out_dir)
    cases = json.loads((out / "cases.json").read_text())
    inputs_path = out / "inputs.npz"
    inputs = dict(np.load(inputs_path)) if inputs_path.exists() else {}
    if device == "cpu":
        torch.set_num_threads(1)
    backend = "none"
    if world > 1:
        _, backend = init_ranks(rank, world, init_file, device)
    try:
        arrays, meta = run_cases(cases, inputs, device, rank, world,
                                 backend)
    finally:
        shutdown_ranks()
    np.savez(out / f"rank{rank}.npz", **arrays)
    (out / f"rank{rank}.json").write_text(json.dumps(meta))
    return 0


# -- the launcher ------------------------------------------------------------

class RankFailure(RuntimeError):
    """A rank exited non-zero or outlived the time limit. ``logs`` holds
    every rank's whole output by rank."""

    def __init__(self, msg: str, logs: Dict[int, str]):
        super().__init__(msg)
        self.logs = logs


def spawn(world: int, cases: List[dict], *, device: str = "cuda",
          inputs: Optional[Dict[str, np.ndarray]] = None,
          timeout_s: float = 300.0, env: Optional[dict] = None,
          workdir: Optional[str] = None) -> List[dict]:
    """Run ``cases`` (dicts with ``name``, ``case`` and the case's
    arguments) in ``world`` rank processes on ``device`` (each rank's
    own when there are enough cards, else one card shared; ``cpu`` when
    asked). ``inputs`` are numpy arrays every rank reads. Returns, per
    rank, ``{"meta": ..., case name: {key: array or number}}``. Raises
    :class:`RankFailure` with the failing rank's output when any rank
    fails or the run outlives ``timeout_s``; every rank is stopped."""
    resolve_device(device)           # no card: raise here, not in a rank
    tmp = tempfile.mkdtemp(prefix="tpushare-ranks-", dir=workdir)
    out = Path(tmp)
    (out / "cases.json").write_text(json.dumps(cases))
    if inputs:
        np.savez(out / "inputs.npz", **inputs)
    init_file = str(out / "store")
    child_env = dict(os.environ, **(env or {}))
    child_env["PYTHONPATH"] = os.pathsep.join(
        [str(PKG_ROOT)] + [p for p in child_env.get("PYTHONPATH", "")
                           .split(os.pathsep) if p])
    procs, logs = [], []
    for r in range(world):
        log = open(out / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-u", "-X", "faulthandler", "-m",
             "nvshare_tpu_torch.parallel.dryrun", "--rank", str(r),
             "--world", str(world), "--device", device, "--init-file",
             init_file, "--out", tmp],
            env=child_env, stdout=log, stderr=subprocess.STDOUT))
    failed = None
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = (bad[0], f"exited {procs[bad[0]].returncode}")
                break
            if time.monotonic() > deadline:
                failed = (next(r for r, p in enumerate(procs)
                               if p.poll() is None),
                          f"outlived {timeout_s} s")
                break
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = (bad[0], f"exited {procs[bad[0]].returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGABRT)   # faulthandler: stacks
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if failed is not None:
        rank, why = failed
        texts = {r: (out / f"rank{r}.log").read_text() for r in range(world)}
        raise RankFailure(f"rank {rank} of {world} {why}; its output "
                          f"(all in {tmp}):\n{texts[rank][-6000:]}", texts)
    results = []
    for r in range(world):
        with np.load(out / f"rank{r}.npz") as z:
            arrays = {key: z[key] for key in z.files}
        results.append(_result(
            json.loads((out / f"rank{r}.json").read_text()), arrays,
            (out / f"rank{r}.log").read_text()))
    for f in out.iterdir():
        f.unlink()
    out.rmdir()
    return results


# -- the battery ---------------------------------------------------------------

def battery(world: int) -> List[dict]:
    """Every axis of ``__graft_entry__.dryrun_multichip`` at small shapes,
    for ``world`` ranks."""
    tiny_lm = dict(vocab=64, dim=32, heads=4, depth=1, seq=16 * world,
                   rope=True)
    rows = 2 if world % 2 == 0 and world > 2 else 1
    return [
        dict(name="mlp", case="mlp", model=dict(in_dim=64, hidden_dim=128,
                                                out_dim=32, depth=2),
             batch=8 * world),
        dict(name="ring", case="attention", impl="ring", causal=True,
             shape=[1, 8 * world, 2, 16], check=True),
        dict(name="ring_kernel", case="attention", impl="ring", causal=True,
             shape=[1, 128 * world, 1, 32], grads=True, check=True),
        dict(name="ulysses", case="attention", impl="ulysses", causal=True,
             shape=[1, 128, world, 16], check=True),
        dict(name="seq_lm", case="seq_lm", model=tiny_lm, batch=2),
        dict(name="moe_ffn", case="moe_ffn", experts=world, d=16, hidden=32,
             tokens=8 * world, check=True),
        dict(name="pipeline", case="pipeline", d=16,
             xs_shape=[2 * world, 2, 16], ys_is_xs=True),
        dict(name="moe_lm", case="moe_lm",
             model=dict(vocab=64, dim=32, heads=4, depth=1, seq=16 * world,
                        experts=world, mlp_mult=2), batch=2),
        dict(name="dp_sp", case="seq_lm", mesh=[rows, world // rows],
             model=dict(tiny_lm, seq=16 * (world // rows)), batch=2 * rows),
    ]


def check_battery(results: List[dict], world: int) -> str:
    """Assert the battery's results; returns the summary line."""
    r0 = results[0]
    for name in ("ring", "ring_kernel", "ulysses"):
        errs = {k: v for k, v in r0[name].items() if k.startswith("err")}
        if not errs or max(errs.values()) > 1e-4:
            raise AssertionError(f"{name}: tile-wise error against "
                                 f"single-device attention {errs}")
    for r in results:
        if r["moe_ffn"]["max_abs_err"] > 2e-5:
            raise AssertionError(f"moe_ffn rank {r['meta']['rank']}: "
                                 f"{r['moe_ffn']}")
    losses = {n: float(r0[n]["losses"][-1]) for n in ("mlp", "seq_lm",
                                                      "pipeline", "moe_lm",
                                                      "dp_sp")}
    for n, v in losses.items():
        if not math.isfinite(v) or (n != "pipeline" and v <= 0.0):
            raise AssertionError(f"{n}: loss {v}")
        if any(float(r[n]["losses"][-1]) != v for r in results):
            raise AssertionError(f"{n}: the ranks' losses differ")
    shape = tuple(int(s) for s in r0["mlp"]["shape"])
    return (f"dryrun({world}): OK, backend={r0['meta']['backend']}, "
            f"mlp mesh={shape}, loss={losses['mlp']:.4f}, "
            f"ring_attention=exact over {world} ranks, "
            f"ring_flash_kernel=exact (seq/n=128 kernel path, grads), "
            f"ulysses=exact (heads={world} all-to-all + kernel), "
            f"seq_sharded_lm_step=ok (loss={losses['seq_lm']:.4f}), "
            f"ep_moe=exact ({world} experts, all_to_all dispatch), "
            f"pp_gpipe_train_step=ok (loss={losses['pipeline']:.4f}), "
            f"sp+ep_moe_lm_step=ok (loss={losses['moe_lm']:.4f}), "
            f"dp_x_sp_step=ok (loss={losses['dp_sp']:.4f})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--init-file", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args.rank, args.world, args.device,
                         args.init_file, args.out)
    results = spawn(args.world, battery(args.world), device=args.device,
                    timeout_s=args.timeout)
    for r in results:
        print(f"rank {r['meta']['rank']}: " + json.dumps(
            {n: {k: rec[k] for k in ("seconds", "transport")}
             for n, rec in r["meta"]["cases"].items()}))
    print(check_battery(results, args.world))
    return 0


if __name__ == "__main__":
    sys.exit(main())
