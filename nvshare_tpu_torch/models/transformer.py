"""A causal transformer LM: the port of ``nvshare_tpu/models/transformer.py``.

Pre-norm blocks with RMSNorm, a tanh-gelu MLP, multi-head attention
through the flash kernels (:func:`~nvshare_tpu_torch.ops.flash_attention`),
optional RoPE on q/k and a tied embedding head; f32 master parameters,
bf16 compute. Parameters are a plain dict with the JAX package's names,
so :func:`nvshare_tpu_torch.convert.transformer_params_from_numpy` carries
a JAX parameter tree across.

Products. A JAX matmul with ``preferred_element_type=f32`` gives an f32
result from bf16 operands. Where the JAX block casts that result to bf16
anyway (qkv, proj, and the FFN's down projection before the residual add)
the port takes PyTorch's bf16 product, which accumulates in f32 and rounds
its result to bf16 once: the same values up to summation order. The FFN's
up projection (whose f32 result feeds the gelu) and the head (f32 logits)
keep the f32 result, through :func:`_matmul_f32`, whose backward is its
own (see :class:`_MatmulF32`).

Training: :func:`_lm_loss` (next-token cross-entropy), the momentum-SGD
update :func:`sgd_momentum_update`, :func:`lm_train_step`,
:func:`init_lm_state`, and :func:`make_optim_lm_step` for any
``torch.optim`` optimizer. ``Transformer.remat`` recomputes every block in
the backward (:func:`torch.utils.checkpoint.checkpoint`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from nvshare_tpu_torch.device import DeviceLike, resolve_device
from nvshare_tpu_torch.device import generator as _seeded
from nvshare_tpu_torch.ops.attention import flash_attention

_CDT = torch.bfloat16


def model_device(device: DeviceLike) -> torch.device:
    """``device`` resolved as every entry point resolves it (``cuda`` by
    default), except that ``meta`` passes through: :func:`vmem.vop` sizes
    a function's outputs by running it on the meta device."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


@dataclass(frozen=True)
class Transformer:
    vocab: int = 256
    dim: int = 128
    heads: int = 4
    depth: int = 2
    seq: int = 128
    mlp_mult: int = 4
    remat: bool = False  # recompute blocks in the backward (forward_blocks)
    rope: bool = False   # rotary position embeddings on q/k (ops/rope.py)

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    def init(self, seed: int = 0, device: DeviceLike = None,
             generator: Optional[torch.Generator] = None) -> dict:
        """f32 master parameters with the JAX package's names and scales
        (normal, std ``fan_in ** -0.5``; norm gains 1), drawn on ``device``
        from ``generator`` (default: one seeded with ``seed``). The bits
        differ from ``jax.random``'s for the same seed."""
        dev = model_device(device)
        gen = generator
        if gen is None and dev.type != "meta":
            gen = _seeded(dev, seed)

        def dense(shape, fan_in):
            w = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev)
            return w.mul_((1.0 / fan_in) ** 0.5)

        d, f = self.dim, self.mlp_mult * self.dim
        params = {"embed": dense((self.vocab, d), d)}
        for i in range(self.depth):
            params[f"qkv{i}"] = dense((d, 3 * d), d)
            params[f"proj{i}"] = dense((d, d), d)
            params[f"up{i}"] = dense((d, f), d)
            params[f"down{i}"] = dense((f, d), f)
            params[f"ln1_{i}"] = torch.ones(d, dtype=torch.float32,
                                            device=dev)
            params[f"ln2_{i}"] = torch.ones(d, dtype=torch.float32,
                                            device=dev)
        params["ln_f"] = torch.ones(d, dtype=torch.float32, device=dev)
        return params


def _rmsnorm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + 1e-6)
    return (x32 * scale * g).to(x.dtype)


def _matmul_f32_grads(x2: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                      tensor_cores: bool) -> tuple:
    """(dx, dw) of ``x2 @ w`` with an f32 result, in x2's and w's (bf16)
    types, for the f32 cotangent ``g``.

    JAX transposes a ``preferred_element_type=f32`` product into f32
    products of ``g`` and the other bf16 operand, rounded to bf16 once.
    ``tensor_cores=False`` computes exactly that (in f32: the CPU and meta
    route). ``tensor_cores=True`` rounds ``g`` to bf16 first and takes
    bf16 products with f32 accumulation, the card's route: an f32 product
    of these sizes runs on the CUDA cores at a fifteenth of the
    tensor-core rate. The two differ by the rounding of ``g`` (relative
    2**-9 an element, averaged over the sum); the tests and
    ``chip_smoke.py`` state the tolerance."""
    if tensor_cores:
        gb = g.to(x2.dtype)
        return torch.mm(gb, w.t()), torch.mm(x2.t(), gb)
    return ((g @ w.float().t()).to(x2.dtype),
            (x2.float().t() @ g).to(w.dtype))


class _MatmulF32(torch.autograd.Function):
    """``x2 @ w`` of bf16 operands with an f32 result. PyTorch has no
    derivative for ``mm`` with ``out_dtype``, so the backward is this
    Function's own (:func:`_matmul_f32_grads`)."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        if x2.device.type == "cuda":
            # Tensor cores, f32 accumulation and result.
            return torch.mm(x2, w, out_dtype=torch.float32)
        # The CPU has no such mm, and the meta pass only needs the shape.
        return x2.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        return _matmul_f32_grads(x2, w, g, x2.device.type == "cuda")


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of bf16 operands with an f32 result, as a JAX matmul with
    ``preferred_element_type=f32`` (:class:`_MatmulF32`)."""
    out = _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def dense_ffn(up_w: torch.Tensor, down_w: torch.Tensor, x: torch.Tensor,
              compute_dtype: torch.dtype = _CDT) -> torch.Tensor:
    """The dense gelu-MLP FFN (up/down projections), f32 out. ``jax.nn.gelu``
    defaults to the tanh approximation, and so does this. The down product
    is rounded to bf16 (the block rounds it before the residual add)."""
    up = _matmul_f32(x, up_w.to(compute_dtype))
    act = F.gelu(up, approximate="tanh").to(compute_dtype)
    return torch.matmul(act, down_w.to(compute_dtype)).float()


def _dense_ffn(params: dict, i: int, x: torch.Tensor):
    """forward_blocks' default ffn_fn: dense MLP from layer-i params."""
    return (dense_ffn(params[f"up{i}"], params[f"down{i}"], x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def transformer_block(bp: dict, h: torch.Tensor, *, heads: int,
                      attn_fn: Callable, ffn: Callable,
                      compute_dtype: torch.dtype = _CDT):
    """The pre-norm block: rmsnorm -> qkv -> attention -> proj -> rmsnorm
    -> FFN, both residual. ``bp``: {"qkv" [D,3D], "proj" [D,D], "ln1" [D],
    "ln2" [D]}; ``h`` [B, S, D] in ``compute_dtype``; ``ffn(z) -> (y f32,
    aux)``. q, k and v reach ``attn_fn`` as strided views of the fused
    projection. Returns (h', aux)."""
    cdt = compute_dtype
    b, s, d = h.shape
    z = _rmsnorm(h, bp["ln1"])
    qkv = torch.matmul(z, bp["qkv"].to(cdt))
    q, k, v = torch.split(qkv, d, dim=-1)
    shp = (b, s, heads, d // heads)
    attn = attn_fn(q.reshape(shp), k.reshape(shp), v.reshape(shp))
    h = h + torch.matmul(attn.reshape(b, s, d), bp["proj"].to(cdt))
    z = _rmsnorm(h, bp["ln2"])
    y, aux = ffn(z)
    return h + y.to(cdt), aux


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    # Gathering rows, then casting, equals casting the whole table first:
    # without the vocab x dim cast on every call.
    return params["embed"][tokens.long()].to(_CDT)


def forward_blocks(params: dict, model, tokens: torch.Tensor,
                   attn_fn: Callable, ffn_fn: Callable):
    """The block stack: tokens [B, S] -> (logits [B, S, vocab] f32, mean
    aux). ``ffn_fn(params, i, x) -> (y f32, aux)``.

    ``model.remat`` runs every block under
    :func:`torch.utils.checkpoint.checkpoint` (non-reentrant) when a
    gradient is being recorded: the backward recomputes each block's
    internals from its input instead of keeping them, so activation
    memory falls from depth x intermediates to depth x block inputs, at
    the price of a second forward (attention runs twice a layer). The
    values are the same bits as without it."""
    h = _embed(params, tokens)                              # [B, S, D]
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    remat = getattr(model, "remat", False) and torch.is_grad_enabled()
    for i in range(model.depth):
        bp = {"qkv": params[f"qkv{i}"], "proj": params[f"proj{i}"],
              "ln1": params[f"ln1_{i}"], "ln2": params[f"ln2_{i}"]}

        def block(h, bp=bp, i=i):
            return transformer_block(
                bp, h, heads=model.heads, attn_fn=attn_fn,
                ffn=lambda z: ffn_fn(params, i, z))

        if remat:
            # No random draws in a block, so no RNG state to carry.
            h, aux = checkpoint(block, h, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            h, aux = block(h)
        aux_total = aux_total + aux
    return lm_head(params, h), aux_total / model.depth


def lm_head(params: dict, h: torch.Tensor) -> torch.Tensor:
    """Final rmsnorm + tied embedding head: f32 logits of the bf16 hidden
    states and the bf16-rounded embedding."""
    h = _rmsnorm(h, params["ln_f"])
    return _matmul_f32(h, params["embed"].to(_CDT).t())


def local_attn(model, attention: Callable = flash_attention) -> Callable:
    """The single-device attention slot: ``attention(q, k, v,
    causal=True)`` (the flash kernel by default), with RoPE on q/k at
    positions arange(S) when the model asks for it."""
    def attn(q, k, v):
        if getattr(model, "rope", False):
            from nvshare_tpu_torch.ops.rope import rope_rotate

            pos = torch.arange(q.shape[1], device=q.device)
            q, k = rope_rotate(q, pos), rope_rotate(k, pos)
        return attention(q, k, v, causal=True)

    return attn


def transformer_forward(params: dict, model: Transformer,
                        tokens: torch.Tensor,
                        attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """tokens [B, S] int -> logits [B, S, vocab] f32 (causal LM)."""
    if attn_fn is None:
        attn_fn = local_attn(model)
    logits, _ = forward_blocks(params, model, tokens, attn_fn, _dense_ffn)
    return logits


def synthetic_tokens(model: Transformer, batch: int, seed: int = 0
                     ) -> np.ndarray:
    """The JAX package's synthetic corpus, bit for bit: token t+1 =
    (t + 3) % vocab with a few noise flips; [batch, seq + 1] int32."""
    rng = np.random.RandomState(seed)
    start = rng.randint(0, model.vocab, size=(batch, 1))
    ramp = (start + np.arange(model.seq + 1)[None, :] * 3) % model.vocab
    noise = rng.rand(batch, model.seq + 1) < 0.02
    ramp[noise] = rng.randint(0, model.vocab, size=noise.sum())
    return ramp.astype(np.int32)


# -- training ----------------------------------------------------------------

def _lm_loss(params: dict, model: Transformer, tokens: torch.Tensor,
             attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Mean next-token cross-entropy of tokens [B, S+1]: the forward on
    ``tokens[:, :-1]`` scored against ``tokens[:, 1:]``. ``attn_fn`` as
    in :func:`transformer_forward`."""
    logits = transformer_forward(params, model, tokens[:, :-1], attn_fn)
    logp = F.log_softmax(logits.float(), dim=-1)
    targets = tokens[:, 1:].long().unsqueeze(-1)
    return -logp.gather(-1, targets).mean()


def lm_loss_and_grads(params: dict, model: Transformer,
                      tokens: torch.Tensor,
                      attn_fn: Optional[Callable] = None) -> tuple:
    """(loss, {name: gradient}) of :func:`_lm_loss` at ``params`` (the
    counterpart of ``jax.value_and_grad(_lm_loss)``). ``params`` are not
    changed and gain no gradient; the loss comes back detached."""
    with torch.enable_grad():
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss = _lm_loss(leaves, model, tokens, attn_fn)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def sgd_momentum_update(params: dict, opt_state: dict, grads: dict,
                        lr: float) -> tuple[dict, dict]:
    """The one shared optimizer update, momentum 0.9 SGD: m = 0.9 m + g,
    p = p - lr m. In place on ``params`` and ``opt_state["m"]`` (the
    counterpart of the JAX step's donated state); returns them."""
    with torch.no_grad():
        for name, p in params.items():
            m = opt_state["m"][name]
            m.mul_(0.9).add_(grads[name])
            p.sub_(m * lr)
    return params, opt_state


def lm_train_step(params: dict, opt_state: dict, tokens: torch.Tensor,
                  model: Transformer, lr: float = 1e-2) -> tuple:
    """One momentum-SGD LM step: ``(params, opt_state, loss)``.

    PyTorch has no buffer donation, so the update runs in place on the
    parameter and momentum storage it is given (under :func:`vmem.vop`,
    pass both in ``donate_argnums``). The peak is then one copy of the
    state, plus the f32 gradients, plus the activations the backward
    keeps (one block input a layer with ``model.remat``), never a second
    copy of the state. The loss comes back detached, and the returned
    tensors carry no autograd graph."""
    loss, grads = lm_loss_and_grads(params, model, tokens)
    sgd_momentum_update(params, opt_state, grads, lr)
    return params, opt_state, loss


def make_optim_lm_step(model: Transformer,
                       optimizer: torch.optim.Optimizer) -> Callable:
    """An LM train step driven by a ``torch.optim`` optimizer (AdamW,
    schedules, ...) instead of the built-in momentum SGD: the counterpart
    of ``make_optax_lm_step``. Returns ``step(params, tokens) -> loss``;
    ``params`` is the dict of leaf tensors (``requires_grad=True``) the
    optimizer was built over, updated in place, and the optimizer holds
    its own state."""
    def step(params: dict, tokens: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = _lm_loss(params, model, tokens)
            loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def init_lm_state(model: Transformer, seed: int = 0,
                  device: DeviceLike = None) -> tuple[dict, dict]:
    """(params, {"m": zero momentum}) on ``device`` (default ``cuda``)."""
    params = model.init(seed, device=device)
    return params, {"m": {k: torch.zeros_like(p) for k, p in params.items()}}
