"""A causal transformer LM: the inference half of
``nvshare_tpu/models/transformer.py``.

Pre-norm blocks with RMSNorm, a tanh-gelu MLP, multi-head attention
through the flash kernel (:func:`~nvshare_tpu_torch.ops.flash_attention`),
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
keep the f32 result, through :func:`_matmul_f32`. Training (the loss, the
optimizer update, the train step) comes with the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

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
    remat: bool = False  # checkpointing comes with training; no forward change
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


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of bf16 operands with an f32 result, as a JAX matmul with
    ``preferred_element_type=f32``: on the card PyTorch's ``mm`` with
    ``out_dtype`` (tensor cores, f32 accumulation and result); elsewhere
    (the CPU has no such ``mm``, and the meta pass only needs the shape)
    the bf16 operands multiplied in f32."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda":
        out = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        out = x2.float() @ w.float()
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
    aux). ``ffn_fn(params, i, x) -> (y f32, aux)``. ``model.remat`` is
    accepted and changes no forward value."""
    h = _embed(params, tokens)                              # [B, S, D]
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(model.depth):
        bp = {"qkv": params[f"qkv{i}"], "proj": params[f"proj{i}"],
              "ln1": params[f"ln1_{i}"], "ln2": params[f"ln2_{i}"]}
        h, aux = transformer_block(
            bp, h, heads=model.heads, attn_fn=attn_fn,
            ffn=lambda z, _i=i: ffn_fn(params, _i, z))
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
