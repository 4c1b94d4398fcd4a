"""Autoregressive decoding with a KV cache: the port of
``nvshare_tpu/models/decode.py``.

Each new token attends to the cached per-layer K/V instead of re-running
the full forward. The cache is a static ``[B, max_len, H, Dh]`` bf16
buffer per layer and kind, written IN PLACE at the decoded position: run
under :func:`nvshare_tpu_torch.vmem.vop` with the cache donated, a step
updates the cache's device buffers without a second copy of them.

:func:`decode_step` runs the shared
:func:`~nvshare_tpu_torch.models.transformer.transformer_block` with s=1,
so scoring and decoding execute one block recipe. The JAX package scans
the generation loop; eagerly it is a Python loop.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from nvshare_tpu_torch.device import DeviceLike
from nvshare_tpu_torch.models.transformer import (
    Transformer,
    _dense_ffn,
    _embed,
    lm_head,
    model_device,
    transformer_block,
)

_NEG_INF = -1e30


def init_kv_cache(model: Transformer, batch: int, max_len: int,
                  device: DeviceLike = None) -> dict:
    """Per-layer K/V buffers [B, max_len, H, Dh] (bf16, like the compute
    dtype that fills them), zeros, on ``device`` (default ``cuda``)."""
    dev = model_device(device)
    shape = (batch, max_len, model.heads, model.head_dim)
    return {
        f"{kv}{i}": torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        for i in range(model.depth) for kv in ("k", "v")
    }


def _cached_attention(q, k_new, v_new, cache_k, cache_v, pos: int,
                      rope: bool = False):
    """One-position attention against the cache.

    q, k_new, v_new: [B, 1, H, Dh] (this position); the cache holds
    positions < pos. Writes the new K/V into the cache at ``pos`` in place
    and returns attn [B, 1, H, Dh]. With ``rope``, q
    and the new key are rotated at ``pos`` first: the cache stores rotated
    keys. The JAX function scores every cache position and masks those
    after ``pos`` with -1e30, whose weights are exactly 0; this one scores
    positions 0..pos only, the same sums without the masked zeros.
    """
    pos = int(pos)
    if rope:
        from nvshare_tpu_torch.ops.rope import rope_rotate

        pos_arr = torch.arange(pos, pos + 1, device=q.device)  # no copy
        q = rope_rotate(q, pos_arr)
        k_new = rope_rotate(k_new, pos_arr)
    cache_k[:, pos] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v_new[:, 0].to(cache_v.dtype)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,blhd->bhql", q.float(),
                     cache_k[:, :pos + 1].float()) * scale   # [B,H,1,pos+1]
    p = torch.softmax(s, dim=-1)
    attn = torch.einsum("bhql,blhd->bqhd", p, cache_v[:, :pos + 1].float())
    return attn.to(q.dtype)


def decode_step(params: dict, model: Transformer, cache: dict, pos: int,
                token: torch.Tensor):
    """One decode position: token [B] int at position ``pos`` ->
    (logits [B, vocab] f32, cache). The cache's buffers are updated in
    place; the returned dict holds the same tensors."""
    h = _embed(params, token)[:, None, :]                    # [B, 1, D]
    new_cache = dict(cache)
    rope = getattr(model, "rope", False)
    for i in range(model.depth):
        bp = {"qkv": params[f"qkv{i}"], "proj": params[f"proj{i}"],
              "ln1": params[f"ln1_{i}"], "ln2": params[f"ln2_{i}"]}

        def attn_fn(q, k, v, _i=i):
            return _cached_attention(q, k, v, new_cache[f"k{_i}"],
                                     new_cache[f"v{_i}"], pos, rope=rope)

        h, _ = transformer_block(
            bp, h, heads=model.heads, attn_fn=attn_fn,
            ffn=lambda z, _i=i: _dense_ffn(params, _i, z))
    return lm_head(params, h)[:, 0, :], new_cache


def _generate(params: dict, prompt: torch.Tensor, model: Transformer,
              new_tokens: int, select: Callable) -> torch.Tensor:
    """Prefill + generation, one position at a time: ``select(logits
    [B, V]) -> token [B]`` picks the next token; positions inside the
    prompt teacher-force the given prompt token regardless."""
    b, p_len = prompt.shape
    total = p_len + new_tokens
    cache = init_kv_cache(model, b, total, device=prompt.device)
    out = torch.zeros((b, total), dtype=torch.int32, device=prompt.device)
    out[:, :p_len] = prompt
    token = prompt[:, 0]
    for pos in range(total - 1):
        logits, cache = decode_step(params, model, cache, pos, token)
        nxt = select(logits).to(torch.int32)
        token = prompt[:, pos + 1] if pos + 1 < p_len else nxt
        out[:, pos + 1] = token
    return out


def greedy_generate(params: dict, prompt: torch.Tensor, model: Transformer,
                    new_tokens: int) -> torch.Tensor:
    """Greedy decoding: prompt [B, P] int -> tokens [B, P+new_tokens]
    int32."""
    return _generate(params, prompt, model, new_tokens,
                     lambda logits: torch.argmax(logits, dim=-1))


def sample_generate(params: dict, prompt: torch.Tensor, model: Transformer,
                    new_tokens: int, generator: torch.Generator,
                    temperature: float = 1.0, top_k: int = 0,
                    ) -> torch.Tensor:
    """Stochastic decoding: temperature-scaled, optionally top-k-truncated
    categorical sampling per position, drawn from ``generator`` (on the
    prompt's device). ``top_k=0`` keeps the full distribution; ``top_k=1``
    or temperature -> 0 degenerate to greedy. Deterministic in the
    generator's state; the draws cannot match ``jax.random.categorical``'s
    for any key."""
    temperature = max(float(temperature), 1e-4)

    def select(logits: torch.Tensor) -> torch.Tensor:
        scaled = logits.float() / temperature
        if top_k > 0:
            kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
            scaled = torch.where(scaled >= kth, scaled, _NEG_INF)
        probs = torch.softmax(scaled, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    return _generate(params, prompt, model, new_tokens, select)


def greedy_step(params: dict, model: Transformer, cache: dict, pos: int,
                token: torch.Tensor):
    """:func:`decode_step` with the greedy choice made on the device:
    (next token [B] int64, cache). The serving loop's step, run through
    ``vop`` with the model static and the cache donated; ``pos`` may stay
    dynamic (it sets no output shape), so one meta pass sizes every
    position."""
    logits, cache = decode_step(params, model, cache, pos, token)
    return torch.argmax(logits, dim=-1), cache

