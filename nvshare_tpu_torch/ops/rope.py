"""Rotary position embeddings (RoPE).

The port of ``nvshare_tpu/ops/rope.py``: rotation by ABSOLUTE position,
applied to q/k before attention, so the flash kernel sees pre-rotated
inputs and the KV cache stores rotated keys. The rotation math runs in f32
whatever the input dtype (angles at bf16 lose position resolution fast);
the output is cast back.
"""

from __future__ import annotations

import torch


def rope_rotate(x: torch.Tensor, positions: torch.Tensor,
                base: float = 10000.0) -> torch.Tensor:
    """Rotate x [B, S, H, D] by per-position angles; positions [S] int.

    Standard RoPE pairing: dimension i pairs with i + D/2 (the
    "rotate-half" layout), frequency base^(-2i/D).
    """
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"RoPE requires an even head dim, got {d} "
                         "(dimensions rotate in pairs)")
    half = d // 2
    freqs = 1.0 / (base ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half))
    ang = positions.to(device=x.device, dtype=torch.float32)[:, None] \
        * freqs[None, :]
    cos = torch.cos(ang)[None, :, None, :]              # [1, S, 1, half]
    sin = torch.sin(ang)[None, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
