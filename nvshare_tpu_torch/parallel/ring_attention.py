"""Sequence/context parallelism: ring attention and Ulysses all-to-all, the
port of ``nvshare_tpu/parallel/ring_attention.py``.

* :func:`ring_attention`: K/V blocks rotate around the ranks of a mesh
  axis while every rank keeps its own Q block; softmax is accumulated
  online, so the result is exact attention with per-rank memory
  O(seq/n + block^2). Kernel-tile blocks (seq/n % 128 == 0, d <= 128)
  run each block on the flash kernel over f32 copies and merge the
  results by their log-sum-exp (:func:`_ring_kernel`); the f32 copies
  take the 3xTF32 route of K3, K4 and K5 on the card. Other blocks
  run the plain online-softmax body.
* :func:`ulysses_attention`: an all-to-all reshards sequence-sharded to
  head-sharded, each rank attends over the whole sequence for its head
  group (:func:`~nvshare_tpu_torch.ops.flash_attention` at the input
  dtype), and a second all-to-all reshards back.

Both run inside a rank on its local shards [B, seq/n, H, D], as the JAX
functions run inside ``shard_map``; the ``*_sharded`` wrappers take and
return the whole (replicated) tensors. The collectives are
:mod:`~nvshare_tpu_torch.parallel.collectives`'.
"""

from __future__ import annotations

import math

import torch

from nvshare_tpu_torch.device import DeviceLike
from nvshare_tpu_torch.ops.attention import (
    _kernel_shapes_ok,
    flash_attention,
    flash_attention_lse,
    reference_attention,
)
from nvshare_tpu_torch.parallel.collectives import (
    Mesh,
    all_to_all,
    anchor,
    gather,
    ppermute,
    ring_perm,
    shard,
    world_size,
)

__all__ = ["make_seq_mesh", "ring_attention", "ring_attention_sharded",
           "ulysses_attention", "ulysses_attention_sharded",
           "reference_attention"]

_NEG_INF = -1e30  # mask value: finite so exp() underflows cleanly to 0


def make_seq_mesh(n_devices: int | None = None, axis: str = "seq",
                  device: DeviceLike = None) -> Mesh:
    """A 1D mesh over the program's ranks (``n_devices``, default all of
    them), named ``axis``."""
    return Mesh((n_devices or world_size(),), (axis,), device=device)


def _block_attn(q, k, v, mask, m_prev, l_prev, o_prev, scale):
    """One K/V block folded into the online-softmax accumulators.

    q: [B, Sq, H, D]; k, v: [B, Sk, H, D]; mask: [Sq, Sk] additive.
    m (row max) and l (normalizer) are [B, H, Sq]; o is the unnormalized
    output [B, Sq, H, D]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s = s + mask[None, None, :, :]
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m_prev - m_new)
    l_new = l_prev * corr + p.sum(dim=-1)
    o_new = (o_prev * corr.transpose(1, 2)[..., None]
             + torch.einsum("bhqk,bkhd->bqhd", p, v))
    return m_new, l_new, o_new


def _merge_blocks(o1, lse1, o2, lse2):
    """Merge two normalized attention results over DISJOINT key sets:
    o [B, Sq, H, D] f32, lse [B, H, Sq] f32, weighted by each one's
    log-normalizer. The sentinel -1e30 is finite, so the first merge's
    exp() underflows to 0 instead of giving inf - inf."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    tot = w1 + w2
    lse_new = m + torch.log(tot)
    a1 = (w1 / tot).transpose(1, 2)[..., None]
    a2 = (w2 / tot).transpose(1, 2)[..., None]
    return o1 * a1 + o2 * a2, lse_new


def _ring_kernel(q, k, v, *, mesh: Mesh, axis: str, causal: bool):
    """Ring body with the flash kernel as the block op, on f32 copies of
    q, k and v (the JAX body's ``astype(f32)``): each rotation computes a
    normalized (out, LSE) pair over this rank's Q block and the visiting
    K/V block, then merges it. Past blocks run unmasked, the diagonal
    block causal, future blocks are skipped (the rotation still runs).
    Differentiable: the merge is PyTorch, and the kernel's backward takes
    both cotangents, the LSE's folding into dS."""
    n, idx = mesh.axis_size(axis), mesh.axis_index(axis)
    b, blk, h, _ = q.shape
    qf = q.float()
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, blk), _NEG_INF, dtype=torch.float32,
                     device=q.device)
    kv = torch.stack([k, v])          # one tensor, one ppermute a step
    rotated = []
    for j in range(n):
        src = (idx - j) % n
        if not causal or src <= idx:
            kf, vf = kv[0].float(), kv[1].float()
            o_b, lse_b = flash_attention_lse(qf, kf, vf,
                                             causal=causal and src == idx)
            o, lse = _merge_blocks(o, lse, o_b, lse_b.reshape(b, h, blk))
        if j < n - 1:
            kv = ppermute(kv, mesh, axis, ring_perm(n))
            rotated.append(kv)
    return anchor(o, *rotated).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh: Mesh, axis: str = "seq",
                   causal: bool = False) -> torch.Tensor:
    """Exact attention with the sequence sharded over ``axis``.

    q, k, v are this rank's blocks [B, seq/n, H, D] of the global
    sequence (rank i holds positions i*blk ... (i+1)*blk - 1). Kernel-tile
    blocks (seq/n % 128 == 0, D <= 128) run the flash kernel
    (:func:`_ring_kernel`); other blocks run the online-softmax body
    below, the same math. The output is in q's dtype."""
    n, idx = mesh.axis_size(axis), mesh.axis_index(axis)
    blk, d = q.shape[1], q.shape[-1]
    if _kernel_shapes_ok(blk, blk, d):
        return _ring_kernel(q, k, v, mesh=mesh, axis=axis, causal=causal)
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    q_pos = idx * blk + torch.arange(blk, device=dev)
    m = torch.full((q.shape[0], q.shape[2], blk), _NEG_INF,
                   dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)  # noqa: E741 - the JAX body's name
    o = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    qf = q.float()
    kv = torch.stack([k, v])
    rotated = []
    for j in range(n):
        # After j rotations this rank holds the block that started on
        # rank (idx - j) mod n.
        src = (idx - j) % n
        if causal:
            k_pos = src * blk + torch.arange(blk, device=dev)
            mask = torch.where(q_pos[:, None] >= k_pos[None, :], 0.0,
                               _NEG_INF)
        else:
            mask = torch.zeros((blk, blk), device=dev)
        # A block wholly in the future (src > idx) is skipped.
        if not causal or src <= idx:
            m, l, o = _block_attn(qf, kv[0].float(), kv[1].float(), mask,
                                  m, l, o, scale)
        if j < n - 1:
            kv = ppermute(kv, mesh, axis, ring_perm(n))
            rotated.append(kv)
    l_t = l.transpose(1, 2)[..., None]
    out = torch.where(l_t > 0, o / l_t.clamp(min=1e-38), 0.0)
    return anchor(out, *rotated).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, mesh: Mesh, axis: str = "seq",
                      causal: bool = False) -> torch.Tensor:
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism on this rank's
    blocks [B, seq/n, H, D]: reshard to [B, seq, H/n, D] (q, k and v
    stacked into one all-to-all), attend locally over the whole sequence
    with :func:`~nvshare_tpu_torch.ops.flash_attention` at the input
    dtype, reshard back. Requires H % n == 0."""
    n = mesh.axis_size(axis)
    if q.shape[2] % n:
        raise ValueError(f"Ulysses needs heads % ranks == 0; got "
                         f"{q.shape[2]} heads over {n} ranks")
    qkv = all_to_all(torch.stack([q, k, v]), mesh, axis, split_dim=3,
                     concat_dim=2)
    oh = flash_attention(qkv[0], qkv[1], qkv[2], causal=causal)
    out = all_to_all(oh, mesh, axis, split_dim=1, concat_dim=2)
    return out.to(q.dtype)


def _sharded(fn, mesh: Mesh, axis: str, causal: bool):
    def run(q, k, v):
        q, k, v = (shard(x, mesh, axis, 1) for x in (q, k, v))
        out = fn(q, k, v, mesh=mesh, axis=axis, causal=causal)
        return gather(out, mesh, axis, 1)

    return run


def ring_attention_sharded(mesh: Mesh, *, axis: str = "seq",
                           causal: bool = False):
    """Ring attention over ``mesh`` on WHOLE [batch, seq, heads, dim]
    tensors, the same on every rank: each rank takes its sequence block,
    and the output is gathered back whole. Differentiable, as the JAX
    function is: a loss of the output that every rank computes alike
    gets whole gradients on every rank."""
    return _sharded(ring_attention, mesh, axis, causal)


def ulysses_attention_sharded(mesh: Mesh, *, axis: str = "seq",
                              causal: bool = False):
    """Ulysses attention over ``mesh`` on whole tensors (as
    :func:`ring_attention_sharded`)."""
    return _sharded(ulysses_attention, mesh, axis, causal)
