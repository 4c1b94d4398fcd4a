"""Flash attention, forward: exact attention over [B, S, H, D] inputs.

The port of the forward half of ``nvshare_tpu/ops/attention.py`` (the
Pallas ``_flash_kernel``). On CUDA tensors :func:`flash_attention` and
:func:`flash_attention_lse` launch the hand-written kernel in
``csrc/attention.cu``, which reads q, k and v strided as they lie (no
transposes) and computes in f32 with an online softmax over key tiles; on
CPU or meta tensors they run :func:`flash_attention_reference`, the plain
version. The reference's eligibility rule is kept: ``seq % 128 == 0`` and
``d <= 128`` take the kernel, anything else takes
:func:`reference_attention` on any device, as the JAX wrapper does.

Both run inside a :class:`torch.autograd.Function` whose backward raises:
the backward kernels come with the training slice, and no gradient flows
silently through the plain version meanwhile.
"""

from __future__ import annotations

import math

import torch

from nvshare_tpu_torch.ops import _build

_BQ = 128
_BK = 128
_NEG_INF = -1e30


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """f32 scores [B, H, Sq, Sk] = q k^T / sqrt(d), -1e30 where masked."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]  # cross-length safe (both from 0)
        keep = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        mask = torch.where(keep, 0.0, _NEG_INF)
        s = s + mask[None, None, :, :]
    return s


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """Single-device full attention: the port of
    ``nvshare_tpu.parallel.ring_attention.reference_attention``, the
    route for ragged or oversized shapes."""
    p = torch.softmax(_scores(q, k, causal), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel: ``(out [B,Sq,H,D] in
    q.dtype, lse [B*H, Sq] f32)``, with the whole score matrix in f32."""
    s = _scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)                        # [B, H, Sq]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    b, h, sq = lse.shape
    return out, lse.reshape(b * h, sq)


def _kernel_shapes_ok(sq: int, sk: int, d: int) -> bool:
    return not (sq % _BQ or sk % _BK or d > 128)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the CUDA kernel (eligible shapes, CUDA tensors)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError(f"flash attention takes q [B,Sq,H,D] and k, v "
                         f"[B,Sk,H,D]; got q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if not (q.device == k.device == v.device) or \
            not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash attention kernel takes q, k and v of one "
                        "dtype on one device")
    code = _build.dtype_code(q.dtype, "flash_attention")
    # The kernel reads rows and heads strided; only the head dimension
    # must be contiguous.
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    lib = _build.load("attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.tpushare_flash_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, sq, sk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(causal), code, 1.0 / math.sqrt(d), stream)
    _build.check(rc, "flash_attention")
    flash_attention.launches.add()
    return out, lse


def _forward(q, k, v, causal: bool):
    """(out, lse) through the kernel, or (out, None) on the ragged route."""
    if not _kernel_shapes_ok(q.shape[1], k.shape[1], q.shape[-1]):
        return reference_attention(q, k, v, causal=causal), None
    if q.device.type != "cuda":
        return flash_attention_reference(q, k, v, causal=causal)
    return _launch(q, k, v, causal)


class _FlashAttention(torch.autograd.Function):
    """Forward only: the backward kernels are the training slice's."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, with_lse: bool):
        out, lse = _forward(q, k, v, causal)
        return (out, lse) if with_lse else out

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "flash attention has no backward in nvshare_tpu_torch yet: the "
            "backward kernels (the dQ sweep and the dK/dV sweep of "
            "nvshare_tpu/ops/attention.py) come with the training slice")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Exact attention for [batch, seq, heads, dim] inputs.

    Shapes with seq % 128 == 0 and dim <= 128 take the kernel (on a CUDA
    tensor) or its plain version (on a CPU or meta tensor); anything else
    takes :func:`reference_attention` (same math). Forward only.
    """
    return _FlashAttention.apply(q, k, v, causal, False)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash attention that also returns the per-row log-sum-exp:
    ``(out [B,S,H,D], lse [B*H, S] f32)``. Kernel-eligible shapes only
    (seq % 128 == 0, dim <= 128): the ragged route has no LSE."""
    if not _kernel_shapes_ok(q.shape[1], k.shape[1], q.shape[-1]):
        raise ValueError(
            f"flash_attention_lse requires kernel-eligible shapes "
            f"(seq%{_BQ}==0, dim<=128); got q{tuple(q.shape)} "
            f"k{tuple(k.shape)}")
    return _FlashAttention.apply(q, k, v, causal, True)


# One count for both entry points: each launch of the kernel adds one.
flash_attention.launches = _build.LaunchCount()
flash_attention_lse.launches = flash_attention.launches
