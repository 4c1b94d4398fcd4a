"""Tiled bf16 matmul — the MatmulBurner hot op as a hand-written kernel.

``tiled_matmul`` is the port of ``nvshare_tpu.ops.tiled_matmul`` (the
Pallas ``_mm_kernel``): ``a @ b`` with both operands rounded to bf16,
products accumulated in f32 and the result cast to ``a.dtype``. As the JAX
wrapper does outside its Pallas call, the wrapper rounds the operands to
contiguous bf16 first (:func:`to_bf16`); then, on a CUDA tensor, it
launches the Hopper kernel in ``csrc/matmul_sm90.cu`` (TMA + ``wgmma``),
which writes ``a.dtype`` straight from its f32 accumulators. On a CPU or
meta tensor it runs :func:`tiled_matmul_reference`. The reference's
eligibility rule is kept: shapes that are not multiples of 128 (or whose
inner dimensions differ) take the plain bf16 product on any device, as
the JAX function leaves them to XLA's dot.
"""

from __future__ import annotations

import torch

from nvshare_tpu_torch import interpose
from nvshare_tpu_torch.ops import _build

_BM = 128
_BN = 128
_BK = 128


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernel reads it: contiguous bf16. Other types are
    rounded to nearest even, as ``astype(jnp.bfloat16)`` rounds them; a
    contiguous bf16 tensor is returned as it is, without a copy."""
    if x.dtype == torch.bfloat16:
        return x.contiguous()
    return x.to(torch.bfloat16, memory_format=torch.contiguous_format)


def tiled_matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: bf16-rounded operands, an f32 product,
    cast to ``a.dtype``. On the card, compare it with TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``, the default), or
    the f32 product itself is rounded."""
    prod = to_bf16(a).float() @ to_bf16(b).float()
    return prod.to(a.dtype)


def matmul_kernel(a: torch.Tensor, b: torch.Tensor,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """K2 itself: ``a @ b`` of contiguous bf16 CUDA tensors [m, k] and
    [k, n] (multiples of 128), written in ``out_dtype`` (float32 or
    bfloat16) from f32 accumulators. Counts the launch."""
    m, k = a.shape
    k2, n = b.shape
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or \
            not (a.is_contiguous() and b.is_contiguous()):
        raise TypeError("the tiled_matmul kernel takes contiguous bf16 "
                        "operands")
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError("the tiled_matmul kernel takes operands on one "
                         "CUDA device")
    if k != k2 or m % _BM or n % _BN or k % _BK:
        raise ValueError(f"the tiled_matmul kernel takes [m, k] @ [k, n] "
                         f"in multiples of 128; got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if (a.data_ptr() | b.data_ptr()) % 16:
        raise ValueError("tiled_matmul kernel takes 16-byte aligned operands")
    code = _build.dtype_code(out_dtype, "tiled_matmul")
    with interpose.launch_unit(a.device):
        out = torch.empty((m, n), dtype=out_dtype, device=a.device)
        lib = _build.load("matmul_sm90")
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            rc = lib.tpushare_tiled_matmul_sm90(a.data_ptr(), b.data_ptr(),
                                                out.data_ptr(), m, n, k,
                                                code, stream)
        _build.check(rc, "tiled_matmul")
        tiled_matmul.launches.add()
    return out


def tiled_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in bf16 with f32 accumulation, returned in ``a.dtype``.
    One gated unit, the casts included, under the dispatch-mode gate
    (:func:`nvshare_tpu_torch.interpose.launch_unit`)."""
    m, k = a.shape
    k2, n = b.shape
    with interpose.launch_unit(a.device):
        if k != k2 or m % _BM or n % _BN or k % _BK or \
                a.device.type != "cuda":
            return tiled_matmul_reference(a, b)
        return matmul_kernel(to_bf16(a), to_bf16(b), a.dtype)


tiled_matmul.launches = _build.LaunchCount()
