"""Tiled bf16 matmul — the MatmulBurner hot op as a hand-written kernel.

``tiled_matmul`` is the port of ``nvshare_tpu.ops.tiled_matmul`` (the
Pallas ``_mm_kernel``): ``a @ b`` with both operands rounded to bf16,
products accumulated in f32 and the result cast to ``a.dtype``. On a CUDA
tensor it launches the tensor-core kernel in ``csrc/matmul.cu``; on a CPU
or meta tensor it runs :func:`tiled_matmul_reference`. The reference's
eligibility rule is kept: shapes that are not multiples of 128 (or whose
inner dimensions differ) take the plain bf16 product on any device, as
the JAX function leaves them to XLA's dot.
"""

from __future__ import annotations

import torch

from nvshare_tpu_torch.ops import _build

_BM = 128
_BN = 128
_BK = 128


def tiled_matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: bf16-rounded operands, an f32 product,
    cast to ``a.dtype``. On the card, compare it with TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``, the default), or
    the f32 product itself is rounded."""
    prod = a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()
    return prod.to(a.dtype)


def tiled_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in bf16 with f32 accumulation, returned in ``a.dtype``."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2 or m % _BM or n % _BN or k % _BK or a.device.type != "cuda":
        return tiled_matmul_reference(a, b)
    if b.device != a.device:
        raise ValueError("tiled_matmul operands lie on different devices")
    a_code = _build.dtype_code(a.dtype, "tiled_matmul")
    b_code = _build.dtype_code(b.dtype, "tiled_matmul")
    a = a.contiguous()
    b = b.contiguous()
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if (a.data_ptr() | b.data_ptr()) % 16:
        raise ValueError("tiled_matmul kernel takes 16-byte aligned operands")
    lib = _build.load("matmul")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.tpushare_tiled_matmul(a.data_ptr(), b.data_ptr(),
                                       out.data_ptr(), m, n, k, a_code,
                                       b_code, stream)
    _build.check(rc, "tiled_matmul")
    tiled_matmul.launches.add()
    return out


tiled_matmul.launches = _build.LaunchCount()
