"""Fused scale-add-bias ("mix") — the AddBurner inner step.

``fused_mix`` is the port of ``nvshare_tpu.ops.fused_mix`` (the Pallas
``_mix_kernel``). On a CUDA tensor it launches the hand-written kernel in
``csrc/mix.cu`` (bandwidth-bound, 16-byte vector accesses, bit-exact with
:func:`fused_mix_reference`); on a CPU or meta tensor it runs that plain
version. The reference's eligibility rule is kept: anything but two equal
2-D arrays whose sides are multiples of 256 takes the plain elementwise
expression on any device, as the JAX function leaves it to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from nvshare_tpu_torch import interpose
from nvshare_tpu_torch.ops import _build

_TILE = 256


def fused_mix_reference(a: torch.Tensor, b: torch.Tensor, alpha: float = 0.5,
                        beta: float = 0.5, bias: float = 0.125
                        ) -> torch.Tensor:
    """The plain PyTorch version: ``a*alpha + b*beta + bias``."""
    return a * alpha + b * beta + bias


def _eligible(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.ndim == 2 and a.shape == b.shape
            and a.shape[0] % _TILE == 0 and a.shape[1] % _TILE == 0)


def fused_mix(a: torch.Tensor, b: torch.Tensor, alpha: float = 0.5,
              beta: float = 0.5, bias: float = 0.125, *,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``a*alpha + b*beta + bias`` for equal-shaped 2-D arrays.

    ``out`` (optional) receives the result and is returned; it may be
    ``a`` itself, which updates ``a`` in place without a second
    chunk-sized buffer. It must have ``a``'s shape, type and device.
    """
    if out is not None and (out.shape != a.shape or out.dtype != a.dtype
                            or out.device != a.device):
        raise ValueError("out must match a's shape, dtype and device")
    # One gated unit under the dispatch-mode gate (interpose.launch_unit).
    with interpose.launch_unit(a.device):
        if a.device.type != "cuda" or not _eligible(a, b):
            res = fused_mix_reference(a, b, alpha, beta, bias)
            return res if out is None else out.copy_(res)
        return _launch(a, b, alpha, beta, bias, out)


def _launch(a, b, alpha, beta, bias, out):
    if b.device != a.device or b.dtype != a.dtype:
        raise TypeError("fused_mix kernel takes a and b of one dtype on "
                        "one device")
    code = _build.dtype_code(a.dtype, "fused_mix")
    a = a.contiguous()
    b = b.contiguous()
    if out is None:
        out = torch.empty_like(a)
    elif not out.is_contiguous():
        raise ValueError("fused_mix kernel writes a contiguous out")
    lib = _build.load("mix")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.tpushare_fused_mix(a.data_ptr(), b.data_ptr(),
                                    out.data_ptr(), a.numel(), code,
                                    float(alpha), float(beta), float(bias),
                                    stream)
    _build.check(rc, "fused_mix")
    fused_mix.launches.add()
    return out


fused_mix.launches = _build.LaunchCount()
