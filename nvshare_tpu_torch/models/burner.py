"""Device-burner workloads with configurable working-set size (WSS).

The port of ``nvshare_tpu/models/burner.py`` (≙ the reference's
tests/tf-matmul.py and tests/pytorch-add.py): the WSS is split into equal
square chunks, and every step touches every chunk through one
:func:`~nvshare_tpu_torch.vmem.vop` submission, so a WSS larger than the
arena's budget pages instead of failing.

One step computes ``c_i <- step(c_i, c_{i+1 mod n})`` for every chunk, each
output reading the *old* chunks. The JAX burner donates all chunks and lets
XLA reuse their buffers; eager PyTorch has no donation, so the port updates
the chunks in place, in order, keeping one saved copy of the old ``c_0``
for the last chunk. A step then needs one chunk of extra device memory
(two for the matmul kind, whose product is a chunk-sized f32 temporary)
instead of a second copy of the working set.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from nvshare_tpu_torch import vmem
from nvshare_tpu_torch.convert import varrays_from_numpy
from nvshare_tpu_torch.utils import env_bool, get_logger

log = get_logger("burner")


def _chunk_side(chunk_bytes: int, dtype: torch.dtype) -> int:
    itemsize = torch.empty((), dtype=dtype).element_size()
    side = int((chunk_bytes / itemsize) ** 0.5)
    return max(256, (side // 256) * 256)  # both kernels' tile multiples


@dataclass
class BurnerResult:
    wall_s: float
    steps: int
    checksum: float
    device_s: float = 0.0   # summed device-phase time (duty cycle = /wall)
    flops: float = 0.0      # model FLOPs issued (0 when not meaningful)

    @property
    def passed(self) -> bool:
        return bool(np.isfinite(self.checksum))


class _BurnerBase:
    """WSS split into equal square chunks; each step touches every chunk so
    the whole working set is live.

    ``device_ratio`` models the reference's ``_90``/``_50`` workload suffix
    (fraction of wall time on the device): after each device pass, the
    burner spins host-side numpy work sized so the device fraction lands
    near the requested ratio.
    """

    def __init__(self, wss_bytes: int, chunks: int = 8,
                 dtype: torch.dtype = torch.float32,
                 arena: Optional[vmem.VirtualHBM] = None,
                 device_ratio: float = 0.9):
        self.arena = arena if arena is not None else vmem.arena()
        self.dtype = dtype
        self.device_ratio = min(max(device_ratio, 0.05), 1.0)
        side = _chunk_side(wss_bytes // chunks, dtype)
        self.side = side
        # Generated on the device (no bulk host->device transfer); shadows
        # materialize lazily if/when chunks are evicted.
        self.chunks = [
            self.arena.device_array((side, side), dtype, seed=i)
            for i in range(chunks)
        ]
        self._log_shape()

    @classmethod
    def from_numpy(cls, arrays: Sequence[np.ndarray],
                   arena: vmem.VirtualHBM, device_ratio: float = 0.9):
        """A burner over given chunks (equal square numpy arrays) instead
        of device-generated ones: the path that feeds one seeded working
        set to this package and to the JAX package alike."""
        self = cls.__new__(cls)
        self.arena = arena
        self.device_ratio = min(max(device_ratio, 0.05), 1.0)
        self.chunks = varrays_from_numpy(arrays, arena)
        self.dtype = self.chunks[0].dtype
        self.side = self.chunks[0].shape[0]
        if any(c.shape != (self.side, self.side) for c in self.chunks):
            raise ValueError("burner chunks are equal square arrays")
        self._log_shape()
        return self

    def _log_shape(self) -> None:
        self.wss_bytes = sum(c.nbytes for c in self.chunks)
        log.info("%s: WSS %.2f GiB in %d chunks of %dx%d %s, device "
                 "ratio %.2f", type(self).__name__, self.wss_bytes / 2**30,
                 len(self.chunks), self.side, self.side, self.dtype,
                 self.device_ratio)

    def _step_fn(self):
        """``step(a, b)`` writing the new value of chunk ``a`` into ``a``."""
        raise NotImplementedError

    def flops_per_step(self) -> float:
        """Model FLOPs issued per step (0 when not meaningful)."""
        return 0.0

    def _host_spin(self, seconds: float) -> None:
        """Host-side compute phase (numpy, off-device)."""
        if seconds <= 0:
            return
        end = time.perf_counter() + seconds
        a = np.random.RandomState(0).rand(256, 256).astype(np.float32)
        while time.perf_counter() < end:
            a = a @ a
            a /= (np.abs(a).max() + 1e-6)

    def run(self, steps: int, step_hook=None) -> BurnerResult:
        # One submission per step touching the WHOLE working set (the
        # reference burners' shape): under contention every step must page
        # its full WSS back in. All chunks are donated and updated in place.
        n = len(self.chunks)
        step_one = self._step_fn()

        def all_step(*cs):
            first = cs[0].clone()  # c_0's old value, read by the last chunk
            for i in range(n):
                step_one(cs[i], cs[i + 1] if i + 1 < n else first)
            return cs

        op = vmem.vop(all_step, donate_argnums=tuple(range(n)))
        t0 = time.time()
        device_s = 0.0
        for s in range(steps):
            dev_t0 = time.perf_counter()
            self.chunks = list(op(*self.chunks))
            self.arena.fence()  # step boundary: device phase truly done
            dev_s = time.perf_counter() - dev_t0
            device_s += dev_s
            self._host_spin(dev_s * (1.0 / self.device_ratio - 1.0))
            if step_hook is not None:
                step_hook(s)
        # Checksum on the device (tiny corner reductions, one readback).
        corners = vmem.vop(
            lambda *cs: torch.stack(
                [c[:2, :2].float().sum() for c in cs]).sum())
        checksum = float(corners(*self.chunks).numpy())
        return BurnerResult(time.time() - t0, steps, checksum,
                            device_s=device_s,
                            flops=steps * self.flops_per_step())


def _normalize_into(prod: torch.Tensor, out: torch.Tensor) -> None:
    """``out <- prod / (max|prod| + 1e-6)`` without a second chunk-sized
    temporary (``max|x|`` is ``max(max x, -min x)``, exactly)."""
    lo, hi = torch.aminmax(prod)
    torch.div(prod, torch.maximum(hi, -lo) + 1e-6, out=out)


class MatmulBurner(_BurnerBase):
    """Matmul-dominated burner (≙ tests/tf-matmul.py): bf16 operands, f32
    products, normalized by the global max so values stay bounded. Set
    ``TPUSHARE_PALLAS_MATMUL=1`` to run the hand-written tile kernel
    (:func:`nvshare_tpu_torch.ops.tiled_matmul`; the name is the JAX
    package's switch) instead of PyTorch's matmul; the normalization tail
    is identical in both paths."""

    def flops_per_step(self) -> float:
        return len(self.chunks) * 2.0 * float(self.side) ** 3

    def _step_fn(self):
        if env_bool("TPUSHARE_PALLAS_MATMUL"):
            from nvshare_tpu_torch.ops import tiled_matmul

            def step(a, b):
                # The product is one chunk-sized temporary in a.dtype; the
                # normalized result is written back into a.
                _normalize_into(tiled_matmul(a, b), a)
            return step

        def step(a, b):
            prod = torch.matmul(a.to(torch.bfloat16).float(),
                                b.to(torch.bfloat16).float())
            _normalize_into(prod, a)
        return step


class AddBurner(_BurnerBase):
    """Elementwise burner (≙ tests/pytorch-add.py): bandwidth-bound. Runs
    the fused mix kernel (:func:`nvshare_tpu_torch.ops.fused_mix`), written
    into the chunk it updates."""

    def _step_fn(self):
        from nvshare_tpu_torch.ops import fused_mix

        def step(a, b):
            fused_mix(a, b, out=a)
        return step


class MixBurner(_BurnerBase):
    """Plain elementwise burner, ``(a*0.5 + b*0.5 + 1.0) * 0.999``, in
    place: the same access pattern as AddBurner without a kernel of its
    own (``a + 0.5*b`` rounds as ``a + b*0.5`` does: the scaling by a
    power of two is exact)."""

    def _step_fn(self):
        def step(a, b):
            a.mul_(0.5).add_(b, alpha=0.5).add_(1.0).mul_(0.999)
        return step
