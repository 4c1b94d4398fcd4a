"""The port's hot ops: CUDA kernels on the card, plain PyTorch on the CPU."""

from nvshare_tpu_torch.ops.matmul import (  # noqa: F401
    tiled_matmul,
    tiled_matmul_reference,
)
from nvshare_tpu_torch.ops.mix import fused_mix, fused_mix_reference  # noqa: F401
