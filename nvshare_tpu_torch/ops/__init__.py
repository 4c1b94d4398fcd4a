"""The port's hot ops: CUDA kernels on the card, plain PyTorch on the CPU."""

from nvshare_tpu_torch.ops.attention import (  # noqa: F401
    flash_attention,
    flash_attention_lse,
    flash_attention_reference,
    reference_attention,
)
from nvshare_tpu_torch.ops.matmul import (  # noqa: F401
    tiled_matmul,
    tiled_matmul_reference,
)
from nvshare_tpu_torch.ops.mix import fused_mix, fused_mix_reference  # noqa: F401
from nvshare_tpu_torch.ops.rope import rope_rotate  # noqa: F401
