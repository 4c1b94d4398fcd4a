"""The port's hot ops: CUDA kernels on the card, plain PyTorch on the CPU."""

from nvshare_tpu_torch.ops.attention import (  # noqa: F401
    attention_delta,
    flash_attention,
    flash_attention_lse,
    flash_attention_reference,
    flash_backward_dkv,
    flash_backward_dkv_reference,
    flash_backward_dq,
    flash_backward_dq_reference,
    flash_backward_reference,
    reference_attention,
)
from nvshare_tpu_torch.ops.matmul import (  # noqa: F401
    matmul_kernel,
    tiled_matmul,
    tiled_matmul_reference,
    to_bf16,
)
from nvshare_tpu_torch.ops.mix import fused_mix, fused_mix_reference  # noqa: F401
from nvshare_tpu_torch.ops.rope import rope_rotate  # noqa: F401
