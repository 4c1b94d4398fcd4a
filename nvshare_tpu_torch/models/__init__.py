"""Workload models of the port: the co-location burners and the
transformer LM's inference path (scoring forward and KV-cache decode)."""

from nvshare_tpu_torch.models.burner import (  # noqa: F401
    AddBurner,
    MatmulBurner,
    MixBurner,
)
from nvshare_tpu_torch.models.decode import (  # noqa: F401
    decode_step,
    greedy_generate,
    greedy_step,
    init_kv_cache,
    sample_generate,
)
from nvshare_tpu_torch.models.transformer import (  # noqa: F401
    Transformer,
    synthetic_tokens,
    transformer_forward,
)
