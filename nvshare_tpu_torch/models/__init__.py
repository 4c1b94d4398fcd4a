"""Workload models of the port: the co-location burners, the
transformer LM (scoring forward, KV-cache decode, and training), the
MLP classifier and the mixture-of-experts LM."""

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
from nvshare_tpu_torch.models.mlp import MLP, mlp_forward  # noqa: F401
from nvshare_tpu_torch.models.transformer import (  # noqa: F401
    Transformer,
    init_lm_state,
    lm_loss_and_grads,
    lm_train_step,
    make_optim_lm_step,
    synthetic_tokens,
    transformer_forward,
)
from nvshare_tpu_torch.models.moe_transformer import (  # noqa: F401
    MoETransformer,
    init_moe_lm_state,
    moe_lm_objective,
    moe_lm_train_step,
    moe_transformer_forward,
)
