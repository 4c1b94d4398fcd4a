"""Parallel programs over ranks, and the multi-process guard: the port of
``nvshare_tpu/parallel``.

Each shard of a JAX ``shard_map`` program is a process here, a rank of a
``torch.distributed`` group (:mod:`~nvshare_tpu_torch.parallel.collectives`:
the backend rule, the mesh, and the collectives written out):

  * :func:`make_mesh` / :func:`sharded_mlp_step`: the (data x model)
    MLP step, dp over ``data`` and tp over ``model``;
  * :func:`ring_attention` / :func:`ulysses_attention`: exact
    sequence-parallel attention (a ppermute ring with a log-sum-exp
    merge; an all-to-all head reshard);
  * :func:`seq_sharded_lm_step`: sequence-parallel LM training (and dp x
    sp, and the MoE LM with expert parallelism on the same axis);
  * :func:`moe_ffn_sharded`: expert parallelism, capacity-routed MoE FFN
    with all-to-all dispatch;
  * :func:`pipeline_train_step`: GPipe pipeline parallelism;
  * :func:`multihost_guard`: gating a multi-process run is refused unless
    forced (a per-host lock can deadlock its collectives);
  * :mod:`~nvshare_tpu_torch.parallel.dryrun`: every axis above, run as
    ranks (``python -m nvshare_tpu_torch.parallel.dryrun --world N``).
"""

from nvshare_tpu_torch.parallel.guard import multihost_guard  # noqa: F401
from nvshare_tpu_torch.parallel.collectives import (  # noqa: F401
    Mesh,
    choose_backend,
    init_ranks,
    shutdown_ranks,
)
from nvshare_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    sharded_mlp_step,
    sharded_train_setup,
)
from nvshare_tpu_torch.parallel.ring_attention import (  # noqa: F401
    make_seq_mesh,
    ring_attention,
    ring_attention_sharded,
    ulysses_attention,
    ulysses_attention_sharded,
)
from nvshare_tpu_torch.parallel.seq_transformer import (  # noqa: F401
    dp_seq_sharded_lm_step,
    seq_sharded_lm_setup,
    seq_sharded_lm_step,
    seq_sharded_moe_lm_step,
)
from nvshare_tpu_torch.parallel.moe import (  # noqa: F401
    init_moe_params,
    moe_ffn_reference,
    moe_ffn_sharded,
)
from nvshare_tpu_torch.parallel.pipeline import (  # noqa: F401
    init_pipeline_params,
    pipeline_forward_sharded,
    pipeline_train_step,
)
