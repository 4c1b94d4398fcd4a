"""Unmodified PyTorch programs that run as tpushare tenants.

Each is a plain training program; its one tpushare line is ``import
nvshare_tpu_torch.autoload`` under its ``__main__`` block, which gates
every device op on the scheduler's lock
(:func:`nvshare_tpu_torch.interpose.enable`). None of them calls the
arena, ``vop`` or the gate. Nothing runs when a module is imported.

  * :mod:`~nvshare_tpu_torch.workloads.lm_train` — the transformer LM at
    GPT-3 6.7B widths, trained with momentum SGD;
  * :mod:`~nvshare_tpu_torch.workloads.mlp_train` — the MLP classifier,
    fed by the prefetching input pipeline, checkpointed at its midpoint
    and resumable.

Each prints every loss and, last, ``<name> RESULT <json>``
(:func:`result_line`): the losses, the f64 sum of the final state, step
times, the wall-clock span of the training (``t_begin``/``t_end``, from
the state's creation), and what the run went through — the gate's count of gated ops,
each kernel's launches (all of them, the gated ones, the wgmma route's)
and the peak of reserved device memory. Reading those counters is
reporting, not gating.
"""

from __future__ import annotations

import json

import torch


def state_sum(*trees) -> float:
    """The f64 sum of every tensor of the given dicts (nested)."""
    total = 0.0
    for tree in trees:
        for x in tree.values():
            total += (state_sum(x) if isinstance(x, dict)
                      else float(x.double().sum()))
    return total


def result_line(name: str, device: torch.device, **fields) -> str:
    """``<name> RESULT <json>`` with ``fields`` and the run's counters."""
    from nvshare_tpu_torch import interpose
    from nvshare_tpu_torch.ops import (
        flash_attention,
        flash_backward_dkv,
        flash_backward_dq,
    )
    from nvshare_tpu_torch.ops.attention import WGMMA

    launches = {
        fn.__name__: {"launches": fn.launches.value,
                      "gated": fn.launches.gated,
                      "wgmma": fn.route_launches[WGMMA].value}
        for fn in (flash_attention, flash_backward_dq, flash_backward_dkv)}
    gated_ops = sum(child.value
                    for _, child in interpose._exec_counter().samples())
    out = dict(fields, name=name, device=str(device),
               gate=interpose.enabled(), gated_ops=int(gated_ops),
               kernels=launches)
    out["peak_reserved"] = (torch.cuda.max_memory_reserved(device)
                            if device.type == "cuda" else None)
    out["release"] = None
    if interpose.enabled():
        a = interpose.current_arena()
        h = a._m_handoff_s
        out["release"] = {"handoffs": h.count,
                          "handoff_s_mean": h.sum / max(h.count, 1),
                          "releases": a.device_releases,
                          "reserved_after": a.reserved_after_release}
    return f"{name} RESULT {json.dumps(out)}"
