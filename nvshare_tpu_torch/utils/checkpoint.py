"""Checkpoint/resume for train states: the port of
``nvshare_tpu/utils/checkpoint.py``, over ``torch.distributed.checkpoint``
in non-distributed mode.

The train-state convention is the JAX package's: ``(params, opt_state)``
trees plus an integer step, saved as ``{"params": ..., "opt": ...,
"step": int}``. The on-disk format is ``torch.distributed.checkpoint``'s
(a ``.metadata`` file and per-rank ``.distcp`` shards), not orbax's: a
checkpoint written by one package is not read by the other. What both
hold to is the semantics: atomic writes, a refused existing path,
templates that decide where the restored tensors land, and a bit-exact
resume.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import warnings
from typing import Any

import torch
import torch.distributed.checkpoint as dcp

from nvshare_tpu_torch.vmem import _tree_map


@contextlib.contextmanager
def _single_process():
    """Silence DCP's note that it runs without a process group: this
    module saves and loads in non-distributed mode on purpose."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore",
                                message="torch.distributed is disabled")
        yield


def save_train_state(path: str, params: Any, opt_state: Any,
                     step: int) -> str:
    """Write a checkpoint atomically: into a temporary sibling directory,
    renamed to ``path`` once complete. ``path`` must not exist yet."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        raise FileExistsError(f"checkpoint path exists: {path}")
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    state = {"params": params, "opt": opt_state,
             "step": torch.tensor(int(step), dtype=torch.int64)}
    try:
        with _single_process():
            dcp.save(state, storage_writer=dcp.FileSystemWriter(tmp),
                     no_dist=True)
        os.rename(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return path


def restore_train_state(path: str, params_like: Any, opt_like: Any):
    """Restore ``(params, opt_state, step)``.

    ``params_like``/``opt_like`` are templates: trees of tensors whose
    shapes, dtypes and DEVICES decide what is restored and where it lands
    (pass the train step's own state, on the card or on the CPU). Fresh
    tensors are returned; the templates are not written.
    """
    state = {"params": _tree_map(torch.empty_like, params_like),
             "opt": _tree_map(torch.empty_like, opt_like),
             "step": torch.zeros((), dtype=torch.int64)}
    with _single_process():
        dcp.load(state, storage_reader=dcp.FileSystemReader(
            os.path.abspath(path)), no_dist=True)
    return state["params"], state["opt"], int(state["step"])


def latest_step_dir(root: str) -> str | None:
    """Resume helper: ``root`` holds ``step_<n>`` children; returns the
    highest-step path, or None if there are no checkpoints yet."""
    if not os.path.isdir(root):
        return None
    best, best_n = None, -1
    for name in os.listdir(root):
        if not name.startswith("step_"):
            continue
        try:
            n = int(name.split("_", 1)[1])
        except ValueError:
            continue
        if n > best_n:
            best, best_n = os.path.join(root, name), n
    return best
