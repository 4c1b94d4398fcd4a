"""The port's checkpoints against the JAX package's semantics.

The counterpart of ``tests/test_checkpoint.py``. The on-disk formats
differ (``torch.distributed.checkpoint`` here, orbax there), so the
tests hold the semantics: save, restore and resume bit for bit; an
existing path refused and no temporary left behind; restored tensors
land where the templates are; ``latest_step_dir`` agrees with the
reference's on one directory tree.
"""

import os

import numpy as np
import pytest
import torch

from nvshare_tpu.utils import checkpoint as ref
from nvshare_tpu_torch.models import mlp
from nvshare_tpu_torch.utils.checkpoint import (
    latest_step_dir,
    restore_train_state,
    save_train_state,
)

MODEL = mlp.MLP(in_dim=64, hidden_dim=128, out_dim=16, depth=3)


def _steps(params, opt, start, stop):
    losses = []
    for i in range(start, stop):
        x, y = mlp.synthetic_batch(MODEL, 16, seed=i)
        params, opt, loss = mlp.train_step(params, opt, torch.from_numpy(x),
                                           torch.from_numpy(y))
        losses.append(float(loss))
    return params, opt, losses


def test_save_restore_resume_bit_exact(tmp_path):
    params, opt = mlp.init_train_state(MODEL, seed=0, device="cpu")
    params, opt, first = _steps(params, opt, 0, 3)
    path = save_train_state(str(tmp_path / "step_3"), params, opt, 3)
    assert path == str(tmp_path / "step_3") and os.path.isdir(path)
    full_params, full_opt, rest = _steps(params, opt, 3, 6)

    tparams, topt = mlp.init_train_state(MODEL, seed=99, device="cpu")
    rparams, ropt, step = restore_train_state(path, tparams, topt)
    assert step == 3
    for name, t in tparams.items():
        assert rparams[name] is not t and rparams[name].dtype == t.dtype
        assert rparams[name].device == t.device
    rparams, ropt, resumed = _steps(rparams, ropt, step, 6)
    assert resumed == rest
    for name in full_params:
        assert torch.equal(rparams[name], full_params[name]), name
        assert torch.equal(ropt["m"][name], full_opt["m"][name]), name


def test_existing_path_refused_and_no_temporary_left(tmp_path):
    params, opt = mlp.init_train_state(MODEL, seed=0, device="cpu")
    save_train_state(str(tmp_path / "step_1"), params, opt, 1)
    with pytest.raises(FileExistsError):
        save_train_state(str(tmp_path / "step_1"), params, opt, 1)
    assert sorted(os.listdir(tmp_path)) == ["step_1"]


def test_restore_lands_on_the_templates_dtype(tmp_path):
    params = {"w": torch.arange(6.0).reshape(2, 3),
              "n": torch.arange(4, dtype=torch.int32)}
    opt = {"m": {"w": torch.ones(2, 3), "n": torch.zeros(4,
                                                        dtype=torch.int32)}}
    save_train_state(str(tmp_path / "ck"), params, opt, 7)
    rp, ro, step = restore_train_state(str(tmp_path / "ck"), params, opt)
    assert step == 7 and rp["n"].dtype == torch.int32
    assert torch.equal(rp["w"], params["w"])
    assert torch.equal(ro["m"]["n"], opt["m"]["n"])


def test_latest_step_dir_agrees_with_reference(tmp_path):
    assert latest_step_dir(str(tmp_path / "missing")) is None
    assert ref.latest_step_dir(str(tmp_path / "missing")) is None
    assert latest_step_dir(str(tmp_path)) is ref.latest_step_dir(
        str(tmp_path)) is None
    for name in ("step_2", "step_10", "step_x", "other", "step_9"):
        (tmp_path / name).mkdir()
    got = latest_step_dir(str(tmp_path))
    assert got == ref.latest_step_dir(str(tmp_path)) == str(
        tmp_path / "step_10")
