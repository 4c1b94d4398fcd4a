"""The port's ground rules, checked.

* No module of ``nvshare_tpu_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or anything of the JAX package (checked in a fresh interpreter:
  this pytest process imported both already).
* The port's copy of the wire protocol agrees with the JAX package's.
* Entry points default to CUDA and raise without it; they never carry on
  on the CPU unless asked.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.conftest import REPO_ROOT

PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import nvshare_tpu_torch
names = [m.name for m in pkgutil.walk_packages(nvshare_tpu_torch.__path__,
                                               "nvshare_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "nvshare_tpu" or m.startswith("nvshare_tpu."))
print(len(names), ",".join(bad))
"""


def test_port_imports_no_jax_and_no_reference_package():
    out = subprocess.run([sys.executable, "-c", PROBE, str(REPO_ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1) if " " in out.stdout.strip() \
        else (out.stdout.strip(), "")
    assert int(n) >= 15, out.stdout
    assert bad == "", f"imported from the reference side: {bad}"


def test_protocol_constants_match_reference():
    from nvshare_tpu.runtime import protocol as ref
    from nvshare_tpu_torch.runtime import protocol as port

    assert port.FRAME_SIZE == ref.FRAME_SIZE == 304
    assert (port.MAGIC, port.VERSION, port.IDENT_LEN) == (
        ref.MAGIC, ref.VERSION, ref.IDENT_LEN)
    assert {m.name: int(m) for m in port.MsgType} == \
        {m.name: int(m) for m in ref.MsgType}
    names = [n for n in dir(ref)
             if n.startswith(("CAP_", "SCHED_CAP_", "QOS_", "STATS_WANT_",
                              "PHASE_", "POLICY_LOAD_"))
             or n == "UNREGISTERED_ID"]
    assert len(names) > 20
    for n in names:
        assert getattr(port, n) == getattr(ref, n), n
    msg = port.Msg(port.MsgType.LOCK_OK, client_id=7, arg=3,
                   job_name="epoch=5", job_namespace="ns")
    assert ref.Msg.unpack(msg.pack()) == ref.Msg(
        ref.MsgType.LOCK_OK, 7, 3, "epoch=5", "ns")
    assert port.parse_grant_epoch("a epoch=9") == ref.parse_grant_epoch(
        "a epoch=9")


def test_chaos_is_refused(monkeypatch, tmp_path):
    from nvshare_tpu_torch.runtime.protocol import SchedulerLink

    monkeypatch.setenv("TPUSHARE_CHAOS", "drop=0.5")
    with pytest.raises(NotImplementedError):
        SchedulerLink(path=str(tmp_path / "none.sock"))


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda,
                                                           monkeypatch):
    from nvshare_tpu_torch import colocate, device, vmem

    monkeypatch.setenv("TPUSHARE_SOCK_DIR", "/nonexistent")
    assert device.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vmem.VirtualHBM()
    vmem.reset_arena()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vmem.arena()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        colocate.Tenant("no-card")
    with pytest.raises(ValueError):
        device.resolve_device("mps")


def test_model_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from nvshare_tpu_torch.convert import transformer_params_from_numpy
    from nvshare_tpu_torch.models import Transformer, init_kv_cache

    model = Transformer(vocab=16, dim=32, heads=2, depth=1, seq=128)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_kv_cache(model, batch=1, max_len=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer_params_from_numpy({"ln_f": np.ones(32, np.float32)})
    assert model.init(device="cpu")["embed"].device.type == "cpu"
    assert init_kv_cache(model, 1, 8, device="cpu")["k0"].device.type \
        == "cpu"


def test_wrappers_on_cpu_tensors_never_touch_the_kernels(no_cuda):
    from nvshare_tpu_torch.ops import (
        flash_attention,
        flash_attention_lse,
        fused_mix,
        tiled_matmul,
    )

    a = torch.rand(256, 256)
    q = torch.rand(1, 256, 2, 64)
    counts = (fused_mix.launches, tiled_matmul.launches,
              flash_attention.launches)
    before = [c.value for c in counts]
    fused_mix(a, a)
    tiled_matmul(a, a)
    flash_attention(q, q, q, causal=True)
    flash_attention_lse(q, q, q)
    assert [c.value for c in counts] == before


def test_chip_smoke_refuses_to_run_without_a_card():
    out = subprocess.run([sys.executable, str(REPO_ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
