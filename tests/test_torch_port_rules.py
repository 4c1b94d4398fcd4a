"""The port's ground rules, checked.

* No module of ``nvshare_tpu_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or anything of the JAX package (checked in a fresh interpreter:
  this pytest process imported both already).
* The port's copy of the wire protocol agrees with the JAX package's.
* Entry points default to CUDA and raise without it; they never carry on
  on the CPU unless asked: the dispatch-mode gate (``interpose.enable``)
  and the unmodified workloads too.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.conftest import REPO_ROOT

PROBE = r"""
import importlib, os, pkgutil, sys
os.environ["TPUSHARE_DISABLE"] = "1"  # autoload is imported, not enabled
sys.path.insert(0, sys.argv[1])
import nvshare_tpu_torch
names = [m.name for m in pkgutil.walk_packages(nvshare_tpu_torch.__path__,
                                               "nvshare_tpu_torch.")]
for name in names:
    importlib.import_module(name)
want = {"nvshare_tpu_torch." + m for m in (
    "bench_tenant", "qos", "qos.spec", "qos.report", "runtime.chaos",
    "runtime.client", "telemetry.chrome_trace", "telemetry.prometheus",
    "telemetry.check", "telemetry.dump", "telemetry.fleet",
    "telemetry.top", "autoload", "parallel", "parallel.guard",
    "models.mlp", "utils.data", "utils.checkpoint", "workloads",
    "workloads.lm_train", "workloads.mlp_train", "parallel.collectives",
    "parallel.mesh", "parallel.ring_attention", "parallel.moe",
    "parallel.seq_transformer", "parallel.pipeline", "parallel.dryrun",
    "models.moe_transformer", "runtime.native")}
assert want <= set(names), sorted(want - set(names))
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
    assert int(n) >= 35, out.stdout
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
    """``$TPUSHARE_CHAOS`` is no longer refused: the link's socket is
    wrapped in the port's fault proxy, as the JAX package wraps its
    own, and a malformed spec still raises. The test keeps the name it
    had while the variable was refused, so that its record carries
    over."""
    import socket

    from nvshare_tpu_torch.runtime.chaos import ChaosSocket
    from nvshare_tpu_torch.runtime.protocol import SchedulerLink

    server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    path = str(tmp_path / "fake.sock")
    server.bind(path)
    server.listen(1)
    try:
        monkeypatch.setenv("TPUSHARE_CHAOS", "drop:0.5,seed:1")
        with SchedulerLink(path=path) as link:
            assert isinstance(link.sock, ChaosSocket)
            assert link.sock.config.drop_p == 0.5
        monkeypatch.setenv("TPUSHARE_CHAOS", "drop=0.5")
        with pytest.raises(ValueError):
            SchedulerLink(path=path)
    finally:
        server.close()


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


def test_training_entry_points_default_to_cuda_and_raise_without_it(
        no_cuda, monkeypatch):
    from nvshare_tpu_torch import colocate
    from nvshare_tpu_torch.convert import lm_state_from_numpy
    from nvshare_tpu_torch.models import Transformer, init_lm_state

    monkeypatch.setenv("TPUSHARE_SOCK_DIR", "/nonexistent")
    model = Transformer(vocab=16, dim=32, heads=2, depth=1, seq=128)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_lm_state(model)
    ones = {"ln_f": np.ones(32, np.float32)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_state_from_numpy(ones, {"m": ones})
    # The training workload runs on its tenant's device, which defaults
    # to cuda: building it is free, a tenant to run it raises.
    work = colocate.lm_train_workload(model, steps=1, batch=1)
    assert callable(work)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        colocate.Tenant("train-no-card")
    params, opt = init_lm_state(model, device="cpu")
    assert params["embed"].device.type == opt["m"]["embed"].device.type \
        == "cpu"


def test_wrappers_on_cpu_tensors_never_touch_the_kernels(no_cuda):
    from nvshare_tpu_torch.ops import (
        attention_delta,
        flash_attention,
        flash_attention_lse,
        flash_backward_dkv,
        flash_backward_dq,
        fused_mix,
        tiled_matmul,
    )

    a = torch.rand(256, 256)
    q = torch.rand(1, 256, 2, 64)
    counts = (fused_mix.launches, tiled_matmul.launches,
              flash_attention.launches, flash_backward_dq.launches,
              flash_backward_dkv.launches)
    before = [c.value for c in counts]
    fused_mix(a, a)
    tiled_matmul(a, a)
    flash_attention(q, q, q, causal=True)
    o, lse = flash_attention_lse(q, q, q)
    delta = attention_delta(o, o)
    flash_backward_dq(q, q, q, o, lse, delta, True)
    flash_backward_dkv(q, q, q, o, lse, delta, True)
    for dev in ("cpu", "meta"):
        qg = torch.rand(1, 256, 2, 64, device=dev, requires_grad=True)
        out, lse = flash_attention_lse(qg, qg, qg, causal=True)
        (out.sum() + lse.sum()).backward()
        assert qg.grad.device.type == dev
    assert [c.value for c in counts] == before


def test_chip_smoke_refuses_to_run_without_a_card():
    out = subprocess.run([sys.executable, str(REPO_ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_gate_and_workloads_default_to_cuda_and_raise_without_it(no_cuda):
    from nvshare_tpu_torch import interpose
    from nvshare_tpu_torch.utils.data import prefetch_to_device
    from nvshare_tpu_torch.workloads import lm_train, mlp_train

    with pytest.raises(RuntimeError, match="device='cpu'"):
        interpose.enable()
    assert not interpose.enabled()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_train.main(["--steps", "1", "--layers", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mlp_train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(prefetch_to_device(iter([np.zeros(2)])))


def test_parallel_entry_points_default_to_cuda_and_raise_without_it(
        no_cuda):
    from nvshare_tpu_torch.convert import (
        moe_lm_state_from_numpy,
        pipeline_params_from_numpy,
    )
    from nvshare_tpu_torch.models import MoETransformer, init_moe_lm_state
    from nvshare_tpu_torch.parallel import (
        Mesh,
        dryrun,
        init_moe_params,
        init_pipeline_params,
        init_ranks,
        make_mesh,
        make_seq_mesh,
    )
    from nvshare_tpu_torch.parallel.pipeline import (
        init_transformer_stage_params,
    )

    no_card = pytest.raises(RuntimeError, match="device='cpu'")
    model = MoETransformer(vocab=16, dim=32, heads=2, depth=1, seq=128,
                           experts=2)
    for call in (make_mesh, make_seq_mesh, lambda: Mesh((1,), ("seq",)),
                 lambda: init_moe_params(2, 8, 16),
                 lambda: init_pipeline_params(2, 8),
                 lambda: init_transformer_stage_params(2, 8),
                 model.init, lambda: init_moe_lm_state(model),
                 lambda: moe_lm_state_from_numpy(
                     {"ln_f": np.ones(4, np.float32)},
                     {"m": {"ln_f": np.ones(4, np.float32)}}),
                 lambda: pipeline_params_from_numpy(
                     {"w": np.ones((2, 4, 4), np.float32)}, 0),
                 lambda: init_ranks(0, 2, "/nonexistent/store"),
                 lambda: dryrun.spawn(2, []),
                 lambda: dryrun.main(["--world", "2"])):
        with no_card:
            call()
    assert make_mesh(device="cpu").device.type == "cpu"
    assert init_moe_params(2, 8, 16, device="cpu")["router"].device.type \
        == "cpu"
