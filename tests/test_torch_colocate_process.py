"""End-to-end co-location of two unmodified PyTorch processes.

The counterpart of ``tests/test_colocate.py``: two CPU processes, each
made a tenant by one line (``interpose.enable(device="cpu")``, what
``import nvshare_tpu_torch.autoload`` does on a card), run the port's
unmodified workloads (``workloads/lm_train.py`` and ``mlp_train.py`` at
CPU sizes) against one scheduler. Under a 1 s quantum the scheduler's
own log must show both granted and quanta expiring; with scheduling off
they free-run. Either way every loss and the final state sum equal the
same program run alone, ungated, bit for bit. Also: ``import
nvshare_tpu_torch.autoload`` raises without a card and does nothing
under ``TPUSHARE_DISABLE=1``.
"""

import inspect
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from tests.conftest import REPO_ROOT, SchedulerProc

def run_workload(name: str) -> None:
    """The unmodified workload ``name`` at CPU sizes: a few seconds of
    work each, several 1 s quanta apiece."""
    from nvshare_tpu_torch.models.mlp import MLP
    from nvshare_tpu_torch.models.transformer import Transformer
    from nvshare_tpu_torch.workloads import lm_train, mlp_train

    if name == "lm":
        lm_train.run(Transformer(vocab=256, dim=128, heads=2, depth=2,
                                 seq=128, remat=True),
                     steps=48, batch=4, device="cpu", name="lm")
    else:
        mlp_train.run(MLP(in_dim=64, hidden_dim=128, out_dim=16, depth=3),
                      steps=500, batch=64, device="cpu", name="mlp")


# A tenant process: the one line a CPU tenant needs, then the workload.
WORKER = ("import sys\nsys.path.insert(0, sys.argv[1])\n"
          "from nvshare_tpu_torch import interpose\n"
          "interpose.enable(device='cpu')\n"
          + inspect.getsource(run_workload)
          + "run_workload(sys.argv[2])\n")


def _result(name, out):
    for line in out.splitlines():
        if line.startswith(f"{name} RESULT "):
            return json.loads(line.split(" RESULT ", 1)[1])
    raise AssertionError(f"{name} printed no RESULT:\n{out[-2000:]}")


def _gated_total() -> int:
    from nvshare_tpu_torch import interpose

    fam = interpose._exec_counter()
    return int(sum(child.value for _, child in fam.samples()))


def _solo(name, capsys):
    """The workload run here, ungated; its gated-op count is this
    process's running total, which must not move."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # as the tenants run: the same sums
    before = _gated_total()
    try:
        run_workload(name)
    finally:
        torch.set_num_threads(threads)
    res = _result(name, capsys.readouterr().out)
    assert res["gated_ops"] == before
    return res


def _pair(sock_dir):
    # One compute thread a tenant: the pair shares the test's cores.
    env = dict(os.environ, TPUSHARE_SOCK_DIR=str(sock_dir),
               TPUSHARE_PURE_PYTHON="1", TPUSHARE_REQUIRE_SCHEDULER="1",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", WORKER, str(REPO_ROOT), name],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in ("lm", "mlp")}
    outs = {}
    for name, p in procs.items():
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-4000:]
        outs[name] = _result(name, out)
    return outs


def _same_as_solo(pair, capsys):
    for name, res in pair.items():
        solo = _solo(name, capsys)
        assert res["gate"] and res["gated_ops"] > 0, res
        assert not solo["gate"]
        assert res["losses"] == solo["losses"], name
        assert res["state_sum"] == solo["state_sum"], name


def test_two_torch_processes_serialize_into_quanta(tmp_path, native_build,
                                                   capsys):
    s = SchedulerProc(tmp_path, tq_sec=1)
    try:
        pair = _pair(tmp_path)
    finally:
        err = s.stop()
    # The scheduler's own protocol log: both tenants were granted the
    # lock, and the quantum expired mid-run.
    granted = set(re.findall(r"LOCK_OK -> \S+ \(id ([0-9a-f]+)\)", err))
    assert len(granted) >= 2, f"both tenants must be granted: {err}"
    assert "DROP_LOCK" in err, f"TQ never expired: {err}"
    _same_as_solo(pair, capsys)


def test_sched_off_free_runs(tmp_path, native_build, capsys):
    s = SchedulerProc(tmp_path, tq_sec=1)
    try:
        assert s.ctl("-S", "off").returncode == 0
        pair = _pair(tmp_path)
    finally:
        err = s.stop()
    assert "DROP_LOCK" not in err
    _same_as_solo(pair, capsys)


AUTOLOAD = r"""
import sys
sys.path.insert(0, sys.argv[1])
import torch
torch.cuda.is_available = lambda: False   # a machine without a card
import nvshare_tpu_torch.autoload
from nvshare_tpu_torch import interpose
print("enabled", interpose.enabled())
"""


@pytest.mark.parametrize("disable", ["0", "1"])
def test_autoload_raises_without_a_card_unless_disabled(disable):
    env = dict(os.environ, TPUSHARE_DISABLE=disable)
    out = subprocess.run([sys.executable, "-c", AUTOLOAD, str(REPO_ROOT)],
                         capture_output=True, text=True, timeout=120,
                         env=env)
    if disable == "1":
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "enabled False"
    else:
        assert out.returncode != 0
        assert "no CUDA device is available" in out.stderr
        assert "enabled" not in out.stdout
