"""``nvshare_tpu_torch.runtime.native``, the port of
``nvshare_tpu/runtime/native.py``: where the hook is found, the
environment the device plugin would inject, the build under its lock, and
a program run under that environment against the mock driver, which
registers with the scheduler."""

import os
import subprocess
import threading

import pytest

import nvshare_tpu.runtime.native as ref
from nvshare_tpu_torch.runtime import native
from tests.conftest import REPO_ROOT

pytestmark = pytest.mark.usefixtures("native_build")


@pytest.fixture(scope="module")
def cuda_hook(native_build):
    return native.build()


def test_default_hook_path_and_its_override(monkeypatch):
    monkeypatch.delenv("TPUSHARE_HOOK", raising=False)
    assert native.default_hook_path() == str(
        REPO_ROOT / "build" / "cuda_hook" / "libtpushare_cuda.so")
    # The same variable overrides both packages' default.
    monkeypatch.setenv("TPUSHARE_HOOK", "/opt/hook.so")
    assert native.default_hook_path() == ref.default_hook_path() == \
        "/opt/hook.so"


def test_default_real_libcuda_and_its_override(monkeypatch):
    monkeypatch.delenv("TPUSHARE_REAL_LIBCUDA", raising=False)
    assert native.default_real_libcuda() == "libcuda.so.1"
    monkeypatch.setenv("TPUSHARE_REAL_LIBCUDA", "/mock/libcuda.so.1")
    assert native.default_real_libcuda() == "/mock/libcuda.so.1"


def test_preload_env_prepends_to_what_is_there(cuda_hook, tmp_path):
    hook = cuda_hook / native.HOOK_NAME
    env = {"LD_PRELOAD": "/usr/lib/libother.so", "LD_LIBRARY_PATH": "/a:/b",
           "PATH": "/usr/bin"}
    out = native.preload_env(env, hook=hook, client_dir="/clients",
                             sock_dir=tmp_path, real_libcuda="/mock/lib")
    assert out["LD_PRELOAD"] == f"{hook}:/usr/lib/libother.so"
    assert out["LD_LIBRARY_PATH"] == "/clients:/a:/b"
    assert out["TPUSHARE_SOCK_DIR"] == str(tmp_path)
    assert out["TPUSHARE_REAL_LIBCUDA"] == "/mock/lib"
    assert out["PATH"] == "/usr/bin"
    assert env["LD_PRELOAD"] == "/usr/lib/libother.so"  # not mutated
    bare = native.preload_env({}, hook=hook)
    assert bare["LD_PRELOAD"] == str(hook)
    assert bare["LD_LIBRARY_PATH"] == native.default_client_dir()
    assert "TPUSHARE_SOCK_DIR" not in bare


def test_preload_env_refuses_a_missing_hook(tmp_path):
    with pytest.raises(FileNotFoundError, match="no CUDA hook"):
        native.preload_env({}, hook=tmp_path / "absent.so")


def test_build_products_land_in_an_ignored_directory(cuda_hook):
    for rel in (native.HOOK_NAME, "mock/libcuda.so.1",
                native.TEST_DRIVER_NAME):
        assert (cuda_hook / rel).is_file(), rel
    out = subprocess.run(["git", "check-ignore", "-q",
                          str(cuda_hook / native.HOOK_NAME)], cwd=REPO_ROOT)
    assert out.returncode == 0, "the build directory is not git-ignored"


def test_build_hook_only(cuda_hook, tmp_path):
    """What a machine with the real driver builds: the hook alone."""
    out = native.build(tmp_path / "hook", hook_only=True)
    assert sorted(os.listdir(out)) == [native.HOOK_NAME]


def test_concurrent_builds_wait_for_each_other(cuda_hook):
    """Callers build one at a time under the lock; all succeed and find
    the same products."""
    errors = []

    def one():
        try:
            native.build()
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


def test_a_program_under_preload_env_registers(sched, cuda_hook):
    mock = cuda_hook / "mock"
    env = native.preload_env(
        dict(os.environ, LD_LIBRARY_PATH=str(mock),
             TPUSHARE_JOB_NAME="preloaded"),
        hook=cuda_hook / native.HOOK_NAME, sock_dir=sched.sock_dir,
        real_libcuda=mock / "libcuda.so.1")
    out = subprocess.run([str(cuda_hook / native.TEST_DRIVER_NAME), "2"],
                         env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert native.preloaded(out.stderr)
    assert "registered with scheduler" in out.stderr
    report = native.hook_report(out.stderr)
    assert report["launches"] == 2 and report["copies"] == 2
    log = sched.stop()
    assert "registered -/preloaded" in log, log


def test_hook_report_parses_the_exit_line():
    text = ("tpushare-cuda-hook: preloaded (pid 7)\nnoise\n"
            "tpushare-cuda-hook: pid=7 launches=12 copies=3 memsets=1 "
            "fences=4 fence_timeouts=0 window_max=8 allocated_bytes=0 "
            "peak_allocated_bytes=4096 refused=0 "
            "callers=libcudart.so.12:9,attention_sm90-1a2b.so:3\n")
    assert native.preloaded(text)
    report = native.hook_report(text)
    assert report["launches"] == 12 and report["window_max"] == 8
    assert report["callers"] == {"libcudart.so.12": 9,
                                 "attention_sm90-1a2b.so": 3}
    assert native.hook_report("nothing here") is None
    assert not native.preloaded("nothing here")
