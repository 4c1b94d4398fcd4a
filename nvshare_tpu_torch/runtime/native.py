"""Run an unmodified program under the native interposer,
``libtpushare_cuda.so``.

The port of ``nvshare_tpu/runtime/native.py``. This is the deployment
shape: the device plugin injects the environment :func:`preload_env`
returns (as the reference injects ``LD_PRELOAD``, server.go:219-277),
and the application is unmodified PyTorch that imports nothing of this
package. Gating and the allocation policy happen inside the library, one
layer below the CUDA runtime: it interposes the driver API
(``nvshare_tpu_torch/native/hook_cuda.cpp``).

What has no counterpart here: ``plugin_options`` and
``register_native_platform`` register the JAX package's interposer as a
PJRT plugin and hand it a TPU rig's options. On CUDA the library is
preloaded when the process starts, which takes the place of both, and
``default_real_plugin`` becomes :func:`default_real_libcuda`.

:func:`build` runs ``make -C nvshare_tpu_torch/native`` (g++ only; it
links ``libtpushare_client.so`` from ``src/``); nothing is built at
import.
"""

from __future__ import annotations

import fcntl
import os
import re
import subprocess
from pathlib import Path
from typing import Optional

REPO_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = REPO_ROOT / "nvshare_tpu_torch" / "native"
#: Where :func:`build` puts the hook, the mock driver (``mock/``) and the
#: test driver; git ignores it.
BUILD_DIR = REPO_ROOT / "build" / "cuda_hook"
HOOK_NAME = "libtpushare_cuda.so"
TEST_DRIVER_NAME = "tpushare-cuda-hook-test"
#: The prefix of the hook's startup line and of its exit line on stderr.
REPORT_PREFIX = "tpushare-cuda-hook:"


def default_hook_path() -> str:
    """``$TPUSHARE_HOOK``, else the hook in the port's build directory."""
    return os.environ.get("TPUSHARE_HOOK", str(BUILD_DIR / HOOK_NAME))


def default_real_libcuda() -> str:
    """The driver the hook wraps: ``$TPUSHARE_REAL_LIBCUDA``, else
    ``libcuda.so.1`` as the dynamic loader finds it."""
    return os.environ.get("TPUSHARE_REAL_LIBCUDA", "libcuda.so.1")


def default_client_dir() -> str:
    """The directory of ``libtpushare_client.so``: ``$TPUSHARE_LIB_DIR``,
    else ``src/build``."""
    return os.environ.get("TPUSHARE_LIB_DIR", str(REPO_ROOT / "src" / "build"))


def build(build_dir=None, client_dir=None, timeout_s: float = 600,
          hook_only: bool = False) -> Path:
    """Build the hook, the mock driver and the test driver (the hook
    alone with ``hook_only``: a machine with the real driver needs no
    more) with ``make`` into ``build_dir`` (:data:`BUILD_DIR` by
    default), linking the client library in ``client_dir``
    (:func:`default_client_dir`). Concurrent callers build one at a time
    under an exclusive lock on a file beside the build directory, so
    that a second caller finds the first one's products instead of
    linking half-written ones. ``make`` runs without ``LD_PRELOAD``.
    Raises ``RuntimeError`` with make's output when the build fails.
    Returns the build directory."""
    build_dir = Path(build_dir or BUILD_DIR).resolve()
    build_dir.parent.mkdir(parents=True, exist_ok=True)
    cmd = ["make", "-C", str(NATIVE_DIR), f"BUILD={build_dir}",
           f"CLIENT_DIR={Path(client_dir or default_client_dir()).resolve()}"]
    if hook_only:
        cmd.append(str(build_dir / HOOK_NAME))
    env = {k: v for k, v in os.environ.items() if k != "LD_PRELOAD"}
    with open(build_dir.parent / f".{build_dir.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            out = subprocess.run(cmd, env=env, capture_output=True,
                                 text=True, timeout=timeout_s)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if out.returncode != 0:
        raise RuntimeError(f"building the CUDA hook failed:\n{out.stdout}"
                           f"{out.stderr}")
    return build_dir


def preload_env(env: Optional[dict] = None, *, hook=None, client_dir=None,
                sock_dir=None, real_libcuda=None) -> dict:
    """The environment the device plugin would inject into a tenant:
    ``env`` (``os.environ`` by default) with the hook prepended to
    ``LD_PRELOAD``, the client library's directory prepended to
    ``LD_LIBRARY_PATH``, and ``TPUSHARE_SOCK_DIR`` /
    ``TPUSHARE_REAL_LIBCUDA`` set where given. Raises
    ``FileNotFoundError`` when the hook is not built: the dynamic loader
    would otherwise skip it with a warning and run the program ungated."""
    out = dict(os.environ if env is None else env)
    hook = Path(hook or default_hook_path())
    if not hook.is_file():
        raise FileNotFoundError(f"no CUDA hook at {hook}; build it with "
                                "nvshare_tpu_torch.runtime.native.build()")
    prev = out.get("LD_PRELOAD")
    out["LD_PRELOAD"] = f"{hook}:{prev}" if prev else str(hook)
    lib_dir = str(client_dir or default_client_dir())
    prev = out.get("LD_LIBRARY_PATH")
    out["LD_LIBRARY_PATH"] = f"{lib_dir}:{prev}" if prev else lib_dir
    if sock_dir is not None:
        out["TPUSHARE_SOCK_DIR"] = str(sock_dir)
    if real_libcuda is not None:
        out["TPUSHARE_REAL_LIBCUDA"] = str(real_libcuda)
    return out


_FIELD = re.compile(r"(\w+)=(\S+)")


def hook_report(output: str) -> Optional[dict]:
    """The counters of the hook's exit line in a process's ``output``
    (its last one), as ints, with ``callers`` a dict of the launches by
    the object that called the driver; None when the output has no exit
    line."""
    lines = [ln for ln in output.splitlines()
             if ln.startswith(REPORT_PREFIX) and " pid=" in ln]
    if not lines:
        return None
    fields = dict(_FIELD.findall(lines[-1]))
    callers = {}
    if fields.get("callers", "-") != "-":
        for item in fields["callers"].split(","):
            name, n = item.rsplit(":", 1)
            callers[name] = int(n)
    out = {k: int(v) for k, v in fields.items() if k != "callers"}
    out["callers"] = callers
    return out


def preloaded(output: str) -> bool:
    """Whether the hook's startup line is in a process's ``output``."""
    return any(ln.startswith(f"{REPORT_PREFIX} preloaded")
               for ln in output.splitlines())
