"""Build and load the port's CUDA kernels.

Each source in ``nvshare_tpu_torch/csrc/`` has a plain C interface and is
compiled by one ``nvcc`` call into its own shared library for ``sm_90a``,
then loaded with :mod:`ctypes` (no PyTorch headers, so a build takes
seconds, not minutes). Libraries land in ``build/torch_ext/`` at the repo
root, named by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. :func:`build` starts one
``nvcc`` per source at once and waits for all of them.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
SOURCES = {"mix": "mix.cu", "matmul": "matmul.cu",
           "attention": "attention.cu"}
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class LaunchCount:
    """Launches of one kernel: its wrapper adds one where it launches, and
    nowhere else, so a run can show that its path went through the
    kernel."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        with self._lock:
            return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``'s,
    or the one on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES),
          ptxas_verbose: bool = False) -> Dict[str, dict]:
    """Compile the named sources, one ``nvcc`` each, all started together.

    Returns ``{name: {"path", "seconds", "log"}}``; ``seconds`` is 0 for a
    library that was already built. ``ptxas_verbose`` adds ``-Xptxas=-v``
    (registers, shared memory and spills per kernel, in ``log``); it does
    not change the binary, so it is not part of the hash. Raises with the
    compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    results: Dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            results[name] = {"path": str(out), "seconds": 0.0, "log": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        if ptxas_verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {SOURCES[name]} (rc "
                          f"{proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
        results[name] = {"path": str(out),
                         "seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _bind(name, lib)
            _libs[name] = lib
        return lib


def _bind(name: str, lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "mix":
        fn = lib.tpushare_fused_mix
        fn.argtypes = [p, p, p, ctypes.c_longlong, i, f, f, f, p]
    elif name == "matmul":
        fn = lib.tpushare_tiled_matmul
        fn.argtypes = [p, p, p, i, i, i, i, i, p]
    elif name == "attention":
        fn = lib.tpushare_flash_forward
        ll = ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, *([ll] * 9), i, i, f, p]
    else:
        raise KeyError(name)
    fn.restype = ctypes.c_int


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


def dtype_code(dtype, what: str) -> int:
    import torch

    code: Optional[int] = {torch.float32: 0, torch.bfloat16: 1}.get(dtype)
    if code is None:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, "
                        f"not {dtype}")
    return code
