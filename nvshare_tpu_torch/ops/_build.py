"""Build and load the port's CUDA kernels.

Each source in ``nvshare_tpu_torch/csrc/`` has a plain C interface and is
compiled by one ``nvcc`` call into its own shared library for ``sm_90a``,
then loaded with :mod:`ctypes` (no PyTorch headers, so a build takes
seconds, not minutes). Libraries land in ``build/torch_ext/`` at the repo
root, named by a hash of the source, every header in ``csrc/`` and the
flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is. :func:`build` starts one ``nvcc`` per source at once and
waits for all of them. :func:`use_sources` points the package at another
copy of ``csrc/`` (a variant under test, ``kernel_ab.py``).

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
SOURCES = {"mix": "mix.cu", "matmul_sm90": "matmul_sm90.cu",
           "attention": "attention.cu", "attention_bwd": "attention_bwd.cu",
           "attention_sm90": "attention_sm90.cu",
           "attention_bwd_sm90": "attention_bwd_sm90.cu"}
# -ldl: the wgmma kernels take the tensor-map encoder from the libcuda
# that PyTorch has loaded (csrc/sm90.cuh).
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-ldl")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class LaunchCount:
    """Launches of one kernel: its wrapper adds one where it launches, and
    nowhere else, so a run can show that its path went through the
    kernel. ``gated`` counts the launches made in a gated unit of the
    dispatch-mode gate (:func:`nvshare_tpu_torch.interpose.launch_unit`)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0
        self._gated = 0

    def add(self) -> None:
        from nvshare_tpu_torch import interpose

        gated = interpose.in_gated_unit()
        with self._lock:
            self._n += 1
            self._gated += gated

    @property
    def value(self) -> int:
        with self._lock:
            return self._n

    @property
    def gated(self) -> int:
        with self._lock:
            return self._gated

    def reset(self) -> None:
        with self._lock:
            self._n = 0
            self._gated = 0


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


def library_path(name: str, csrc: Optional[Path] = None) -> Path:
    csrc = CSRC if csrc is None else Path(csrc)
    key = hashlib.sha256((csrc / SOURCES[name]).read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        key.update(header.name.encode() + header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES),
          ptxas_verbose: bool = False,
          csrc: Optional[Path] = None) -> Dict[str, dict]:
    """Compile the named sources, one ``nvcc`` each, all started together.
    ``csrc``: the directory of the sources, by default the one
    :func:`use_sources` set (``csrc/``).

    Returns ``{name: {"path", "seconds", "log"}}``; ``seconds`` is the
    source's own ``nvcc`` wall time, 0 for a library that was already
    built. ``ptxas_verbose`` adds ``-Xptxas=-v``
    (registers, shared memory and spills per kernel, in ``log``); it does
    not change the binary, so it is not part of the hash. Raises with the
    compiler's output if any build fails.
    """
    csrc = CSRC if csrc is None else Path(csrc)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    results: Dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name, csrc)
        if out.exists():
            results[name] = {"path": str(out), "seconds": 0.0, "log": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc(), "-o", str(tmp), str(csrc / SOURCES[name]),
               *NVCC_FLAGS]
        if ptxas_verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)

    def wait(proc):
        log, _ = proc.communicate()
        return log, time.perf_counter() - t0

    # One waiter a compiler, so that each source's time is its own.
    with ThreadPoolExecutor(max(len(procs), 1)) as pool:
        waited = {name: pool.submit(wait, proc)
                  for name, (proc, _, _) in procs.items()}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, seconds = waited[name].result()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {SOURCES[name]} (rc "
                          f"{proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
        results[name] = {"path": str(out), "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return results


def use_sources(csrc: Path) -> None:
    """Build and load the kernels from ``csrc`` from now on: a directory
    laid out as ``csrc/``. The libraries loaded so far stay loaded but are
    no longer handed out."""
    global CSRC
    with _lock:
        CSRC = Path(csrc).resolve()
        _libs.clear()


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


def _bind(name: str, lib) -> None:
    """Set the argument and result types of ``name``'s entry points on
    ``lib`` (a loaded library, or any object whose attributes take
    ``argtypes`` and ``restype``). A pointer bound as an int would be cut
    to 32 bits, so these must match the C signatures exactly."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    if name == "mix":
        entries = {"tpushare_fused_mix": [p, p, p, ll, i, f, f, f, p]}
    elif name == "matmul_sm90":
        entries = {"tpushare_tiled_matmul_sm90": [p, p, p, i, i, i, i, p]}
    elif name in ("attention", "attention_sm90"):
        # Both routes of K3 take the same arguments.
        suffix = name[len("attention"):]
        entries = {f"tpushare_flash_forward{suffix}":
                   [p, p, p, p, p, *([i] * 5), *([ll] * 9), i, i, f, p]}
    elif name in ("attention_bwd", "attention_bwd_sm90"):
        # Both routes of K4 and of K5 take the same arguments.
        suffix = name[len("attention_bwd"):]
        entries = {f"tpushare_flash_backward_{which}{suffix}":
                   [*([p] * (7 + outs)), *([i] * 5), *([ll] * 12), i, i, f,
                    p]
                   for which, outs in (("dq", 1), ("dkv", 2))}
    else:
        raise KeyError(name)
    for entry, argtypes in entries.items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
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
