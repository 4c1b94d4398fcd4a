#!/usr/bin/env python3
"""Drive nvshare_tpu_torch end to end on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and
``make``/``g++``; exits non-zero without printing a result otherwise.

Phases (each one's seconds are printed; any failure exits non-zero):

1. Environment: PyTorch and CUDA versions, the card's name and power
   limit, host ``MemAvailable``.
2. Build, all at once: the two CUDA kernels (one ``nvcc`` per source in
   ``nvshare_tpu_torch/csrc/``) and ``tpushare-scheduler``/``tpusharectl``
   from ``src/`` into ``build/sched/``.
3. Kernel checks on the card against the plain PyTorch versions:
   ``fused_mix`` bit-exact in f32 and bf16 at one full burner chunk
   (8192x8192) and at 16384x16384; ``tiled_matmul`` within rtol 1e-4, atol 1e-4*max|want| at
   256x384 @ 384x128, 4096^3 and one full chunk (TF32 off for the plain
   version). Times from CUDA events; ``torch.matmul`` in bf16 is timed as
   the library yardstick for the matmul kernel.
4. The main path, once per burner kind (matmul through the tile kernel
   with ``TPUSHARE_PALLAS_MATMUL=1``, then add through the mix kernel):
   a private scheduler, one ``PhysicalPool`` of the arena budget, a short
   calibration run that measures the step time (which sets the number of
   steps), a solo tenant, then two
   co-located tenants whose working sets together exceed the card's
   memory, each handed off at least twice under a quantum of at least 3x
   one measured handoff cycle. Every co-located checksum must
   equal the solo checksum exactly, both tenants must be granted and
   dropped, both must evict and prefetch, and the kernel of the kind must
   have launched during the run.

Sizing: chunks are 8192x8192 f32 (exactly 256 MiB, a power of two, so
PyTorch's pinned host allocator, which rounds blocks up to powers of two,
wastes nothing, and fine enough to size a working set within 0.1% of a
target). Each tenant's working set is 0.85 of the budget unless host
memory cannot hold both tenants' pinned shadows (2x the working set, all
held at once while one tenant evicts and the other's set waits on the
host); then it is lowered to what the host holds, but never to a pair
that fits in the card's memory: the pair must oversubscribe the card.

The last lines are the card's name and power limit, one JSON line of
kernel measurements, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from nvshare_tpu_torch import vmem  # noqa: E402
from nvshare_tpu_torch.colocate import (  # noqa: E402
    Tenant,
    burner_workload,
    run_colocated,
)
from nvshare_tpu_torch.models.burner import AddBurner, MatmulBurner  # noqa: E402
from nvshare_tpu_torch.ops import _build  # noqa: E402
from nvshare_tpu_torch.ops import (  # noqa: E402
    fused_mix,
    fused_mix_reference,
    tiled_matmul,
    tiled_matmul_reference,
)

GiB = 1 << 30
CHUNK_SIDE = 8192                      # f32: exactly 256 MiB per chunk
CHUNK_BYTES = CHUNK_SIDE * CHUNK_SIDE * 4
WSS_FRACTION = 0.85                    # of the budget, per tenant
# Host memory kept free of pinned shadows, below MemAvailable: the
# process's own growth, plus the gap between what the kernel reports
# available and a per-job memory limit set below the host's total
# (96 GiB of 101 GiB on the single-H100 hosts this was sized on).
HOST_HEADROOM = 8 * GiB
DEVICE_RATIO = 0.9
# Datasheet rates of the H100 SXM (NVIDIA): HBM3 bandwidth, dense bf16
# tensor-core peak, f32 peak outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

SCHED_DIR = REPO / "build" / "sched"


def log(msg: str) -> None:
    print(msg, flush=True)


def meminfo(key: str = "MemAvailable") -> int:
    """Bytes of one /proc/meminfo field."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith(key + ":"):
            return int(line.split()[1]) * 1024
    raise RuntimeError(f"{key} missing from /proc/meminfo")


def mem_available() -> int:
    return meminfo("MemAvailable")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Phases:
    """Seconds per phase, printed as each one ends."""

    def __init__(self):
        self.seconds: dict = {}

    def run(self, name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.seconds[name] = round(time.perf_counter() - t0, 3)
        log(f"[phase] {name}: {self.seconds[name]} s")
        return out


# -- build -------------------------------------------------------------------

def build_all() -> dict:
    SCHED_DIR.mkdir(parents=True, exist_ok=True)
    targets = [str(SCHED_DIR / "tpushare-scheduler"),
               str(SCHED_DIR / "tpusharectl")]
    t0 = time.perf_counter()
    make = subprocess.Popen(
        ["make", "-C", str(REPO / "src"), "-j8", f"BUILD={SCHED_DIR}",
         *targets], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        kernels = _build.build(ptxas_verbose=True)
    finally:
        make_log, _ = make.communicate()
    make_s = time.perf_counter() - t0
    if make.returncode != 0:
        raise RuntimeError(f"scheduler build failed:\n{make_log}")
    for name, info in kernels.items():
        log(f"built {name}: {info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    log(f"built scheduler + ctl: {make_s:.1f} s")
    return {k: v["seconds"] for k, v in kernels.items()}


# -- kernel checks -----------------------------------------------------------

def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` launches (CUDA events,
    one warm-up call first)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_mix(gen) -> dict:
    """fused_mix against its plain version, bit for bit."""
    entry = None
    for dtype in (torch.float32, torch.bfloat16):
        for side in (CHUNK_SIDE, 16384):
            a = torch.rand((side, side), generator=gen, device="cuda"
                           ).to(dtype)
            b = torch.rand((side, side), generator=gen, device="cuda"
                           ).to(dtype)
            got = fused_mix(a, b)
            want = fused_mix_reference(a, b)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                err = (got.float() - want.float()).abs().max().item()
                raise AssertionError(
                    f"fused_mix {dtype} {side}^2 differs from the plain "
                    f"version (max abs err {err})")
            ms = cuda_ms(lambda: fused_mix(a, b, out=got), 20)
            plain_ms = cuda_ms(lambda: fused_mix_reference(a, b), 20)
            nbytes = 3 * a.numel() * a.element_size()
            bound_ms = max(nbytes / HBM_BYTES_PER_S,
                           3 * a.numel() / F32_FLOPS) * 1e3
            log(f"K1 fused_mix {str(dtype)[6:]} {side}x{side}: exact; "
                f"{ms:.3f} ms ({nbytes / ms / 1e6:.0f} GB/s), plain "
                f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms")
            if dtype == torch.float32 and side == CHUNK_SIDE:  # main path
                entry = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": "bytes",
                         "library_ms": None}
            del a, b, got, want
    torch.cuda.empty_cache()
    return entry


def check_matmul(gen) -> dict:
    """tiled_matmul against its plain version (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    entry = None
    for m, k, n in ((256, 384, 128), (4096, 4096, 4096),
                    (CHUNK_SIDE, CHUNK_SIDE, CHUNK_SIDE)):  # last: main path
        a = torch.rand((m, k), generator=gen, device="cuda")
        b = torch.rand((k, n), generator=gen, device="cuda")
        got = tiled_matmul(a, b)
        want = tiled_matmul_reference(a, b)
        torch.cuda.synchronize()
        max_want = want.abs().max().item()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * max_want)
        del got, want
        reps = 5
        ms = cuda_ms(lambda: tiled_matmul(a, b), reps)
        plain_ms = cuda_ms(lambda: tiled_matmul_reference(a, b), reps)
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        lib_ms = cuda_ms(lambda: torch.matmul(a16, b16), reps)
        del a16, b16
        flops = 2.0 * m * n * k
        nbytes = (m * k + k * n + m * n) * 4
        ops_ms = flops / BF16_FLOPS * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        log(f"K2 tiled_matmul f32 {m}x{k} @ {k}x{n}: max abs err {err:.4g} "
            f"(max|want| {max_want:.4g}); {ms:.3f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), plain f32 {plain_ms:.3f} ms, "
            f"torch.matmul bf16 {lib_ms:.3f} ms "
            f"({flops / lib_ms / 1e9:.1f} TFLOP/s), bound {bound_ms:.3f} ms")
        if m == CHUNK_SIDE:
            entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms,
                     "bound_by": "operations" if ops_ms >= bytes_ms
                     else "bytes",
                     "library_ms": lib_ms}
        del a, b
    torch.cuda.empty_cache()
    return entry


# -- main path ---------------------------------------------------------------

class Scheduler:
    """A private tpushare-scheduler whose log goes to a file."""

    def __init__(self, sock_dir: str, tq: int):
        self.sock_dir = sock_dir
        self.log_path = Path(sock_dir) / "scheduler.log"
        env = dict(os.environ, TPUSHARE_SOCK_DIR=sock_dir,
                   TPUSHARE_TQ=str(tq))
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [str(SCHED_DIR / "tpushare-scheduler")], env=env,
            stdout=subprocess.DEVNULL, stderr=self._log)
        sock = Path(sock_dir) / "scheduler.sock"
        deadline = time.time() + 10
        while not sock.exists():
            if self.proc.poll() is not None or time.time() > deadline:
                raise RuntimeError("scheduler did not start: "
                                   + self.log_path.read_text())
            time.sleep(0.02)

    def set_tq(self, tq: int) -> None:
        subprocess.run([str(SCHED_DIR / "tpusharectl"), "-T", str(tq)],
                       env=dict(os.environ, TPUSHARE_SOCK_DIR=self.sock_dir),
                       check=True, capture_output=True, timeout=30)

    def text(self) -> str:
        self._log.flush()
        return self.log_path.read_text()

    def stop(self) -> None:
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self._log.close()


def rss_bytes() -> int:
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) * 1024
    return 0


def pinned_bytes(key: str = "current") -> int:
    """Bytes PyTorch's pinned host allocator holds for live tensors."""
    return int(torch.cuda.memory.host_memory_stats().get(
        f"allocated_bytes.{key}", 0))


def pinned_rounding() -> int:
    """Bytes the pinned host allocator holds for a 3 MiB request."""
    before = pinned_bytes()
    t = torch.empty(3 << 20, dtype=torch.uint8, pin_memory=True)
    held = pinned_bytes() - before
    del t
    return held


def size_working_set(budget: int, physical: int) -> int:
    """Per-tenant working set in whole chunks (see the module docstring)."""
    avail = mem_available()
    host = avail - HOST_HEADROOM
    frac = min(WSS_FRACTION, host / (2 * budget))
    chunks = int(frac * budget // CHUNK_BYTES)
    wss = chunks * CHUNK_BYTES
    log(f"budget {budget / GiB:.2f} GiB of {physical / GiB:.2f} GiB; host "
        f"MemTotal {meminfo('MemTotal') / GiB:.2f} GiB, MemAvailable "
        f"{avail / GiB:.2f} GiB, process RSS {rss_bytes() / GiB:.2f} GiB; "
        f"WSS fraction used {wss / budget:.4f} ({chunks} chunks of "
        f"{CHUNK_BYTES >> 20} MiB, {wss / GiB:.2f} GiB; pair "
        f"{2 * wss / budget:.4f}x the budget, {2 * wss / physical:.4f}x the "
        "card's memory)")
    if 2 * wss <= physical:
        raise RuntimeError(
            f"host memory holds pinned shadows for a pair of only "
            f"{2 * wss / physical:.3f}x the card's memory; the pair must "
            "oversubscribe the card")
    return chunks


def measure_handoff_cycle(chunks: int, budget: int) -> float:
    """Seconds of one warm handoff cycle of a dirty working set of
    ``chunks`` chunks: a probe tenant generates it on the card, then evicts
    it to pinned shadows and prefetches it back through the arena's own
    DROP_LOCK/LOCK_OK hooks. The first, untimed round materializes the
    shadows; PyTorch keeps the pinned blocks cached, so the timed round
    (on a freshly generated set) and the burners that follow reuse them."""
    out = {}

    def work(tenant: Tenant):
        a = tenant.arena
        # The probe pages explicitly while it holds the lock; count it as
        # an op in flight (the arena's busy signal), or the client's idle
        # detector would release the lock under it.
        with a._lock:
            a._busy_depth += 1
        try:
            cycles(a)
        finally:
            with a._lock:
                a._busy_depth -= 1

    def cycles(a):
        for timed in (False, True):
            vas = [a.device_array((CHUNK_SIDE, CHUNK_SIDE), torch.float32,
                                  seed=i) for i in range(chunks)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a.sync_and_evict_all()
            a.prefetch_hot()
            torch.cuda.synchronize()
            if timed:
                out["cycle_s"] = time.perf_counter() - t0
            if not all(va.resident for va in vas):
                raise AssertionError("prefetch did not bring the set back")
            for va in vas:
                va.delete()

    probe = Tenant("handoff-probe", budget_bytes=budget,
                   pool=vmem.PhysicalPool(budget))
    try:
        probe.run(work)
    finally:
        probe.close()
    return out["cycle_s"]


def calibrate_step(kind: str, chunks: int, budget: int,
                   kernel_step_s: float) -> float:
    """Seconds of one burner step of ``kind`` at this working set: the
    median interval between steps of a short solo run (host time included:
    ``vop`` and the wrappers cost per chunk on top of the kernels, which
    alone predict ``kernel_step_s``; the median keeps a slow first step
    out)."""
    steps = max(5, math.ceil(2.0 / kernel_step_s))
    cls = MatmulBurner if kind == "matmul" else AddBurner
    stamps: list = []

    def work(tenant: Tenant):
        burner = cls(chunks * CHUNK_BYTES, chunks=chunks, arena=tenant.arena,
                     device_ratio=DEVICE_RATIO)

        def hook(_step):
            tenant.client.mark_activity()
            stamps.append(time.perf_counter())

        burner.run(steps, step_hook=hook)

    cal = Tenant(f"{kind}-calibrate", budget_bytes=budget,
                 pool=vmem.PhysicalPool(budget))
    try:
        cal.run(work)
    finally:
        cal.close()
    gaps = [b - a for a, b in zip(stamps, stamps[1:])]
    step_s = statistics.median(gaps)
    log(f"[{kind}] calibration: {steps} steps, median step {step_s:.3f} s "
        f"(kernels alone {kernel_step_s:.3f} s), slowest {max(gaps):.3f} s")
    return step_s


def run_kind(kind: str, chunks: int, budget: int, sched: Scheduler,
             step_s: float, tq: int) -> dict:
    """Solo, then the co-located pair, of one burner kind."""
    wss = chunks * CHUNK_BYTES
    # Each tenant's device work spans >= 3 quanta, so with both tenants
    # waiting on each other it is dropped at least twice.
    steps = max(3, math.ceil(3.0 * tq / step_s) + 2)
    log(f"[{kind}] {steps} steps, measured {step_s:.3f} s/step, TQ {tq} s")

    def workload():
        return burner_workload(kind, wss, steps, chunks=chunks,
                               device_ratio=DEVICE_RATIO)

    torch.cuda.reset_peak_memory_stats()
    solo = Tenant(f"{kind}-solo", budget_bytes=budget,
                  pool=vmem.PhysicalPool(budget))
    try:
        t0 = time.time()
        solo_res = solo.run(workload())
        solo_wall = time.time() - t0
    finally:
        solo.close()
    if not solo_res.passed:
        raise AssertionError(f"{kind} solo checksum not finite")
    pool = vmem.PhysicalPool(budget)
    tenants = [Tenant(f"{kind}-t{i}", budget_bytes=budget, pool=pool)
               for i in (1, 2)]
    try:
        report = run_colocated({t: workload() for t in tenants},
                               timeout_s=900)
        stats = {t.name: t.telemetry_snapshot() for t in tenants}
        drops = {t.name: int(t.client._m["drops"].value) for t in tenants}
        handoff = {t.name: (t.arena._m_handoff_s.sum,
                            t.arena._m_handoff_s.count) for t in tenants}
    finally:
        for t in tenants:
            t.close()
    if not report.ok:
        raise RuntimeError(f"{kind} co-located tenants failed: "
                           f"{report.errors}")
    peak = torch.cuda.max_memory_allocated()
    physical = torch.cuda.mem_get_info()[1]
    log_text = sched.text()
    for t in tenants:
        res = report.results[t.name]
        if not res.passed:
            raise AssertionError(f"{t.name} checksum not finite")
        if res.checksum != solo_res.checksum:
            raise AssertionError(
                f"{t.name} checksum {res.checksum!r} != solo "
                f"{solo_res.checksum!r}")
        if f"LOCK_OK -> {t.name} " not in log_text:
            raise AssertionError(f"scheduler never granted {t.name}")
        if drops[t.name] < 2:
            raise AssertionError(f"{t.name} was dropped {drops[t.name]} "
                                 "times, not at least twice")
        if stats[t.name]["handoff_evicts"] <= 0 or \
                stats[t.name]["prefetches"] <= 0:
            raise AssertionError(f"{t.name} paging counters {stats[t.name]}")
    n_drop = len(re.findall(rf"DROP_LOCK -> {kind}-t[12] ", log_text))
    if n_drop < 2:
        raise AssertionError(f"scheduler log shows {n_drop} DROP_LOCKs")
    if peak > physical:
        raise AssertionError(f"peak allocated {peak} > physical {physical}")
    h_sum = sum(s for s, _ in handoff.values())
    h_n = sum(n for _, n in handoff.values())
    ratio = report.makespan_s / (2.0 * solo_wall)
    log(f"[{kind}] solo wall {solo_wall:.2f} s, co-located makespan "
        f"{report.makespan_s:.2f} s -> makespan/(2 x solo) {ratio:.4f}; "
        f"handoffs {h_n} mean {h_sum / max(h_n, 1):.3f} s; scheduler "
        f"DROP_LOCKs {n_drop}; drops per tenant {drops}; peak allocated "
        f"{peak / GiB:.2f} GiB of {physical / GiB:.2f} GiB; checksum "
        f"{solo_res.checksum!r} (solo = both tenants)")
    return {"kind": kind, "steps": steps, "tq_s": tq, "solo_s": solo_wall,
            "makespan_s": report.makespan_s, "ratio": ratio,
            "handoffs": h_n, "handoff_mean_s": h_sum / max(h_n, 1),
            "drops": drops, "peak_bytes": peak, "stats": stats,
            "wss_bytes": chunks * CHUNK_BYTES}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    phases = Phases()
    card = card_line()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; card: {card}; host MemTotal "
        f"{meminfo('MemTotal') / GiB:.2f} GiB, MemAvailable "
        f"{mem_available() / GiB:.2f} GiB, Shmem "
        f"{meminfo('Shmem') / GiB:.2f} GiB")

    phases.run("build", build_all)
    gen = torch.Generator(device="cuda").manual_seed(0)
    mix_entry = phases.run("check fused_mix", check_mix, gen)
    mm_entry = phases.run("check tiled_matmul", check_matmul, gen)

    os.environ["TPUSHARE_REQUIRE_SCHEDULER"] = "1"
    os.environ["TPUSHARE_PALLAS_MATMUL"] = "1"
    log(f"pinned host allocator: a 3 MiB request holds "
        f"{pinned_rounding() / 2**20:.0f} MiB")
    probe = vmem.VirtualHBM(name="smoke-probe")
    budget, physical = probe.budget, probe.physical
    probe.close()
    chunks = size_working_set(budget, physical)
    tmp = tempfile.mkdtemp(prefix="tpushare-smoke-")
    os.environ["TPUSHARE_SOCK_DIR"] = tmp
    sched = Scheduler(tmp, tq=30)
    results = {}
    try:
        # bench.py's retarget: TQ >= 3x one measured handoff cycle.
        cycle_s = phases.run("handoff cycle", measure_handoff_cycle, chunks,
                             budget)
        tq = max(2, math.ceil(3.0 * cycle_s))
        sched.set_tq(tq)
        log(f"handoff cycle {cycle_s:.3f} s ({chunks * CHUNK_BYTES / GiB:.2f}"
            f" GiB out and back) -> TQ {tq} s")
        # Step times: the kernels' share from this run's kernel timings,
        # the whole step from a short calibration run.
        mm_step = phases.run("calibrate matmul", calibrate_step, "matmul",
                             chunks, budget,
                             chunks * mm_entry["ms"] / 1e3 / DEVICE_RATIO)
        add_step = phases.run("calibrate add", calibrate_step, "add",
                              chunks, budget,
                              chunks * mix_entry["ms"] / 1e3 / DEVICE_RATIO)
        tiled_matmul.launches.reset()
        results["matmul"] = phases.run("main path matmul", run_kind,
                                       "matmul", chunks, budget, sched,
                                       mm_step, tq)
        mm_launches = tiled_matmul.launches.value
        fused_mix.launches.reset()
        results["add"] = phases.run("main path add", run_kind, "add",
                                    chunks, budget, sched, add_step, tq)
        mix_launches = fused_mix.launches.value
    finally:
        sched.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    if mm_launches == 0 or mix_launches == 0:
        raise AssertionError(f"kernel launches on the main path: matmul "
                             f"{mm_launches}, mix {mix_launches}")
    log(f"main-path launches: tiled_matmul {mm_launches}, fused_mix "
        f"{mix_launches}")
    log("phase seconds: " + json.dumps(phases.seconds))
    log("measurements: " + json.dumps({
        "card": card,
        "ratio_matmul": results["matmul"]["ratio"],
        "ratio_add": results["add"]["ratio"],
        "handoff_cycle_s": cycle_s, "tq_s": tq,
        "handoff_mean_s": {k: r["handoff_mean_s"] for k, r in results.items()},
        "peak_allocated_gib": {k: r["peak_bytes"] / GiB
                               for k, r in results.items()},
        "step_s": {"matmul": mm_step, "add": add_step},
        "wss_gib": chunks * CHUNK_BYTES / GiB,
        "pinned_peak_gib": pinned_bytes("peak") / GiB,
        "budget_gib": budget / GiB}))
    kernels = [
        dict(name="fused_mix", route="cuda",
             source="nvshare_tpu_torch/csrc/mix.cu",
             replaces="nvshare_tpu/ops/mix.py:42", launches=mix_launches,
             **mix_entry),
        dict(name="tiled_matmul", route="cuda",
             source="nvshare_tpu_torch/csrc/matmul.cu",
             replaces="nvshare_tpu/ops/matmul.py:58", launches=mm_launches,
             **mm_entry),
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
