#!/usr/bin/env python3
"""Drive nvshare_tpu_torch end to end on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and
``make``/``g++``; exits non-zero without printing a result otherwise.

Phases (each one's seconds are printed; any failure exits non-zero):

1. Environment: PyTorch and CUDA versions, the card's name and power
   limit, host ``MemAvailable``.
2. Build, all at once: the three CUDA kernels (one ``nvcc`` per source in
   ``nvshare_tpu_torch/csrc/``) and ``tpushare-scheduler``/``tpusharectl``
   from ``src/`` into ``build/sched/``.
3. Kernel checks on the card against the plain PyTorch versions:
   ``fused_mix`` bit-exact in f32 and bf16 at one full burner chunk
   (8192x8192) and at 16384x16384; ``tiled_matmul`` within rtol 1e-4, atol 1e-4*max|want| at
   256x384 @ 384x128, 4096^3 and one full chunk (TF32 off for the plain
   version); the flash-attention forward (K3), ``out`` and ``lse``, at
   the LM's scoring shape [4, 2048, 32, 128] in bf16 and f32, causal and
   full, at [2, 256, 2, 64] and cross-length 128 x 256 (out within the
   dtype's tolerance, 2e-5 in f32 and 2e-2 in bf16; lse within 2e-5).
   Times from CUDA events; ``torch.matmul`` in bf16 and
   ``scaled_dot_product_attention`` are timed as the library yardsticks.
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
5. The language model at GPT-3 6.7B widths (``LM`` below): a full-width
   inference check (K3 against its plain version in every layer of the
   scoring forward; the logits against the plain-attention forward;
   teacher-forced decoding against the forward), the pair's sizing, one
   tenant's request time and handoff cycle (which set the quantum and
   the number of requests), then a solo tenant and two co-located
   tenants serving requests: score [4, 2048] tokens, decode 32 greedy
   tokens at batch 16 against the donated KV cache. Every co-located
   scoring checksum and decoded token must equal the solo run's, both
   tenants must be dropped at least twice and evict and prefetch, and K3
   must have launched 32 times a request.
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
    lm_workload,
    run_colocated,
)
from nvshare_tpu_torch.models.burner import AddBurner, MatmulBurner  # noqa: E402
from nvshare_tpu_torch.models.decode import (  # noqa: E402
    decode_step,
    init_kv_cache,
)
from nvshare_tpu_torch.models.transformer import (  # noqa: E402
    Transformer,
    local_attn,
    synthetic_tokens,
    transformer_forward,
)
from nvshare_tpu_torch.ops import _build  # noqa: E402
from nvshare_tpu_torch.ops import (  # noqa: E402
    flash_attention,
    flash_attention_lse,
    flash_attention_reference,
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

# The language model at the published widths of GPT-3 6.7B (Brown et al.
# 2020, Table 2.1: 32 layers, d_model 4096, 32 heads of 128, n_ctx 2048;
# the GPT-2 BPE vocabulary of 50257), in the repo's Transformer: RMSNorm,
# RoPE, no biases, every layer dense. Random weights from LM_SEED.
LM = Transformer(vocab=50257, dim=4096, heads=32, depth=32, seq=2048,
                 rope=True)
LM_SEED = 0
SCORE_BATCH = 4          # sequences of LM.seq tokens scored per request
DECODE_BATCH = 16        # streams decoded against the KV cache
DECODE_TOKENS = 32       # greedy tokens per request
CHECK_DECODE = 64        # teacher-forced positions in the inference check


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


def check_attention(gen) -> dict:
    """flash_attention_lse against its plain version, ``out`` and ``lse``.
    Tolerances: the dtype's for ``out`` (f32 rtol = atol = 2e-5, bf16
    2e-2, as the JAX kernel tests hold it); the f32 one for ``lse``, which
    is f32 whatever the inputs. The main path's shape (the scoring
    forward's, bf16, causal) is timed against the plain version and
    PyTorch's ``scaled_dot_product_attention``, the library yardstick."""
    import torch.nn.functional as F

    entry = None
    # (batch, sq, sk, heads, d, dtype, causal); the first is the main path.
    main = (SCORE_BATCH, LM.seq, LM.seq, LM.heads, LM.head_dim,
            torch.bfloat16, True)
    cases = [main, main[:6] + (False,)]
    cases += [(SCORE_BATCH, LM.seq, LM.seq, LM.heads, LM.head_dim,
               torch.float32, c) for c in (True, False)]
    cases += [(2, 256, 256, 2, 64, dt, c)
              for dt in (torch.float32, torch.bfloat16) for c in (True,
                                                                  False)]
    cases += [(2, 128, 256, 2, 64, torch.float32, c) for c in (True, False)]
    for b, sq, sk, h, d, dtype, causal in cases:
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                   .mul_(0.5).to(dtype) for s in (sq, sk, sk))
        got, got_lse = flash_attention_lse(q, k, v, causal=causal)
        want, want_lse = flash_attention_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        err = (got.float() - want.float()).abs().max().item()
        lse_err = (got_lse - want_lse).abs().max().item()
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        torch.testing.assert_close(got_lse, want_lse, rtol=2e-5, atol=2e-5)
        del got, got_lse, want, want_lse
        ms = cuda_ms(lambda: flash_attention_lse(q, k, v, causal=causal), 10)
        plain_ms = cuda_ms(
            lambda: flash_attention_reference(q, k, v, causal=causal), 3)
        flops = 4.0 * b * h * sq * sk * d / (2.0 if causal else 1.0)
        nbytes = (2 * b * sq * h * d + 2 * b * sk * h * d) * q.element_size() \
            + b * h * sq * 4
        peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        ops_ms = flops / peak * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        line = (f"K3 flash_attention {str(dtype)[6:]} [{b},{sq},{h},{d}] "
                f"sk {sk} {'causal' if causal else 'full'}: max abs err out "
                f"{err:.3g}, lse {lse_err:.3g}; {ms:.3f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
                f"bound {bound_ms:.3f} ms")
        if (b, sq, sk, h, d, dtype, causal) == main:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), 10)
            line += f", scaled_dot_product_attention {lib_ms:.3f} ms"
            entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms,
                     "bound_by": "operations" if ops_ms >= bytes_ms
                     else "bytes",
                     "library_ms": lib_ms}
        log(line)
        del q, k, v
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


def pair_counters(tenants) -> tuple:
    """Paging counters, drops and handoff (sum, count) of each tenant."""
    stats = {t.name: t.telemetry_snapshot() for t in tenants}
    drops = {t.name: int(t.client._m["drops"].value) for t in tenants}
    handoff = {t.name: (t.arena._m_handoff_s.sum, t.arena._m_handoff_s.count)
               for t in tenants}
    return stats, drops, handoff


def check_pair(kind: str, names, stats: dict, drops: dict,
               log_text: str) -> int:
    """The scheduler granted and dropped both tenants (each at least
    twice), and both evicted and prefetched; returns the DROP_LOCKs."""
    for name in names:
        if f"LOCK_OK -> {name} " not in log_text:
            raise AssertionError(f"scheduler never granted {name}")
        if drops[name] < 2:
            raise AssertionError(f"{name} was dropped {drops[name]} "
                                 "times, not at least twice")
        if stats[name]["handoff_evicts"] <= 0 or \
                stats[name]["prefetches"] <= 0:
            raise AssertionError(f"{name} paging counters {stats[name]}")
    n_drop = len(re.findall(rf"DROP_LOCK -> {kind}-t[12] ", log_text))
    if n_drop < 2:
        raise AssertionError(f"scheduler log shows {n_drop} DROP_LOCKs")
    return n_drop


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
        stats, drops, handoff = pair_counters(tenants)
    finally:
        for t in tenants:
            t.close()
    if not report.ok:
        raise RuntimeError(f"{kind} co-located tenants failed: "
                           f"{report.errors}")
    peak = torch.cuda.max_memory_allocated()
    physical = torch.cuda.mem_get_info()[1]
    for t in tenants:
        res = report.results[t.name]
        if not res.passed:
            raise AssertionError(f"{t.name} checksum not finite")
        if res.checksum != solo_res.checksum:
            raise AssertionError(
                f"{t.name} checksum {res.checksum!r} != solo "
                f"{solo_res.checksum!r}")
    n_drop = check_pair(kind, [t.name for t in tenants], stats, drops,
                        sched.text())
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


# -- the language model ------------------------------------------------------

def release_host_cache() -> None:
    """Hand the blocks PyTorch's allocators keep cached (device blocks, and
    the pinned host blocks of the burners' shadows) back to the system,
    so the next phase sizes against what is really free."""
    torch.cuda.empty_cache()
    torch._C._host_emptyCache()


def settled_mem_available(timeout_s: float = 180.0) -> tuple:
    """(MemAvailable once it has stopped rising, seconds waited). Pinned
    blocks that PyTorch has freed return to the host's free memory over
    seconds, not at once, so a reading right after the burners release
    their shadows undercounts what the LM pair will find."""
    t0 = time.time()
    last = mem_available()
    still = 0
    while still < 3 and time.time() - t0 < timeout_s:
        time.sleep(1.0)
        now = mem_available()
        still = still + 1 if now - last < (128 << 20) else 0
        last = now
    return last, time.time() - t0


def size_lm_pair(physical: int) -> dict:
    """The LM pair's sizes against the rule the burners follow: both
    tenants' pinned shadows (each block rounded up to a power of two by
    PyTorch's pinned allocator) fit in MemAvailable less the headroom, and
    the two working sets together exceed the card's memory. Raises, at
    decode batch DECODE_BATCH, if either fails: the pair is not shrunk
    below oversubscription."""
    params = LM.init(device="meta").values()
    cache = init_kv_cache(LM, DECODE_BATCH, LM.seq, device="meta").values()
    sizes = [x.numel() * x.element_size() for x in (*params, *cache)]
    wss = sum(sizes)
    pinned = sum(1 << (n - 1).bit_length() for n in sizes)
    n_params = sum(x.numel() for x in params)
    first = mem_available()
    avail, waited = settled_mem_available()
    log(f"[lm] host MemAvailable {first / GiB:.2f} GiB after the release, "
        f"{avail / GiB:.2f} GiB once settled ({waited:.0f} s)")
    log(f"[lm] GPT-3 6.7B widths: {n_params / 1e9:.3f} B parameters; per "
        f"tenant {wss / GiB:.2f} GiB on the card (KV cache "
        f"{DECODE_BATCH}x{LM.seq}), {pinned / GiB:.2f} GiB of pinned "
        f"shadows; pair {2 * wss / GiB:.2f} GiB = {2 * wss / physical:.4f}x "
        f"the card's {physical / GiB:.2f} GiB, pinned {2 * pinned / GiB:.2f}"
        f" GiB against MemAvailable {avail / GiB:.2f} GiB less "
        f"{HOST_HEADROOM / GiB:.0f} GiB headroom, process RSS "
        f"{rss_bytes() / GiB:.2f} GiB")
    if 2 * pinned > avail - HOST_HEADROOM:
        raise RuntimeError(
            f"host memory cannot hold both LM tenants' pinned shadows "
            f"(2 x {pinned / GiB:.2f} GiB) at decode batch {DECODE_BATCH}: "
            f"MemAvailable {avail / GiB:.2f} GiB less "
            f"{HOST_HEADROOM / GiB:.0f} GiB headroom")
    if 2 * wss <= physical:
        raise RuntimeError(f"the LM pair ({2 * wss / GiB:.2f} GiB) fits in "
                           "the card; it must oversubscribe it")
    return {"params": n_params, "wss_bytes": wss, "pinned_bytes": pinned}


# Share of logits that may lie outside rtol = atol = 2e-2 (the JAX LM
# tests' tolerance) at full width and depth: the two paths compute in
# bf16, which re-rounds every layer's activations, so a difference in f32
# summation order inside one op spreads to more logits with each layer
# (PERF.md). The argmax must agree at more than 0.95 of the positions.
LOGITS_OUTSIDE = 0.05


def logits_agreement(got, want):
    """[max abs error, share of logits outside rtol = atol = 2e-2, norm-wise
    relative error, argmax agreement] of two logits tensors, in f64 (a vop
    function)."""
    diff = (got - want).abs()
    outside = (diff > 2e-2 + 2e-2 * want.abs()).double().mean()
    rel = diff.double().norm() / want.double().norm()
    agree = (got.argmax(-1) == want.argmax(-1)).double().mean()
    return torch.stack([diff.max().double(), outside, rel, agree])


def check_lm_inference(budget: int) -> dict:
    """At full width and depth, one tenant: in the forward with K3, each
    layer's K3 output and LSE against the plain version on the layer's
    own q, k and v (bf16: out within 2e-2, LSE within 2e-5); the logits
    against the same forward through the plain attention; teacher-forced
    decode_step logits for the first CHECK_DECODE positions against the
    K3 forward's (argmax agreement > 0.95, at most LOGITS_OUTSIDE of the
    logits outside 2e-2)."""
    out = {}
    layers = []  # per layer: [out max abs error, its excess over 2e-2,
    #                             LSE max abs error]

    def checked(q, k, v, causal):
        o, lse = flash_attention_lse(q, k, v, causal=causal)
        if q.device.type != "meta":  # vop's meta pass sizes outputs only
            ro, rlse = flash_attention_reference(q, k, v, causal=causal)
            diff = (o.float() - ro.float()).abs()
            layers.append(torch.stack([
                diff.max(), (diff - (2e-2 + 2e-2 * ro.float().abs())).max(),
                (lse - rlse).abs().max()]))
        return o

    def plain(q, k, v, causal):
        return flash_attention_reference(q, k, v, causal=causal)[0]

    def work(tenant: Tenant):
        a = tenant.arena
        params = vmem.vop(lambda dev: LM.init(LM_SEED, device=dev))(a.device)
        toks = synthetic_tokens(LM, SCORE_BATCH, LM_SEED)[:, :LM.seq]
        tokens = a.array(toks)
        forward = vmem.vop(transformer_forward, static_argnums=(1, 3))
        compare = vmem.vop(logits_agreement)
        flash_attention.launches.reset()
        t0 = time.perf_counter()
        logits = forward(params, LM, tokens, None)
        a.fence()
        out["forward_s"] = time.perf_counter() - t0
        out["launches"] = flash_attention.launches.value
        checked_logits = forward(params, LM, tokens, local_attn(LM, checked))
        out["layers"] = torch.stack(layers).cpu().tolist()
        out["same_logits"] = int(vmem.vop(lambda x, y: (x != y).sum())(
            logits, checked_logits).numpy()) == 0
        checked_logits.delete()
        t0 = time.perf_counter()
        ref = forward(params, LM, tokens, local_attn(LM, plain))
        a.fence()
        out["plain_forward_s"] = time.perf_counter() - t0
        out["forward"] = compare(logits, ref).numpy().tolist()
        ref.delete()
        cache = vmem.vop(lambda dev: init_kv_cache(
            LM, SCORE_BATCH, LM.seq, device=dev))(a.device)
        step = vmem.vop(decode_step, static_argnums=(1,),
                        donate_argnums=(2,))
        steps = []
        t0 = time.perf_counter()
        for pos in range(CHECK_DECODE):
            step_logits, cache = step(params, LM, cache, pos,
                                      a.array(toks[:, pos]))
            steps.append(step_logits)
        decoded = vmem.vop(lambda *ls: torch.stack(ls, dim=1))(*steps)
        a.fence()
        out["decode_token_s"] = (time.perf_counter() - t0) / CHECK_DECODE
        head = vmem.vop(lambda x: x[:, :CHECK_DECODE])(logits)
        out["decode"] = compare(decoded, head).numpy().tolist()
        for va in [*params.values(), *cache.values(), *steps, tokens,
                   logits, decoded, head]:
            va.delete()

    tenant = Tenant("lm-check", budget_bytes=budget,
                    pool=vmem.PhysicalPool(budget))
    try:
        tenant.run(work)
    finally:
        tenant.close()
    err = max(e for e, _, _ in out["layers"])
    worst = max(x for _, x, _ in out["layers"])
    lse_err = max(e for _, _, e in out["layers"])
    log(f"[lm] K3 in each of {len(out['layers'])} layers against the plain "
        f"version on the layer's q, k, v: out max abs err {err:.3g} "
        f"(rtol/atol 2e-2 {'holds' if worst <= 0 else 'FAILS'}), LSE max "
        f"abs err {lse_err:.3g}; checked forward "
        f"logits {'equal' if out['same_logits'] else 'DIFFER from'} the "
        "K3 forward's")
    for what in ("forward", "decode"):
        err, outside, rel, agree = out[what]
        log(f"[lm] {what} vs "
            f"{'plain-attention forward' if what == 'forward' else 'K3 forward'}"
            f": max abs err {err:.4g}, share outside rtol/atol 2e-2 "
            f"{outside:.4g}, norm-wise relative error {rel:.3g}, argmax "
            f"agreement {agree:.4f}")
    if worst > 0 or lse_err > 2e-5 or not out["same_logits"] \
            or len(out["layers"]) != LM.depth:
        raise AssertionError(f"K3 at the LM's layers: {out['layers']}")
    for what in ("forward", "decode"):
        _, outside, _, agree = out[what]
        if outside > LOGITS_OUTSIDE or agree <= 0.95:
            raise AssertionError(f"LM {what} check failed: {out[what]}")
    if out["launches"] != LM.depth:
        raise AssertionError(f"the forward launched K3 {out['launches']} "
                             f"times, not {LM.depth}")
    log(f"[lm] forward [{SCORE_BATCH},{LM.seq}] {out['forward_s']:.3f} s "
        f"(plain attention {out['plain_forward_s']:.3f} s), {LM.depth} K3 "
        f"launches; teacher-forced decode batch {SCORE_BATCH} "
        f"{out['decode_token_s'] * 1e3:.1f} ms/token")
    return out


def measure_lm(budget: int) -> dict:
    """One LM tenant's request time (the second of two requests) and one
    warm handoff cycle of its parameters and cache: generated on the card,
    evicted to pinned shadows and prefetched back through the arena's own
    DROP_LOCK/LOCK_OK hooks; the first, untimed cycle materializes the
    shadows. Both parts are dirty, so the cycle moves the whole set each
    way, more than a serving handoff (clean parameters are dropped, not
    written back): the quantum that follows is conservative."""
    out = {}

    def work(tenant: Tenant):
        res = lm_workload(LM, requests=2, score_batch=SCORE_BATCH,
                          decode_batch=DECODE_BATCH,
                          decode_tokens=DECODE_TOKENS, seed=LM_SEED)(tenant)
        out["request_s"] = res.score_s[-1] + res.decode_s[-1]
        a = tenant.arena
        with a._lock:
            a._busy_depth += 1  # the probe pages while it holds the lock
        try:
            for timed in (False, True):
                params = vmem.vop(lambda dev: LM.init(LM_SEED, device=dev))(
                    a.device)
                cache = vmem.vop(lambda dev: init_kv_cache(
                    LM, DECODE_BATCH, LM.seq, device=dev))(a.device)
                vas = [*params.values(), *cache.values()]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                a.sync_and_evict_all()
                a.prefetch_hot()
                torch.cuda.synchronize()
                if timed:
                    out["cycle_s"] = time.perf_counter() - t0
                if not all(va.resident for va in vas):
                    raise AssertionError("prefetch did not bring the set "
                                         "back")
                for va in vas:
                    va.delete()
        finally:
            with a._lock:
                a._busy_depth -= 1

    probe = Tenant("lm-probe", budget_bytes=budget,
                   pool=vmem.PhysicalPool(budget))
    try:
        probe.run(work)
    finally:
        probe.close()
    return out


def run_lm(budget: int, sched: Scheduler, requests: int, tq: int) -> dict:
    """The LM serving pair: a solo tenant, then two co-located tenants,
    each holding its parameters and KV cache in its own arena."""
    def workload():
        return lm_workload(LM, requests=requests, score_batch=SCORE_BATCH,
                           decode_batch=DECODE_BATCH,
                           decode_tokens=DECODE_TOKENS, seed=LM_SEED)

    log(f"[lm] {requests} requests per tenant, TQ {tq} s")
    torch.cuda.reset_peak_memory_stats()
    solo = Tenant("lm-solo", budget_bytes=budget,
                  pool=vmem.PhysicalPool(budget))
    try:
        t0 = time.time()
        solo_res = solo.run(workload())
        solo_wall = time.time() - t0
    finally:
        solo.close()
    if not solo_res.passed:
        raise AssertionError("lm solo checksums not finite")
    pool = vmem.PhysicalPool(budget)
    tenants = [Tenant(f"lm-t{i}", budget_bytes=budget, pool=pool)
               for i in (1, 2)]
    try:
        report = run_colocated({t: workload() for t in tenants},
                               timeout_s=900)
        stats, drops, handoff = pair_counters(tenants)
    finally:
        for t in tenants:
            t.close()
    if not report.ok:
        raise RuntimeError(f"lm co-located tenants failed: {report.errors}")
    peak = torch.cuda.max_memory_allocated()
    physical = torch.cuda.mem_get_info()[1]
    for t in tenants:
        res = report.results[t.name]
        if res.checksums != solo_res.checksums:
            raise AssertionError(f"{t.name} scoring checksums "
                                 f"{res.checksums} != solo "
                                 f"{solo_res.checksums}")
        if not (res.tokens == solo_res.tokens).all():
            raise AssertionError(f"{t.name} decoded other tokens than solo")
    n_drop = check_pair("lm", [t.name for t in tenants], stats, drops,
                        sched.text())
    if peak > physical:
        raise AssertionError(f"peak allocated {peak} > physical {physical}")
    h_sum = sum(s for s, _ in handoff.values())
    h_n = sum(n for _, n in handoff.values())
    ratio = report.makespan_s / (2.0 * solo_wall)
    request_s = statistics.mean(
        a + b for a, b in zip(solo_res.score_s, solo_res.decode_s))
    token_ms = statistics.mean(solo_res.decode_s) / DECODE_TOKENS * 1e3
    score_s = statistics.mean(solo_res.score_s)
    log(f"[lm] solo wall {solo_wall:.2f} s, co-located makespan "
        f"{report.makespan_s:.2f} s -> makespan/(2 x solo) {ratio:.4f}; "
        f"solo request {request_s:.3f} s (scoring {score_s:.3f} s, decode "
        f"{token_ms:.2f} ms/token at batch {DECODE_BATCH}); handoffs {h_n} "
        f"mean {h_sum / max(h_n, 1):.3f} s; scheduler DROP_LOCKs {n_drop}; "
        f"drops per tenant {drops}; peak allocated {peak / GiB:.2f} GiB of "
        f"{physical / GiB:.2f} GiB; scoring checksums and "
        f"{solo_res.tokens.size} decoded tokens equal solo in both tenants "
        f"(first checksum {solo_res.checksums[0]!r})")
    return {"requests": requests, "tq_s": tq, "solo_s": solo_wall,
            "makespan_s": report.makespan_s, "ratio": ratio,
            "request_s": request_s, "score_s": score_s,
            "decode_token_ms": token_ms, "handoffs": h_n,
            "handoff_mean_s": h_sum / max(h_n, 1), "drops": drops,
            "peak_bytes": peak, "stats": stats}


def lm_phases(phases: Phases, budget: int, physical: int,
              sched: Scheduler) -> dict:
    """The LM's phases: the full-width inference check, the pair's sizing,
    the request time and handoff cycle that set the quantum and the number
    of requests, then the main path with K3's launches counted."""
    release_host_cache()
    check = phases.run("check lm inference", check_lm_inference, budget)
    release_host_cache()
    sizes = size_lm_pair(physical)
    probe = phases.run("lm handoff cycle", measure_lm, budget)
    tq = max(2, math.ceil(3.0 * probe["cycle_s"]))
    sched.set_tq(tq)
    # Each tenant's device work spans >= 3 quanta (dropped at least
    # twice), within one session of LM.seq cached positions.
    requests = min(LM.seq // DECODE_TOKENS,
                   max(3, math.ceil(3.0 * tq / probe["request_s"]) + 2))
    log(f"[lm] handoff cycle {probe['cycle_s']:.3f} s "
        f"({sizes['wss_bytes'] / GiB:.2f} GiB out and back) -> TQ {tq} s; "
        f"request {probe['request_s']:.3f} s -> {requests} requests")
    flash_attention.launches.reset()
    res = phases.run("main path lm", run_lm, budget, sched, requests, tq)
    launches = flash_attention.launches.value
    want = LM.depth * 3 * requests  # solo + two co-located tenants
    if launches != want:
        raise AssertionError(f"K3 launched {launches} times on the LM main "
                             f"path, not {LM.depth} x {3 * requests}")
    res.update(launches=launches, cycle_s=probe["cycle_s"], check=check,
               **sizes)
    return res


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
    att_entry = phases.run("check flash_attention", check_attention, gen)

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
        lm = lm_phases(phases, budget, physical, sched)
    finally:
        sched.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    if mm_launches == 0 or mix_launches == 0:
        raise AssertionError(f"kernel launches on the main path: matmul "
                             f"{mm_launches}, mix {mix_launches}")
    log(f"main-path launches: tiled_matmul {mm_launches}, fused_mix "
        f"{mix_launches}, flash_attention {lm['launches']}")
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
        "budget_gib": budget / GiB,
        "lm": {k: lm[k] for k in (
            "requests", "tq_s", "cycle_s", "solo_s", "makespan_s", "ratio",
            "request_s", "score_s", "decode_token_ms", "handoffs",
            "handoff_mean_s", "drops", "wss_bytes", "pinned_bytes")},
        "lm_peak_allocated_gib": lm["peak_bytes"] / GiB,
        "lm_check": lm["check"]}))
    kernels = [
        dict(name="fused_mix", route="cuda",
             source="nvshare_tpu_torch/csrc/mix.cu",
             replaces="nvshare_tpu/ops/mix.py:42", launches=mix_launches,
             **mix_entry),
        dict(name="tiled_matmul", route="cuda",
             source="nvshare_tpu_torch/csrc/matmul.cu",
             replaces="nvshare_tpu/ops/matmul.py:58", launches=mm_launches,
             **mm_entry),
        dict(name="flash_attention", route="cuda",
             source="nvshare_tpu_torch/csrc/attention.cu",
             replaces="nvshare_tpu/ops/attention.py:120",
             launches=lm["launches"], **att_entry),
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
