#!/usr/bin/env python3
"""Drive nvshare_tpu_torch end to end on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and
``make``/``g++``; exits non-zero without printing a result otherwise.

Phases (each one's seconds are printed, and the script's total at the
end; any failure exits non-zero):

1. Environment: PyTorch and CUDA versions, the card's name and power
   limit, host ``MemAvailable``.
2. Build, all at once: the CUDA kernels (one ``nvcc`` per source in
   ``nvshare_tpu_torch/csrc/``) and ``tpushare-scheduler``/``tpusharectl``
   from ``src/`` into ``build/sched/``.
3. Kernel checks on the card against the plain PyTorch versions:
   ``fused_mix`` bit-exact in f32 and bf16 at one full burner chunk
   (8192x8192) and at 16384x16384; ``tiled_matmul`` within rtol 1e-4,
   atol 1e-4*max|want| (TF32 off for the plain version) at 256x384 @
   384x128, 4096^3 and one full chunk in f32, at 4096^3 in bf16 (its
   output the f32 product rounded to nearest even, bit for bit) and f32
   @ bf16 at 384x256 @ 256x640; the flash-attention forward (K3), ``out``
   and ``lse``, at the LM's scoring shape [4, 2048, 32, 128] in bf16 and
   f32, causal and full, at [2, 256, 2, 64] and cross-length 128 x 256
   both ways (out
   within the dtype's tolerance, 2e-5 in f32 and 2e-2 in bf16, and each
   64-row tile's norm-wise relative error within ``K3_TILE_REL``; lse
   within 2e-5). The flash-attention backward kernels, K4 (dQ) and K5
   (dK/dV), against their plain versions at the training shape in bf16
   and f32, causal and full, at [2, 256, 2, 64], cross-length 128 x 256
   both ways, and with a nonzero LSE cotangent (entry by entry 2e-4 in
   f32 and 5e-2 in bf16, and tile by tile within ``BWD_TILE_REL``). At
   the main shapes a zeroed output and one with tiles skipped must fail
   the tile checks. Each case names the route it took
   (``kernel_route``): bf16 K3, K4 and K5 at d 64 and 128 run the wgmma
   + TMA kernels; f32, and bf16 at other widths (cases at d 36 and 96,
   [2, 256, 2, d]), run the ``tf32x3`` route, whose K3, K4 and K5
   compute on the tensor cores by the 3xTF32 split.
   Times from CUDA events; ``torch.matmul`` in
   bf16 (with and without the casts of f32 operands),
   ``scaled_dot_product_attention`` and its backward are timed as the
   library yardsticks.
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
5. The handoff A/B of the proactive pager at the burner pair's working
   set and quantum: the same pair of ``ab_workload`` tenants (every chunk
   dirtied once, then one chunk a step re-dirtied by a donated in-place
   ``x * 1.0001``, 30 ms of host time a step) with synchronous handoffs,
   with ``use_pager=True``, and with ``TPUSHARE_PAGER_FIRST_TOUCH=1`` too
   (pager knobs: PAGER_ENV, printed). Per leg: handoffs, their median
   and p99 seconds, bytes moved at handoffs, the clean share, bytes
   trickled and their rate, makespan / (2 x solo). Every leg's results
   must equal the solo run's bit for bit.
6. The language model at GPT-3 6.7B widths (``LM`` below): a full-width
   inference check (K3 against its plain version in every layer of the
   scoring forward; the logits against the plain-attention forward;
   teacher-forced decoding against the forward), the pair's sizing, one
   tenant's request time and handoff cycle (which set the quantum and
   the number of requests), then a solo tenant and two co-located
   tenants serving requests: score [4, 2048] tokens, decode 32 greedy
   tokens at batch 16 against the donated KV cache. Every co-located
   scoring checksum and decoded token must equal the solo run's, both
   tenants must be dropped at least twice and evict and prefetch, and K3
   must have launched 32 times a request, every time by the wgmma
   route. Then the same pair again with the proactive pager: every
   checksum and token must equal the solo run's, and its handoffs are
   printed beside the synchronous pair's.
7. The serving phases: a ``decode_workload`` tenant at the LM's cache
   widths (d_model 4096, 2048 positions, batch 16; the cache tagged
   "kv") that also holds untagged chunks its budget cannot keep beside
   the cache, and a ``prefill_workload`` tenant (activations tagged
   "act"), each alone, then as a pair with the pager and the wss policy.
   Both checksums must equal solo; decoding must evict under pressure
   and never a KV-tagged array; every "act" array resident at a prefill
   handoff must leave the hot set. The decode gate wait's p50/p99 is
   printed.
8. LM training at the same widths, 24 of 32 layers, every block
   recomputed in the backward (``TRAIN`` below): a full-width check of
   one step (K4 and K5 against the plain backward on every layer's own
   q, k, v and dO, tile by tile within 1e-2; the
   loss and every gradient against the step through the plain
   attention; the launches; the step's peak device memory, which sets
   the pair's budget; ``_matmul_f32``'s backward against exact f32
   products), the pair's sizing, one tenant's step time and handoff
   cycle (which set the quantum and the number of steps), then a solo
   tenant and two co-located tenants training from the same seed. Every
   co-located loss and the final checksum of parameters and momentum
   must equal the solo run's, both tenants must be dropped at least
   twice, and K3, K4 and K5 must have launched 2 x 24, 24 and 24 times a
   step, every time by the wgmma route.
9. The QoS pair: an LM server (``interactive:2``, the LM pair's budget
   and its first QOS_REQUESTS requests) beside an LM trainer
   (``batch:1``, the training pair's budget and step count), both at
   the widths above, in one
   process under two private schedulers in turn, the first with
   ``TPUSHARE_QOS_POLICY=fifo`` and the second with ``wfq``, at the LM
   pair's quantum, with the fleet plane on (``TPUSHARE_FLEET=1``,
   ``TPUSHARE_RELEASE_CHECK_S=30``). Every scoring checksum, decoded
   token, loss and the final state sum must equal the earlier solo
   runs; the live policy (``fetch_sched_stats``) must be the one asked
   for; the fleet trace merged from the scheduler's replay must hold
   both tenants' lock spans. Per leg: QoS preemptions, achieved against
   entitled occupancy (the scheduler's ``occ_pm`` and
   ``qos.report.build_report`` on the merged trace), each class's gate
   wait p50/p99, the handoffs' writeback, wire and page-in medians
   (``fleet.handoff_summaries``) and makespan against the solos. In the
   WFQ leg the exporter (``TPUSHARE_METRICS_PORT=0``) is scraped once
   and must carry both tenants' ``tpushare_lock_*`` series, and ``top
   --once --plain`` runs once.
10. The oversubscribing process pair: ``python -m
   nvshare_tpu_torch.bench_tenant`` as two processes whose working sets
   together exceed the card (PROC_WSS_FRACTION of it each, cut only by
   host memory; a pair of no more than 1.0x fails): ``nat`` the matmul
   burner (K2) through the native client built from ``src/`` (it must
   report ``NativeClient``), ``cha`` the add burner (K1) through the
   Python client over ``TPUSHARE_CHAOS=drop:0.04,seed:11`` (its link must
   drop a frame); first a solo process of each, then both at once under
   a private scheduler. Both checksums must equal their solo's, each
   must be handed off at least twice, each handoff must release the
   process arena's freed blocks to the card (the process keeps at most
   RELEASE_FLOOR reserved after one, printed), and each one's metrics
   textfile (``TPUSHARE_METRICS_TEXTFILE``) must carry its
   ``tpushare_lock_*`` series. ``python3 chip_smoke.py --pre-repair``
   builds and runs only this pair with the release taken out of the
   tenants, and must show the device OOM it prevents.
11. The unmodified pair: ``python -m nvshare_tpu_torch.workloads.lm_train``
   (GPT-3 6.7B widths, UNMOD_LAYERS of 32 layers) and ``...mlp_train``
   (the MLP through the prefetching input pipeline), each made a tenant
   only by ``import nvshare_tpu_torch.autoload``: each alone (the MLP
   also restored from its midpoint checkpoint and run on; the LM once
   more with ``TPUSHARE_DISABLE=1``, the gate's host cost), then both at
   once at a quantum of at least 3x the measured handoff. Every loss and
   state sum must equal solo bit for bit, both tenants must be granted
   and dropped at least twice, and K3, K4 and K5 must have launched 2 x
   layers, layers and layers times a step by the wgmma route, every
   launch gated. Each child's whole output is kept under
   ``build/logs/``.
12. Parallel ranks (``nvshare_tpu_torch/parallel``): N processes on the
   one card through ``parallel/dryrun.py``'s spawn, under gloo (NCCL
   refuses two ranks on one device), every collective staged through
   pinned host buffers. World 2: ring and Ulysses attention at the LM's
   scoring shape in bf16, causal and full, the output and the q, k, v
   gradients held tile by tile against ``reference_attention`` in f32;
   the sequence-parallel LM step (ring and Ulysses, PAR_LM, two steps)
   and the sequence + expert parallel MoE LM step (PAR_MOE_LM, one); the
   expert-parallel MoE FFN against the per-shard reference; the
   pipeline step with transformer stages against the sequential blocks'
   gradients. World 1, in this process: the same LM steps, ``lm_train_step``,
   ``moe_lm_train_step`` and the MLP's ``train_step``, which the world-2
   losses and state sums (and the world-4 dp x tp MLP on a 2 x 2 grid)
   are held to, by the tolerances stated at PAR_*. The ring's K3-K5
   launches must take the 3xTF32 route, Ulysses' and the pipeline's
   the wgmma route. The same two ranks then run the ring with each a tenant of one
   private scheduler (``TPUSHARE_FORCE_MULTIHOST=1``, TQ PAR_GATE_TQ):
   its bits must equal the ungated ring's; if it deadlocks, the
   scheduler's log is kept and the guard's default refusal shown. Each
   rank's backend, collectives (bytes and seconds staged), peak device
   memory and seconds are printed. Phase 3 also holds K3, K4 and K5's
   f32 route at the ring's block shapes against their plain versions (on
   the tensor cores, each twice, bit for bit, with the zeroed and
   tile-skipping controls and NaN rows) and times it beside
   ``scaled_dot_product_attention`` in f32.
They run in this order but for 7, which runs before 6, 11, which runs
before 9, and 12, which runs between 9 and 10: the host takes the
pinned shadows a pair freed back over seconds, and the next pair sizes
itself only once it has.
The last lines are the card's name and power limit, one JSON line of
kernel measurements, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import replace
from pathlib import Path
from unittest import mock

STARTED = time.perf_counter()  # the script's total counts the imports

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from nvshare_tpu_torch import telemetry, vmem  # noqa: E402
from nvshare_tpu_torch.colocate import (  # noqa: E402
    Tenant,
    burner_workload,
    lm_train_workload,
    lm_workload,
    run_colocated,
)
from nvshare_tpu_torch.models.burner import AddBurner, MatmulBurner  # noqa: E402
from nvshare_tpu_torch.models.mlp import MLP  # noqa: E402
from nvshare_tpu_torch.parallel import dryrun  # noqa: E402
# tile_rel_err: the tile-wise norm check every attention check uses.
from nvshare_tpu_torch.parallel.dryrun import (  # noqa: E402
    TILE_ROWS,
    tile_rel_err,
)
from nvshare_tpu_torch.models.serving import (  # noqa: E402
    decode_workload,
    gate_wait_samples,
    percentile,
    prefill_workload,
)
from nvshare_tpu_torch.telemetry import events as tev  # noqa: E402
from nvshare_tpu_torch.models.decode import (  # noqa: E402
    decode_step,
    init_kv_cache,
)
from nvshare_tpu_torch.models.transformer import (  # noqa: E402
    Transformer,
    _matmul_f32,
    init_lm_state,
    lm_loss_and_grads,
    local_attn,
    synthetic_tokens,
    transformer_forward,
)
from nvshare_tpu_torch.ops import _build  # noqa: E402
from nvshare_tpu_torch.ops.attention import (  # noqa: E402
    TF32X3,
    WGMMA,
    kernel_route,
)
from nvshare_tpu_torch.ops import (  # noqa: E402
    attention_delta,
    flash_attention,
    flash_attention_lse,
    flash_attention_reference,
    flash_backward_dkv,
    flash_backward_dkv_reference,
    flash_backward_dq,
    flash_backward_dq_reference,
    flash_backward_reference,
    fused_mix,
    fused_mix_reference,
    matmul_kernel,
    tiled_matmul,
    tiled_matmul_reference,
    to_bf16,
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
# TF32 on the tensor cores, dense: the 3xTF32 split of the f32 route's K3
# and K5 runs three such products a f32 product (165 TFLOP/s of f32).
TF32_FLOPS = 495e12

SCHED_DIR = REPO / "build" / "sched"
# Whole logs of the child processes (the tenants' own output).
CHILD_LOGS = REPO / "build" / "logs"

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

# The training pair: the same widths with every block recomputed in the
# backward, cut to 24 of 32 layers because host memory must hold both
# tenants' pinned shadows of f32 parameters and momentum (PERF.md).
TRAIN = Transformer(vocab=50257, dim=4096, heads=32, depth=24, seq=2048,
                    rope=True, remat=True)
TRAIN_BATCH = 4          # sequences of TRAIN.seq tokens a step
TRAIN_LR = 1e-2          # lm_train_step's default
TRAIN_SEED = 0

# The proactive pager's rate knobs for every pager tenant here: the
# reference's defaults (20 ms ticks, 2 writeback streams) but one burner
# chunk per tick and stream instead of 32 MiB, so the trickle and the
# first-touch streams (2 x 256 MiB / 20 ms of tokens) can fill the card's
# PCIe link rather than a sixth of it. Printed where used.
PAGER_ENV = {"TPUSHARE_WRITEBACK_CHUNK_BYTES": str(CHUNK_BYTES),
             "TPUSHARE_WRITEBACK_INTERVAL_S": "0.02",
             "TPUSHARE_WRITEBACK_STREAMS": "2"}
AB_SLEEP_S = 0.03        # the reference A/B's host time between steps
AB_QUANTA = 1.2          # quanta of work each A/B tenant brings (and at
                         # least one step a chunk): above 1, so that each
                         # leg hands off twice
# Quanta of device work a tenant of the burner, LM and training pairs
# brings (plus two steps, or one of the LM's requests): above 2, so that
# with both tenants waiting on each other each is dropped at least twice.
PAIR_QUANTA = 2.2
# The serving phases: the mock decoder at the LM's cache widths. 320
# tokens and 8 prefill bursts keep each tenant busy for several quanta of
# SERVE_TQ (16 s and 7 s alone on the H100), so that both are handed off
# at least twice in the pair.
SERVE = dict(layers=2, batch=DECODE_BATCH, max_len=2048, d_model=4096)
SERVE_TOKENS = 320
SERVE_REQUESTS = 4
SERVE_THINK_S = 0.01     # inter-token host work of the decode tenant
# Prefill bursts of 2048 x 2048 activations, long enough on the card that
# a handoff almost always finds one resident (a burst's host-side draw of
# its input is a few percent of it).
PREFILL = dict(bursts=8, seq=2048, steps_per_burst=2048, gap_s=0.0)
SERVE_COLD_CHUNKS = 4    # untagged arrays the decode tenant holds
SERVE_TQ = 2


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
               str(SCHED_DIR / "tpusharectl"),
               str(SCHED_DIR / "libtpushare_client.so")]
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
    log(f"built scheduler, ctl and client library: {make_s:.1f} s")
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
    """tiled_matmul against its plain version (TF32 off). The wrapper
    rounds its operands to bf16 and launches K2 (``matmul_kernel``) on
    them, which writes a's type from f32 accumulators. Each case must
    launch K2 once. Its f32 output (the wrapper's, or for bf16 a the
    kernel's own f32 output on the same operands) is held to rtol 1e-4
    and atol 1e-4 * max|want|; a bf16 output must be those f32 values
    rounded to nearest even, bit for bit. Cases: f32 operands at 256x384
    @ 384x128 (a tile column half past N), 4096^3 and one full chunk (the
    main path's, last); bf16 operands at 4096^3; f32 a with bf16 b at
    384x256 @ 256x640. Timed: the kernel alone on the bf16 operands
    against ``torch.matmul`` in bf16, and the wrapper with its casts
    against ``torch.matmul(a.bfloat16(), b.bfloat16())``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    entry = None
    f32, bf16 = torch.float32, torch.bfloat16
    cases = ((256, 384, 128, f32, f32), (4096, 4096, 4096, f32, f32),
             (4096, 4096, 4096, bf16, bf16), (384, 256, 640, f32, bf16),
             (CHUNK_SIDE, CHUNK_SIDE, CHUNK_SIDE, f32, f32))
    for m, k, n, a_dtype, b_dtype in cases:
        a = torch.rand((m, k), generator=gen, device="cuda").to(a_dtype)
        b = torch.rand((k, n), generator=gen, device="cuda").to(b_dtype)
        a16, b16 = to_bf16(a), to_bf16(b)
        before = tiled_matmul.launches.value
        got = tiled_matmul(a, b)
        launched = tiled_matmul.launches.value - before
        acc = got if a_dtype == f32 else matmul_kernel(a16, b16, f32)
        want = tiled_matmul_reference(a16.float(), b16)
        torch.cuda.synchronize()
        max_want = want.abs().max().item()
        err = (acc - want).abs().max().item()
        torch.testing.assert_close(acc, want, rtol=1e-4,
                                   atol=1e-4 * max_want)
        if launched != 1 or not torch.equal(got, acc.to(a_dtype)):
            raise AssertionError(
                f"K2 {m}x{k} @ {k}x{n}: {launched} launches; the {a_dtype} "
                "output is not the f32 product rounded to nearest even")
        del got, acc, want
        reps = 10
        ms = cuda_ms(lambda: matmul_kernel(a16, b16, a_dtype), reps)
        wrapper_ms = cuda_ms(lambda: tiled_matmul(a, b), reps)
        plain_ms = cuda_ms(lambda: tiled_matmul_reference(a, b), reps)
        lib_ms = cuda_ms(lambda: torch.matmul(a16, b16), reps)
        lib_cast_ms = cuda_ms(
            lambda: torch.matmul(a.to(bf16), b.to(bf16)), reps)
        flops = 2.0 * m * n * k
        # The kernel's own work: bf16 operands in, a's type out.
        nbytes = (m * k + k * n) * 2 + m * n * a.element_size()
        ops_ms = flops / BF16_FLOPS * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        log(f"K2 tiled_matmul {str(a_dtype)[6:]} @ {str(b_dtype)[6:]} {m}x{k}"
            f" @ {k}x{n}: max abs err {err:.4g} (max|want| {max_want:.4g}); "
            f"kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), wrapper "
            f"with casts {wrapper_ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"torch.matmul bf16 {lib_ms:.3f} ms "
            f"({flops / lib_ms / 1e9:.1f} TFLOP/s), with casts "
            f"{lib_cast_ms:.3f} ms, bound {bound_ms:.3f} ms")
        if m == CHUNK_SIDE:
            entry = {"design": "wgmma+tma", "max_abs_err": err, "ms": ms,
                     "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms,
                     "bound_by": "operations" if ops_ms >= bytes_ms
                     else "bytes",
                     "library_ms": lib_ms, "library_cast_ms": lib_cast_ms}
        del a, b, a16, b16
    torch.cuda.empty_cache()
    return entry


def reset_counts(*wrappers) -> None:
    """Zero each kernel wrapper's launch count and its per-route counts."""
    for fn in wrappers:
        fn.launches.reset()
        for count in getattr(fn, "route_launches", {}).values():
            count.reset()


def tile_controls(got, want, limit: float) -> None:
    """The negative control of a tile check: a zeroed output, and one whose
    tiles past the fourth are skipped, must fail it."""
    skipped = got.clone()
    skipped[:, 4 * TILE_ROWS:] = 0
    if min(tile_rel_err(torch.zeros_like(got), want),
           tile_rel_err(skipped, want)) <= limit:
        raise AssertionError("the tile check passes a zeroed or "
                             "tile-skipping output")


def check_attention(gen) -> dict:
    """flash_attention_lse against its plain version, ``out`` and ``lse``.
    Tolerances: the dtype's for ``out`` (f32 rtol = atol = 2e-5, bf16
    2e-2, as the JAX kernel tests hold it) and, tile by tile,
    K3_TILE_REL; the f32 one for ``lse``, which is f32 whatever the
    inputs. Each case must launch K3 once by the route ``kernel_route``
    names. The main path's shape (the scoring forward's, bf16, causal)
    shows that a zeroed and a tile-skipping output fail the tile check,
    and is timed against the plain version and PyTorch's
    ``scaled_dot_product_attention``, the library yardstick."""
    import torch.nn.functional as F

    entry = None
    # (batch, sq, sk, heads, d, dtype, causal); the first is the main path.
    main = (SCORE_BATCH, LM.seq, LM.seq, LM.heads, LM.head_dim,
            torch.bfloat16, True)
    cases = [main, main[:6] + (False,)]
    cases += [(SCORE_BATCH, LM.seq, LM.seq, LM.heads, LM.head_dim,
               torch.float32, c) for c in (True, False)]
    cases += [(2, sq, sk, 2, 64, dt, c)
              for sq, sk in ((256, 256), (128, 256), (256, 128))
              for dt in (torch.float32, torch.bfloat16) for c in (True,
                                                                  False)]
    # bf16 at widths the wgmma kernels do not take: the f32 route, its rows
    # copied by cp.async (d 96) or element by element (d 36: 72-byte rows).
    cases += [(2, 256, 256, 2, d, torch.bfloat16, c)
              for d in (36, 96) for c in (True, False)]
    for b, sq, sk, h, d, dtype, causal in cases:
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                   .mul_(0.5).to(dtype) for s in (sq, sk, sk))
        route = kernel_route(q, k)
        count = flash_attention.route_launches[route]
        before = count.value
        got, got_lse = flash_attention_lse(q, k, v, causal=causal)
        launched = count.value - before
        want, want_lse = flash_attention_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        rel_tol = K3_TILE_REL[dtype]
        err = (got.float() - want.float()).abs().max().item()
        lse_err = (got_lse - want_lse).abs().max().item()
        rel = tile_rel_err(got, want)
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        torch.testing.assert_close(got_lse, want_lse, rtol=2e-5, atol=2e-5)
        if launched != 1 or rel > rel_tol:
            raise AssertionError(
                f"K3 {dtype} [{b},{sq},{h},{d}] sk {sk} causal {causal}: "
                f"{launched} launches by the {route} route, tile-wise "
                f"relative error {rel} (limit {rel_tol})")
        if (b, sq, sk, h, d, dtype, causal) == main:
            tile_controls(got, want, rel_tol)
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
                f"sk {sk} {'causal' if causal else 'full'} ({route}): max "
                f"abs err out {err:.3g}, lse {lse_err:.3g}, tile-wise "
                f"relative error {rel:.3g}; {ms:.3f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
                f"bound {bound_ms:.3f} ms")
        if (b, sq, sk, h, d, dtype, causal) == main:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), 10)
            line += f", scaled_dot_product_attention {lib_ms:.3f} ms"
            entry = {"design": route, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": "operations" if ops_ms >= bytes_ms
                     else "bytes",
                     "library_ms": lib_ms}
        log(line)
        del q, k, v
        torch.cuda.empty_cache()
    return entry


def _excess(got, want, tol: float) -> float:
    """max(|got - want| - (tol + tol |want|)): <= 0 where rtol = atol = tol
    holds."""
    got, want = got.float(), want.float()
    return ((got - want).abs() - (tol + tol * want.abs())).max().item()


# The tight limits on tile_rel_err for K3 and for K4 and K5 against their
# plain versions, which compute in f32 and round only their outputs.
# f32 (the "tf32x3" route): the summation order differs, and K3-K5
# multiply by the 3xTF32 split, which drops each product's small x small
# term (below 2**-22 of it) and truncates the small half (at most 2**-21
# of an operand): 4.0e-7 to 8.3e-7 in the CPU emulation of
# tests/test_torch_tf32x3.py, where one TF32 term alone reads 3.1e-4 to
# 4.7e-4; the tensor cores' truncated sums add to that only over short
# chains (csrc/tf32x3.cuh). On an H100 K3, K4 and K5 read 7e-7 to 2.5e-6
# (K4 7.8e-7 to 2.4e-6; on the CUDA cores it read 1.2e-7), PERF.md.
# bf16: the wgmma kernels also round an operand of their last products
# to bf16, where the plain versions keep f32: K3 its probabilities P, K5
# its P^T and dS^T, K4 its dS (before dS k). That is a relative rounding
# of at most 2**-9 = 2.0e-3 an entry, averaged over each sum, on top of
# the output's own rounding to bf16 (2.6e-3 to 3.6e-3 read for K3 and K5
# at every check shape and layer, PERF.md; the 3xTF32 K4 at d 36 and 96,
# which rounds only its output, read at most 1e-4). 1e-2 holds these with
# room, and a zeroed or skipped tile (1.0) fails it by two orders of
# magnitude.
K3_TILE_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
BWD_TILE_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def check_attention_backward(gen) -> tuple:
    """K4 (``flash_backward_dq``) and K5 (``flash_backward_dkv``) against
    their plain versions on the same inputs (q, k, v, dO, and o and LSE
    from K3), held two ways: entry by entry at the JAX kernel tests'
    rtol = atol (2e-4 in f32, 5e-2 in bf16), and tile by tile to
    BWD_TILE_REL, which scales with the gradients. Each case must launch
    K4 and K5 once each by the route ``kernel_route`` names. At the
    training shape it also shows that a zeroed output, and one whose
    tiles past the fourth are skipped, fail the tile check. The training
    shape (bf16, causal) is timed against the plain versions and against
    the backward of PyTorch's ``scaled_dot_product_attention``, which
    gives dQ, dK and dV together (the library yardstick of both rows)."""
    import torch.nn.functional as F

    entries = {}
    # (batch, sq, sk, heads, d, dtype, causal, g_lse); the first is the
    # main path's (the training step's attention).
    main = (TRAIN_BATCH, TRAIN.seq, TRAIN.seq, TRAIN.heads, TRAIN.head_dim,
            torch.bfloat16, True, False)
    cases = [main, main[:6] + (False, False)]
    cases += [main[:5] + (torch.float32, c, False) for c in (True, False)]
    cases += [(2, 256, 256, 2, 64, dt, c, False)
              for dt in (torch.float32, torch.bfloat16) for c in (True, False)]
    cases += [(2, sq, sk, 2, 64, dt, c, False)
              for sq, sk in ((128, 256), (256, 128))
              for dt in (torch.float32, torch.bfloat16) for c in (True, False)]
    cases += [(2, 256, 256, 2, 64, dt, True, True)
              for dt in (torch.float32, torch.bfloat16)]
    cases += [(2, 256, 256, 2, d, torch.bfloat16, True, True)
              for d in (36, 96)]
    for b, sq, sk, h, d, dtype, causal, with_glse in cases:
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                   .mul_(0.5).to(dtype) for s in (sq, sk, sk))
        do = torch.randn((b, sq, h, d), generator=gen, device="cuda") \
            .mul_(0.5).to(dtype)
        o, lse = flash_attention_lse(q, k, v, causal=causal)
        delta = attention_delta(o, do)
        g_lse = (torch.randn((b * h, sq), generator=gen, device="cuda")
                 .mul_(0.5) if with_glse else None)
        args = (q, k, v, do, lse, delta, causal, g_lse)
        route = kernel_route(q, k)
        counts = [fn.route_launches[route]
                  for fn in (flash_backward_dq, flash_backward_dkv)]
        before = [c.value for c in counts]
        got = (flash_backward_dq(*args), *flash_backward_dkv(*args))
        launched = [c.value - n for c, n in zip(counts, before)]
        want = flash_backward_reference(*args)
        torch.cuda.synchronize()
        tol = 2e-4 if dtype == torch.float32 else 5e-2
        rel_tol = BWD_TILE_REL[dtype]
        errs = [(g.float() - w.float()).abs().max().item()
                for g, w in zip(got, want)]
        rels = [tile_rel_err(g, w) for g, w in zip(got, want)]
        worst = max(_excess(g, w, tol) for g, w in zip(got, want))
        if worst > 0 or max(rels) > rel_tol or launched != [1, 1]:
            raise AssertionError(
                f"flash backward {dtype} [{b},{sq},{h},{d}] sk {sk} causal "
                f"{causal} g_lse {with_glse}: max abs err dq/dk/dv {errs} "
                f"(rtol = atol = {tol}), tile-wise relative error {rels} "
                f"(limit {rel_tol}), K4/K5 launched {launched} times by the "
                f"{route} route")
        if (b, sq, sk, h, d, dtype, causal, with_glse) == main:
            for g, w in zip(got, want):
                tile_controls(g, w, rel_tol)
        del got, want
        flops = 2.0 * b * h * sq * sk * d / (2.0 if causal else 1.0)
        peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        io = (2 * b * sq * h * d + 2 * b * sk * h * d) * q.element_size()
        rows = b * h * sq * 4 * (3 if with_glse else 2)
        line = (f"flash backward {str(dtype)[6:]} [{b},{sq},{h},{d}] sk {sk} "
                f"{'causal' if causal else 'full'}"
                f"{' g_lse' if with_glse else ''} ({route}): max abs err "
                f"dq {errs[0]:.3g}, dk {errs[1]:.3g}, dv {errs[2]:.3g}; "
                f"tile-wise relative error dq {rels[0]:.3g}, dk {rels[1]:.3g}"
                f", dv {rels[2]:.3g}")
        timed = {}
        for name, fn, plain, n_mm, out_rows in (
                ("K4", flash_backward_dq, flash_backward_dq_reference, 3, sq),
                ("K5", flash_backward_dkv, flash_backward_dkv_reference, 4,
                 2 * sk)):
            ms = cuda_ms(lambda: fn(*args), 10)
            plain_ms = cuda_ms(lambda: plain(*args), 3)
            ops_ms = n_mm * flops / peak * 1e3
            bytes_ms = (io + rows + b * out_rows * h * d * q.element_size()) \
                / HBM_BYTES_PER_S * 1e3
            timed[name] = dict(
                design=route,
                max_abs_err=max(errs[:1] if name == "K4" else errs[1:]),
                ms=ms, plain_ms=plain_ms, bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")
            line += (f"; {name} {ms:.3f} ms ({n_mm * flops / ms / 1e9:.1f} "
                     f"TFLOP/s), plain {plain_ms:.3f} ms, bound "
                     f"{timed[name]['bound_ms']:.3f} ms")
        if (b, sq, sk, h, d, dtype, causal, with_glse) == main:
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            gt = do.transpose(1, 2)
            lib_ms = cuda_ms(lambda: torch.autograd.grad(
                out, (qt, kt, vt), gt, retain_graph=True), 10)
            line += f"; scaled_dot_product_attention backward {lib_ms:.3f} ms"
            for name in timed:
                entries[name] = dict(timed[name], library_ms=lib_ms)
            del qt, kt, vt, out, gt
        log(line)
        del q, k, v, do, o, lse, delta, g_lse, args
        torch.cuda.empty_cache()
    return entries["K4"], entries["K5"]


# -- main path ---------------------------------------------------------------

# Every scheduler here fixes its lease grace. The adaptive one (20x the
# handoff EWMA, 10 s floor) fell below a tenant's first handoff, which
# allocates its pinned shadows (10.6-13.7 s for 41-43 GiB on an H100
# host): the scheduler revoked the tenant and granted the peer while the
# revoked set was still on the card, and both ran out of device memory
# (the LM pair and the QoS pair, one run each). A lost LOCK_RELEASED on
# the process pair's chaos link costs this grace once.
LEASE_GRACE_S = 30
REVOKED = "lease expired — revoking"


class Scheduler:
    """A private tpushare-scheduler, lease grace LEASE_GRACE_S, whose log
    goes to a file."""

    def __init__(self, sock_dir: str, tq: int, env: dict = None):
        self.sock_dir = sock_dir
        self.log_path = Path(sock_dir) / "scheduler.log"
        env = dict(os.environ, TPUSHARE_REVOKE_GRACE_S=str(LEASE_GRACE_S),
                   **(env or {}), TPUSHARE_SOCK_DIR=sock_dir,
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


def probe_tenant(name: str, budget: int, make_set, workload=None) -> dict:
    """One probe tenant: ``workload`` once (its result under "result"),
    then the seconds of one warm handoff cycle (under "cycle_s") of the
    dirty set ``make_set(arena)`` creates on the card, evicted to pinned
    shadows and prefetched back through the arena's own DROP_LOCK/LOCK_OK
    hooks. The first, untimed cycle materializes the shadows; PyTorch keeps
    the pinned blocks cached, so the timed cycle (on a freshly made set)
    and the tenants that follow reuse them."""
    out = {}

    def work(tenant: Tenant):
        if workload is not None:
            out["result"] = workload(tenant)
        a = tenant.arena
        # The probe pages explicitly while it holds the lock; count it as
        # an op in flight (the arena's busy signal), or the client's idle
        # detector would release the lock under it.
        with a._lock:
            a._busy_depth += 1
        try:
            for timed in (False, True):
                vas = make_set(a)
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

    probe = Tenant(name, budget_bytes=budget, pool=vmem.PhysicalPool(budget))
    try:
        probe.run(work)
    finally:
        probe.close()
    return out


def measure_handoff_cycle(chunks: int, budget: int) -> float:
    """Seconds of one warm handoff cycle of ``chunks`` dirty chunks."""
    return probe_tenant("handoff-probe", budget, lambda a: [
        a.device_array((CHUNK_SIDE, CHUNK_SIDE), torch.float32, seed=i)
        for i in range(chunks)])["cycle_s"]


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
    twice) and revoked no lease, and both evicted and prefetched; returns
    the DROP_LOCKs."""
    revocations = re.findall(REVOKED + r"[^\n]*", log_text)
    if revocations:
        raise AssertionError(f"the scheduler revoked a lock: {revocations}")
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


def run_pair(name: str, budget: int, sched: Scheduler, workload,
             solo_fault, differs, use_pager: bool = False,
             solo: tuple = None) -> dict:
    """A solo tenant, then two co-located tenants sharing one pool of
    ``budget``, each running a fresh ``workload()``. ``solo_fault(solo)``
    and ``differs(result, solo)`` name what is wrong with the solo result
    and how a co-located result differs from it (None where nothing is).
    Both tenants must be granted and dropped at least twice and evict and
    prefetch, and peak device memory must stay within the card.
    ``use_pager`` attaches the proactive pager to both co-located tenants
    (with PAGER_ENV); ``solo`` = (result, wall) of an earlier solo run of
    the same workload, which then is not run again."""
    torch.cuda.reset_peak_memory_stats()
    if solo is None:
        solo_t = Tenant(f"{name}-solo", budget_bytes=budget,
                        pool=vmem.PhysicalPool(budget))
        try:
            t0 = time.time()
            solo_res = solo_t.run(workload())
            solo_wall = time.time() - t0
        finally:
            solo_t.close()
    else:
        solo_res, solo_wall = solo
    fault = solo_fault(solo_res)
    if fault:
        raise AssertionError(f"{name} solo: {fault}")
    solo_peak = torch.cuda.max_memory_allocated() if solo is None else None
    pool = vmem.PhysicalPool(budget)
    with mock.patch.dict(os.environ, PAGER_ENV if use_pager else {}):
        tenants = [Tenant(f"{name}-t{i}", budget_bytes=budget, pool=pool,
                          use_pager=use_pager) for i in (1, 2)]
    try:
        report = run_colocated({t: workload() for t in tenants},
                               timeout_s=900)
        stats, drops, handoff = pair_counters(tenants)
    finally:
        for t in tenants:
            t.close()
    if not report.ok:
        revocations = re.findall(REVOKED + r"[^\n]*", sched.text())
        raise RuntimeError(f"{name} co-located tenants failed: "
                           f"{report.errors}; scheduler revocations: "
                           f"{revocations}")
    for t in tenants:
        why = differs(report.results[t.name], solo_res)
        if why:
            raise AssertionError(f"{t.name}: {why}")
    n_drop = check_pair(name, [t.name for t in tenants], stats, drops,
                        sched.text())
    peak = torch.cuda.max_memory_allocated()
    physical = torch.cuda.mem_get_info()[1]
    if peak > physical:
        raise AssertionError(f"peak allocated {peak} > physical {physical}")
    h_sum = sum(s for s, _ in handoff.values())
    h_n = sum(n for _, n in handoff.values())
    res = {"solo": solo_res, "solo_s": solo_wall,
           "makespan_s": report.makespan_s,
           "ratio": report.makespan_s / (2.0 * solo_wall), "handoffs": h_n,
           "handoff_mean_s": h_sum / max(h_n, 1), "drops": drops,
           "solo_peak_bytes": solo_peak, "peak_bytes": peak, "stats": stats}
    log(f"[{name}] solo wall {solo_wall:.2f} s, co-located makespan "
        f"{report.makespan_s:.2f} s -> makespan/(2 x solo) "
        f"{res['ratio']:.4f}; handoffs {h_n} mean "
        f"{res['handoff_mean_s']:.3f} s; scheduler DROP_LOCKs {n_drop}; "
        f"drops per tenant {drops}; peak allocated "
        + (f"{solo_peak / GiB:.2f} GiB solo, " if solo is None else "")
        + f"{peak / GiB:.2f} GiB over the pair, of {physical / GiB:.2f} GiB")
    return res


def run_kind(kind: str, chunks: int, budget: int, sched: Scheduler,
             step_s: float, tq: int) -> dict:
    """Solo, then the co-located pair, of one burner kind."""
    wss = chunks * CHUNK_BYTES
    steps = max(3, math.ceil(PAIR_QUANTA * tq / step_s) + 2)
    log(f"[{kind}] {steps} steps, measured {step_s:.3f} s/step, TQ {tq} s")

    def workload():
        return burner_workload(kind, wss, steps, chunks=chunks,
                               device_ratio=DEVICE_RATIO)

    res = run_pair(
        kind, budget, sched, workload,
        lambda s: None if s.passed else "checksum not finite",
        lambda r, s: None if r.checksum == s.checksum else
        f"checksum {r.checksum!r} != solo {s.checksum!r}")
    log(f"[{kind}] checksum {res['solo'].checksum!r} (solo = both tenants)")
    res.update(kind=kind, steps=steps, tq_s=tq, wss_bytes=wss)
    return res


# -- the proactive pager -----------------------------------------------------

def handoffs_of(names) -> list:
    """(seconds, bytes moved, clean share) of every handoff of ``names``
    that evicted anything, from the event ring."""
    return [(e.args["seconds"], e.args.get("moved", 0),
             e.args.get("clean", 0) / e.args["n"])
            for e in tev.ring().snapshot()
            if e.kind == tev.HANDOFF and e.who in names and e.args
            and e.args.get("n", 0) > 0]


def trickled_bytes(names) -> int:
    """Bytes the pagers of ``names`` moved to the host while computing."""
    snap = telemetry.registry().snapshot().get(
        "tpushare_writeback_bytes_total", {})
    return int(sum(snap.get((n,), 0) for n in names))


def handoff_summary(hs: list) -> dict:
    secs = [h[0] for h in hs]
    return {"handoffs": len(hs),
            "median_s": statistics.median(secs) if secs else None,
            "p99_s": percentile(secs, 99),
            "moved_bytes": sum(h[1] for h in hs),
            "clean_median": statistics.median(h[2] for h in hs)
            if hs else None}


def ab_workload(chunks: int, steps: int):
    """The reference A/B's stepper (``bench.py`` run_pager_ab_bench,
    ``tests/test_pager.py``) at card scale: ``chunks`` burner chunks made
    on the card, every one dirtied once by a donated ``x * 1.0001`` (in
    place), then one chunk a step re-dirtied, with AB_SLEEP_S of host time
    between steps. Returns each chunk's f64 sum."""
    def work(tenant: Tenant):
        a = tenant.arena
        step = vmem.vop(lambda x: x.mul_(1.0001), donate_argnums=(0,))
        total = vmem.vop(lambda x: x.sum(dtype=torch.float64))
        xs = [a.device_array((CHUNK_SIDE, CHUNK_SIDE), torch.float32,
                             seed=1000 + i) for i in range(chunks)]
        xs = [step(x) for x in xs]
        for i in range(steps):
            xs[i % chunks] = step(xs[i % chunks])
            tenant.client.mark_activity()
            time.sleep(AB_SLEEP_S)
        sums = [float(total(x).numpy()) for x in xs]
        for x in xs:
            x.delete()
        return sums

    return work


def run_ab_leg(leg: str, chunks: int, steps: int, budget: int,
               use_pager: bool, first_touch: bool) -> dict:
    env = dict(PAGER_ENV) if use_pager else {}
    if first_touch:
        env["TPUSHARE_PAGER_FIRST_TOUCH"] = "1"
    pool = vmem.PhysicalPool(budget)
    with mock.patch.dict(os.environ, env):
        tenants = [Tenant(f"ab-{leg}-t{i}", budget_bytes=budget, pool=pool,
                          use_pager=use_pager) for i in (1, 2)]
    try:
        report = run_colocated({t: ab_workload(chunks, steps)
                                for t in tenants}, timeout_s=900)
        names = [t.name for t in tenants]
        hs = handoffs_of(names)
        trickled = trickled_bytes(names)
        factors = [t.pager.writeback_rate_factor for t in tenants
                   if t.pager is not None]
    finally:
        for t in tenants:
            t.close()
    if not report.ok:
        raise RuntimeError(f"A/B leg {leg} failed: {report.errors}")
    out = handoff_summary(hs)
    out.update(makespan_s=report.makespan_s, trickled_bytes=trickled,
               trickled_bytes_per_s=trickled / report.makespan_s,
               rate_factors=factors,
               results=[report.results[n] for n in names])
    return out


def pager_ab(chunks: int, budget: int, sched: Scheduler, tq: int) -> dict:
    """The handoff A/B at card scale: the same co-located pair of
    ab_workload tenants with synchronous handoffs, with the proactive
    pager, and with the pager in first-touch mode, at the burner pair's
    working set and quantum. Every leg's results must equal the solo
    run's bit for bit, and each leg must hand off at least twice."""
    steps = max(chunks, math.ceil(AB_QUANTA * tq / AB_SLEEP_S))
    log(f"[ab] {chunks} chunks of {CHUNK_BYTES >> 20} MiB per tenant, "
        f"{steps} steps of one chunk + {AB_SLEEP_S * 1e3:.0f} ms, TQ {tq} s;"
        f" pager knobs {json.dumps(PAGER_ENV)}")
    solo = Tenant("ab-solo", budget_bytes=budget,
                  pool=vmem.PhysicalPool(budget))
    try:
        t0 = time.time()
        want = solo.run(ab_workload(chunks, steps))
        solo_s = time.time() - t0
    finally:
        solo.close()
    legs = {}
    for leg, use_pager, first_touch in (("sync", False, False),
                                        ("proactive", True, False),
                                        ("first_touch", True, True)):
        r = run_ab_leg(leg, chunks, steps, budget, use_pager, first_touch)
        same = all(res == want for res in r.pop("results"))
        r.update(ratio=r["makespan_s"] / (2.0 * solo_s), equal_solo=same)
        legs[leg] = r
        log(f"[ab] {leg}: {r['handoffs']} handoffs, median "
            f"{r['median_s']} s, p99 {r['p99_s']} s, moved at handoffs "
            f"{r['moved_bytes'] / GiB:.3f} GiB, clean share median "
            f"{r['clean_median']}, trickled {r['trickled_bytes'] / GiB:.3f} "
            f"GiB at {r['trickled_bytes_per_s'] / 1e9:.3f} GB/s (rate "
            f"factors at the end {r['rate_factors']}), makespan "
            f"{r['makespan_s']:.2f} s = {r['ratio']:.4f} x 2 x solo "
            f"({solo_s:.2f} s); results equal solo and the other legs bit "
            f"for bit: {same}")
        if not same:
            raise AssertionError(f"A/B leg {leg}: results differ from solo")
        if r["handoffs"] < 2:
            raise AssertionError(f"A/B leg {leg} handed off "
                                 f"{r['handoffs']} times")
    return {"steps": steps, "solo_s": solo_s, "tq_s": tq,
            "checksum": sum(want), "legs": legs}


class PhaseSpy:
    """Check-only instrumentation of one serving tenant's arena: which
    arrays left the card under pressure (outside handoffs), in which
    phase and with which tag, and, at each handoff, how many resident
    arrays were tagged "act" and how many of those stayed in the hot
    set."""

    def __init__(self, arena):
        self.pressure: list = []   # (phase, hint, nbytes)
        self.handoffs: list = []   # (act arrays resident, act kept hot)
        self._handoff_thread = None  # the thread inside a handoff
        evict, handoff = arena._evict_batch, arena.sync_and_evict_all

        def spy_evict(vas):
            if threading.get_ident() != self._handoff_thread:
                self.pressure += [(arena.phase, va._phase_hint, va.nbytes)
                                  for va in vas if va._dev is not None]
            return evict(vas)

        def spy_handoff():
            # The arrays tagged "act" before the handoff starts (a tag set
            # while it runs may come before or after the hot set is made).
            acts = {id(va) for va in list(arena._live)
                    if va._dev is not None and va._phase_hint == "act"}
            self._handoff_thread = threading.get_ident()
            try:
                handoff()
            finally:
                self._handoff_thread = None
            kept = sum(1 for r in arena._hot if id(r()) in acts)
            self.handoffs.append((len(acts), kept))

        arena._evict_batch = spy_evict
        arena.sync_and_evict_all = spy_handoff


def serving_tenants(names: dict, pool_bytes: int, decode_budget: int):
    """The decode and prefill tenants of ``names`` (role -> name), with the
    pager and the wss policy, in one pool."""
    pool = vmem.PhysicalPool(pool_bytes)
    env = dict(PAGER_ENV, TPUSHARE_PAGER_POLICY="wss")
    with mock.patch.dict(os.environ, env):
        return {role: Tenant(name, pool=pool, use_pager=True,
                             budget_bytes=decode_budget
                             if role == "decode" else None)
                for role, name in names.items()}


def decode_with_cold_set():
    """decode_workload, after the tenant made SERVE_COLD_CHUNKS untagged
    burner chunks on the card (state it keeps but does not read while it
    decodes): the decode tenant's budget holds its cache, weight and
    state but not also all of these, so the cache's first page-ins must
    evict something mid-decode."""
    work = decode_workload(SERVE_TOKENS, **SERVE, think_s=SERVE_THINK_S,
                           requests=SERVE_REQUESTS)

    def run(tenant: Tenant):
        cold = [tenant.arena.device_array((CHUNK_SIDE, CHUNK_SIDE),
                                          torch.float32, seed=2000 + i)
                for i in range(SERVE_COLD_CHUNKS)]
        try:
            return work(tenant)
        finally:
            for va in cold:
                va.delete()

    return run


def run_serving(names: dict, pool_bytes: int, decode_budget: int) -> dict:
    tenants = serving_tenants(names, pool_bytes, decode_budget)
    spies = {role: PhaseSpy(t.arena) for role, t in tenants.items()}
    works = {"decode": decode_with_cold_set(),
             "prefill": prefill_workload(**PREFILL)}
    if len(tenants) == 2:
        # Prefill requests arrive once the decode tenant serves: its model
        # takes longer to build on the host than the prefill runs.
        prefill, dec = works["prefill"], tenants["decode"].arena

        def after_decode_starts(tenant: Tenant):
            deadline = time.time() + 300
            while dec.phase != "decode":
                if time.time() > deadline:
                    raise TimeoutError("the decode tenant never decoded")
                time.sleep(0.01)
            return prefill(tenant)

        works["prefill"] = after_decode_starts
    try:
        report = run_colocated({t: works[role]
                                for role, t in tenants.items()},
                               timeout_s=600)
        stats = {role: t.telemetry_snapshot()
                 for role, t in tenants.items()}
        drops = {role: int(t.client._m["drops"].value)
                 for role, t in tenants.items()}
        waits = gate_wait_samples({t.name: role
                                   for role, t in tenants.items()},
                                  tev.ring().snapshot())
    finally:
        for t in tenants.values():
            t.close()
    if not report.ok:
        raise RuntimeError(f"serving tenants failed: {report.errors}")
    return {"results": {role: report.results[t.name]
                        for role, t in tenants.items()},
            "stats": stats, "drops": drops, "waits": waits,
            "spies": spies, "makespan_s": report.makespan_s}


def serving_phases(sched: Scheduler) -> dict:
    """The serving phase plane on the card: a decode_workload tenant (the
    mock decoder at the LM's cache widths) and a prefill_workload tenant,
    each alone, then as a pair, with the pager and the wss policy. Both
    checksums must equal solo; mid-decode pressure must evict no
    KV-tagged array; every handoff must drop the prefill tenant's "act"
    arrays from its hot set, which the grant then never prefetches."""
    release_host_cache()
    sched.set_tq(SERVE_TQ)
    d = SERVE["d_model"]
    kv = 2 * SERVE["layers"] * SERVE["batch"] * SERVE["max_len"] * d * 4
    state = (d * d + 2 * SERVE["batch"] * d) * 4
    # Room for the cache, weight and state, and half the cold set.
    decode_budget = kv + state + SERVE_COLD_CHUNKS * CHUNK_BYTES // 2
    pool_bytes = decode_budget + 8 * GiB
    log(f"[serve] decode: {SERVE}, {SERVE_TOKENS} tokens in "
        f"{SERVE_REQUESTS} requests, {SERVE_THINK_S * 1e3:.0f} ms between "
        f"tokens, KV {kv / GiB:.2f} GiB tagged 'kv', cold set "
        f"{SERVE_COLD_CHUNKS} x {CHUNK_BYTES >> 20} MiB untagged, budget "
        f"{decode_budget / GiB:.3f} GiB; prefill: {PREFILL}; TQ {SERVE_TQ} "
        f"s; pager knobs {json.dumps(PAGER_ENV)}, policy wss")
    solo = {}
    for role in ("decode", "prefill"):
        t0 = time.time()
        out = run_serving({role: f"serve-solo-{role}"}, pool_bytes,
                          decode_budget)
        solo[role] = (out["results"][role], time.time() - t0)
    t0 = time.time()
    pair = run_serving({"decode": "serve-dec", "prefill": "serve-pre"},
                       pool_bytes, decode_budget)
    wall = time.time() - t0
    res = {"solo_s": {r: s for r, (_, s) in solo.items()},
           "makespan_s": pair["makespan_s"], "wall_s": wall}
    for role in ("decode", "prefill"):
        got = pair["results"][role]["checksum"]
        want = solo[role][0]["checksum"]
        if got != want:
            raise AssertionError(f"serving {role} checksum {got!r} != solo "
                                 f"{want!r}")
        res[f"{role}_checksum"] = got
    dec_spy, pre_spy = pair["spies"]["decode"], pair["spies"]["prefill"]
    st = pair["stats"]
    pressure = [p for p in dec_spy.pressure if p[0] == "decode"]
    kv_out = [p for p in pressure if p[1] == "kv"]
    counted = st["decode"]["evictions"] - st["decode"]["handoff_evicts"]
    acts = sum(a for a, _ in pre_spy.handoffs)
    acts_kept = sum(k for _, k in pre_spy.handoffs)
    wait = pair["waits"].get("decode", [])
    res.update(
        decode_pressure_evictions=len(pressure),
        decode_pressure_bytes=sum(p[2] for p in pressure),
        decode_kv_pressure_evictions=len(kv_out),
        decode_counter_pressure_evictions=counted,
        decode_page_outs=st["decode"]["page_out"],
        prefill_handoffs=len(pre_spy.handoffs), prefill_act_evicted=acts,
        prefill_act_kept_hot=acts_kept,
        prefill_prefetches=st["prefill"]["prefetches"],
        drops=pair["drops"], gate_wait_n=len(wait),
        handoffs={role: len(handoffs_of([name])) for role, name in (
            ("decode", "serve-dec"), ("prefill", "serve-pre"))},
        gate_wait_p50_s=percentile(wait, 50),
        gate_wait_p99_s=percentile(wait, 99),
        token_lat_p50_s=percentile(
            pair["results"]["decode"]["token_lat_s"], 50),
        token_lat_p99_s=percentile(
            pair["results"]["decode"]["token_lat_s"], 99))
    log(f"[serve] solo decode {res['solo_s']['decode']:.2f} s, prefill "
        f"{res['solo_s']['prefill']:.2f} s; pair makespan "
        f"{pair['makespan_s']:.2f} s, drops {pair['drops']}, handoffs "
        f"{res['handoffs']}; both checksums"
        f" equal solo ({res['decode_checksum']!r}, "
        f"{res['prefill_checksum']!r})")
    log(f"[serve] decode pressure: {len(pressure)} arrays "
        f"({res['decode_pressure_bytes'] / GiB:.3f} GiB) evicted mid-decode"
        f" outside handoffs (arena counters: {counted}), {len(kv_out)} of "
        f"them tagged kv; decode page-outs {st['decode']['page_out']}; "
        f"prefill: {len(pre_spy.handoffs)} handoffs evicted {acts} 'act' "
        f"arrays, {acts_kept} kept in the hot set (per handoff "
        f"{pre_spy.handoffs}), prefetches "
        f"{st['prefill']['prefetches']}; decode gate wait p50 "
        f"{res['gate_wait_p50_s']} s, p99 {res['gate_wait_p99_s']} s over "
        f"{len(wait)} waits; token latency p50 {res['token_lat_p50_s']} s, "
        f"p99 {res['token_lat_p99_s']} s")
    if not pressure or counted != len(dec_spy.pressure):
        raise AssertionError(f"no decode pressure to read: spy "
                             f"{len(dec_spy.pressure)}, counters {counted}")
    if kv_out:
        raise AssertionError(f"{len(kv_out)} KV-tagged arrays evicted "
                             "under decode pressure")
    if acts == 0 or acts_kept:
        raise AssertionError(f"'act' arrays at handoffs: {acts} evicted, "
                             f"{acts_kept} kept hot")
    if min(res["handoffs"].values()) < 2:
        raise AssertionError(f"serving handoffs {res['handoffs']}")
    return res


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
# The wgmma K3 also rounds P to bf16; check_lm_inference reads what that
# rounding alone does to the logits (attention_p_bf16) beside K3's share.
LOGITS_OUTSIDE = 0.05


def attention_p_bf16(q, k, v, causal: bool):
    """Check-only: the plain forward with its probabilities rounded to
    bf16 before P v, where the wgmma K3 rounds them (the row sums from
    the unrounded P, as the kernel takes them). Everything else as in
    flash_attention_reference, in f32."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        keep = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = s.masked_fill(~keep, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    rows = p.sum(dim=-1, keepdim=True).permute(0, 2, 1, 3)  # [B, Sq, H, 1]
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(),
                       v.float())
    return (out / rows).to(q.dtype)


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
    logits outside 2e-2). Beside them, a reading with no limit: the
    forward through attention_p_bf16 against the plain one, the spread
    that rounding P to bf16 alone gives."""
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
        reset_counts(flash_attention)
        t0 = time.perf_counter()
        logits = forward(params, LM, tokens, None)
        a.fence()
        out["forward_s"] = time.perf_counter() - t0
        out["launches"] = flash_attention.launches.value
        out["wgmma_launches"] = flash_attention.route_launches[WGMMA].value
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
        rounded = forward(params, LM, tokens,
                          local_attn(LM, attention_p_bf16))
        out["forward_p_bf16"] = compare(rounded, ref).numpy().tolist()
        rounded.delete()
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
    for what, against in (("forward", "plain-attention forward"),
                          ("forward_p_bf16", "plain-attention forward"),
                          ("decode", "K3 forward")):
        err, outside, rel, agree = out[what]
        log(f"[lm] {what} vs {against}: max abs err {err:.4g}, share "
            f"outside rtol/atol 2e-2 {outside:.4g}, norm-wise relative "
            f"error {rel:.3g}, argmax agreement {agree:.4f}")
    if worst > 0 or lse_err > 2e-5 or not out["same_logits"] \
            or len(out["layers"]) != LM.depth:
        raise AssertionError(f"K3 at the LM's layers: {out['layers']}")
    for what in ("forward", "decode"):
        _, outside, _, agree = out[what]
        if outside > LOGITS_OUTSIDE or agree <= 0.95:
            raise AssertionError(f"LM {what} check failed: {out[what]}")
    if out["launches"] != LM.depth or out["wgmma_launches"] != LM.depth:
        raise AssertionError(f"the forward launched K3 {out['launches']} "
                             f"times, {out['wgmma_launches']} by the wgmma "
                             f"route, not {LM.depth}")
    log(f"[lm] forward [{SCORE_BATCH},{LM.seq}] {out['forward_s']:.3f} s "
        f"(plain attention {out['plain_forward_s']:.3f} s), {LM.depth} K3 "
        f"launches; teacher-forced decode batch {SCORE_BATCH} "
        f"{out['decode_token_s'] * 1e3:.1f} ms/token")
    return out


def lm_workload_of(requests: int):
    return lm_workload(LM, requests=requests, score_batch=SCORE_BATCH,
                       decode_batch=DECODE_BATCH,
                       decode_tokens=DECODE_TOKENS, seed=LM_SEED)


def measure_lm(budget: int) -> dict:
    """One LM tenant's request time (the second of two requests) and one
    warm handoff cycle of its parameters and cache. Both parts are dirty,
    so the cycle moves the whole set each way, more than a serving handoff
    (clean parameters are dropped, not written back): the quantum that
    follows is conservative."""
    def make_set(a):
        params = vmem.vop(lambda dev: LM.init(LM_SEED, device=dev))(a.device)
        cache = vmem.vop(lambda dev: init_kv_cache(
            LM, DECODE_BATCH, LM.seq, device=dev))(a.device)
        return [*params.values(), *cache.values()]

    out = probe_tenant("lm-probe", budget, make_set, lm_workload_of(2))
    res = out.pop("result")
    return dict(out, request_s=res.score_s[-1] + res.decode_s[-1])


def lm_differs(res, solo, requests: int = None):
    """What differs between ``res`` and the solo run, over the first
    ``requests`` of its requests (all by default): each request continues
    one seeded session, so a shorter run is the longer one's prefix."""
    n = len(solo.checksums) if requests is None else requests
    want = solo.checksums[:n]
    if res.checksums != want:
        return f"scoring checksums {res.checksums} != solo {want}"
    if res.tokens.shape != solo.tokens[:n].shape or \
            not (res.tokens == solo.tokens[:n]).all():
        return "decoded other tokens than solo"
    return None


def run_lm(budget: int, sched: Scheduler, requests: int, tq: int) -> dict:
    """The LM serving pair: a solo tenant, then two co-located tenants,
    each holding its parameters and KV cache in its own arena."""
    log(f"[lm] {requests} requests per tenant, TQ {tq} s")
    res = run_pair("lm", budget, sched, lambda: lm_workload_of(requests),
                   lambda s: None if s.passed else "checksums not finite",
                   lm_differs)
    solo = res["solo"]
    request_s = statistics.mean(
        a + b for a, b in zip(solo.score_s, solo.decode_s))
    token_ms = statistics.mean(solo.decode_s) / DECODE_TOKENS * 1e3
    score_s = statistics.mean(solo.score_s)
    log(f"[lm] solo request {request_s:.3f} s (scoring {score_s:.3f} s, "
        f"decode {token_ms:.2f} ms/token at batch {DECODE_BATCH}); scoring "
        f"checksums and {solo.tokens.size} decoded tokens equal solo in "
        f"both tenants (first checksum {solo.checksums[0]!r})")
    res.update(requests=requests, tq_s=tq, request_s=request_s,
               score_s=score_s, decode_token_ms=token_ms)
    return res


def run_lm_pager(budget: int, sched: Scheduler, requests: int, tq: int,
                 sync: dict) -> dict:
    """The LM serving pair once more, with the proactive pager on both
    tenants, against the sync pair's solo run: every scoring checksum and
    decoded token must equal it. Its parameters go clean once trickled;
    its cache is rewritten every token."""
    log(f"[lm pager] {requests} requests per tenant, TQ {tq} s, pager "
        f"knobs {json.dumps(PAGER_ENV)}")
    res = run_pair("lmpg", budget, sched, lambda: lm_workload_of(requests),
                   lambda s: None if s.passed else "checksums not finite",
                   lm_differs, use_pager=True,
                   solo=(sync["solo"], sync["solo_s"]))
    names = ["lmpg-t1", "lmpg-t2"]
    res["pager"] = handoff_summary(handoffs_of(names))
    res["sync"] = handoff_summary(handoffs_of(["lm-t1", "lm-t2"]))
    res["trickled_bytes"] = trickled_bytes(names)
    pg, sy = res["pager"], res["sync"]
    log(f"[lm pager] handoffs {pg['handoffs']}, median {pg['median_s']} s "
        f"(sync pair {sy['median_s']} s), p99 {pg['p99_s']} s (sync "
        f"{sy['p99_s']} s), moved at handoffs {pg['moved_bytes'] / GiB:.2f}"
        f" GiB (sync {sy['moved_bytes'] / GiB:.2f} GiB), clean share "
        f"median {pg['clean_median']} (sync {sy['clean_median']}), "
        f"trickled {res['trickled_bytes'] / GiB:.2f} GiB; every checksum "
        f"and decoded token equal solo and the sync pair")
    res.update(requests=requests, tq_s=tq)
    return res


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
    # PAIR_QUANTA of work, within one session of LM.seq cached positions.
    # A request is a third of a quantum, so one request is added, not the
    # other pairs' two steps; with none, an LM tenant on the H100 was
    # dropped only the twice its check needs.
    requests = min(LM.seq // DECODE_TOKENS,
                   max(3, math.ceil(PAIR_QUANTA * tq / probe["request_s"])
                       + 1))
    log(f"[lm] handoff cycle {probe['cycle_s']:.3f} s "
        f"({sizes['wss_bytes'] / GiB:.2f} GiB out and back) -> TQ {tq} s; "
        f"request {probe['request_s']:.3f} s -> {requests} requests")
    reset_counts(flash_attention)
    res = phases.run("main path lm", run_lm, budget, sched, requests, tq)
    launches = flash_attention.launches.value
    res["wgmma_launches"] = flash_attention.route_launches[WGMMA].value
    want = LM.depth * 3 * requests  # solo + two co-located tenants
    if launches != want:
        raise AssertionError(f"K3 launched {launches} times on the LM main "
                             f"path, not {LM.depth} x {3 * requests}")
    reset_counts(flash_attention)
    pg = phases.run("main path lm pager", run_lm_pager, budget, sched,
                    requests, tq, res)
    pg_launches = flash_attention.launches.value
    res["pager_wgmma_launches"] = flash_attention.route_launches[
        WGMMA].value
    if pg_launches != LM.depth * 2 * requests:
        raise AssertionError(f"K3 launched {pg_launches} times on the LM "
                             f"pager path, not {LM.depth} x {2 * requests}")
    res.update(launches=launches, cycle_s=probe["cycle_s"], check=check,
               pager_pair=pg, pager_launches=pg_launches, **sizes)
    return res


# -- LM training -------------------------------------------------------------

# The full-width training step through the kernels against the same step
# through the plain attention: both compute attention in f32 and round its
# output and gradients to bf16, so they differ by a flip of the last bf16
# bit here and there, which 24 layers of bf16 activations carry forward
# and back (the same spread in the logits grows with depth, PERF.md).
# Measured at 1.27e-2 norm-wise at most on an H100 (PERF.md); each
# parameter's gradient is held to GRAD_REL, the loss to 1e-3 relative.
# The kernels themselves are held per layer, tile by tile.
GRAD_REL = 0.05
# _matmul_f32's backward on the card (bf16 tensor-core products of the
# bf16-rounded f32 cotangent, f32 accumulation) against the exact f32
# products JAX takes, norm-wise: the cotangent's rounding (2**-9 an
# element) averaged over each sum, which flips the bf16 result by one ulp
# (2**-8 to 2**-7 of it) in part of the entries (3.2e-3 measured, PERF.md).
MATMUL_BWD_REL = 5e-3


def backward_tile_errs(q, k, v, do, causal: bool) -> list:
    """tile_rel_err of K4's dQ and K5's dK, dV against the plain backward
    on one layer's q, k, v and dO (o and LSE from K3 again: the kernels
    are deterministic, so these are the bits the step's backward used)."""
    with torch.no_grad():
        o, lse = flash_attention_lse(q, k, v, causal=causal)
        args = (q, k, v, do, lse, attention_delta(o, do), causal)
        got = (flash_backward_dq(*args), *flash_backward_dkv(*args))
        want = flash_backward_reference(*args)
        return [tile_rel_err(a, b) for a, b in zip(got, want)]


def check_lm_training() -> dict:
    """At full width and the pair's depth, one training step's loss and
    gradients, outside any arena: the step through the kernels (its
    launches and its peak device memory above the parameters); a second
    step whose attention outputs carry a gradient hook, which holds K4 and
    K5 against the plain backward on every layer's own q, k, v and dO
    (tile_rel_err within the bf16 BWD_TILE_REL); the same step through
    the plain attention (loss within 1e-3 relative, gradients within
    GRAD_REL norm-wise); and ``_matmul_f32``'s backward at the head's
    shape against exact f32 products (MATMUL_BWD_REL)."""
    out = {}
    params = TRAIN.init(TRAIN_SEED, device="cuda")
    tokens = torch.from_numpy(synthetic_tokens(
        TRAIN, TRAIN_BATCH, TRAIN_SEED + 1)).cuda()
    wrappers = (flash_attention, flash_backward_dq, flash_backward_dkv)
    reset_counts(*wrappers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    loss, grads = lm_loss_and_grads(params, TRAIN, tokens)
    torch.cuda.synchronize()
    out["step_s"] = time.perf_counter() - t0
    out["transient_bytes"] = torch.cuda.max_memory_allocated() - base
    out["launches"] = [fn.launches.value for fn in wrappers]
    out["wgmma_launches"] = [fn.route_launches[WGMMA].value
                             for fn in wrappers]
    out["loss"] = loss.item()
    kernel_grads = {k: g.cpu() for k, g in grads.items()}
    del grads

    layers = []  # per layer: tile_rel_err of dq, dk, dv

    def hooked(q, k, v, causal):
        o = flash_attention(q, k, v, causal=causal)
        # With remat the block runs twice; only the first forward's output
        # is on the backward's path, so each layer's hook fires once.
        o.register_hook(lambda do: layers.append(
            backward_tile_errs(q, k, v, do, causal)))
        return o

    lm_loss_and_grads(params, TRAIN, tokens, local_attn(TRAIN, hooked))
    out["layers"] = layers

    def plain(q, k, v, causal):
        return flash_attention_reference(q, k, v, causal=causal)[0]

    ref_loss, ref = lm_loss_and_grads(params, TRAIN, tokens,
                                      local_attn(TRAIN, plain))
    out["plain_loss"] = ref_loss.item()
    grad_err = {}
    for name, want in ref.items():
        got = kernel_grads[name].cuda()
        grad_err[name] = ((got - want).norm() / want.norm()).item()
        del got
    del ref
    out["grad_rel"] = grad_err

    # _matmul_f32 at the head's shape: x [B*S, D] bf16, w = embed^T bf16.
    w = params["embed"].to(torch.bfloat16).t().requires_grad_()
    x = torch.randn((TRAIN_BATCH * TRAIN.seq, TRAIN.dim), device="cuda",
                    dtype=torch.bfloat16).requires_grad_()
    g = torch.randn((x.shape[0], w.shape[1]), device="cuda") * 1e-4
    _matmul_f32(x, w).backward(g)
    exact = ((g @ w.detach().float().t()).to(torch.bfloat16),
             (x.detach().float().t() @ g).to(torch.bfloat16))
    out["matmul_bwd_rel"] = [
        ((a.float() - b.float()).norm() / b.float().norm()).item()
        for a, b in zip((x.grad, w.grad), exact)]
    del params, tokens, kernel_grads, w, x, g, exact
    torch.cuda.empty_cache()

    L = TRAIN.depth
    rel_tol = BWD_TILE_REL[torch.bfloat16]
    err = [max(row[i] for row in out["layers"]) for i in range(3)]
    log(f"[train] K4/K5 in each of {len(out['layers'])} layers against the "
        f"plain backward on the layer's q, k, v, dO: largest tile-wise "
        f"relative error dq {err[0]:.3g}, dk {err[1]:.3g}, dv {err[2]:.3g} "
        f"(limit {rel_tol} {'holds' if max(err) <= rel_tol else 'FAILS'})")
    worst_grad = max(grad_err, key=grad_err.get)
    loss_rel = abs(out["loss"] - out["plain_loss"]) / abs(out["plain_loss"])
    log(f"[train] step [{TRAIN_BATCH},{TRAIN.seq}] at {L} layers: "
        f"{out['step_s']:.3f} s, loss {out['loss']:.6f} (plain attention "
        f"{out['plain_loss']:.6f}, relative {loss_rel:.3g}); gradients vs "
        f"plain attention, norm-wise relative error: max "
        f"{grad_err[worst_grad]:.4g} ({worst_grad}), median "
        f"{statistics.median(grad_err.values()):.4g}; launches K3/K4/K5 "
        f"{out['launches']}; peak {out['transient_bytes'] / GiB:.2f} GiB "
        f"above the parameters; _matmul_f32 backward vs exact f32 products "
        f"dx {out['matmul_bwd_rel'][0]:.3g}, dw {out['matmul_bwd_rel'][1]:.3g}"
        " norm-wise")
    if max(err) > rel_tol or len(out["layers"]) != L:
        raise AssertionError(f"K4/K5 at the LM's layers: {out['layers']}")
    if out["launches"] != [2 * L, L, L] or \
            out["wgmma_launches"] != [2 * L, L, L]:
        raise AssertionError(f"one step launched K3/K4/K5 "
                             f"{out['launches']}, not {[2 * L, L, L]} (by "
                             f"the wgmma route: {out['wgmma_launches']})")
    if loss_rel > 1e-3 or grad_err[worst_grad] > GRAD_REL:
        raise AssertionError(f"the kernel step vs the plain step: loss "
                             f"relative {loss_rel}, gradients {grad_err}")
    if max(out["matmul_bwd_rel"]) > MATMUL_BWD_REL:
        raise AssertionError(f"_matmul_f32 backward {out['matmul_bwd_rel']}")
    return out


def train_state_sizes(cfg: Transformer) -> tuple:
    """(parameter count, bytes of each f32 parameter and momentum block)
    of one trainer at ``cfg``."""
    params, opt = init_lm_state(cfg, device="meta")
    sizes = [x.numel() * x.element_size()
             for x in (*params.values(), *opt["m"].values())]
    return sum(x.numel() for x in params.values()), sizes


def pinned_of(sizes) -> int:
    """Pinned host bytes of ``sizes``: PyTorch's pinned allocator rounds
    each block up to a power of two."""
    return sum(1 << (n - 1).bit_length() for n in sizes)


def size_train_pair(budget: int, physical: int, transient: int) -> dict:
    """The training pair's sizes and budget. Each tenant holds f32
    parameters and momentum; a step adds ``transient`` bytes (gradients,
    activations, logits: measured by check_lm_training) that the arena
    does not reserve, so both tenants get the arena's default ``budget``
    (physical memory less the reserve) less that transient. Raises if
    both tenants' pinned shadows (power-of-two rounding included) do not
    fit in MemAvailable less the headroom, if a tenant's step beside the
    other's state would fit in the card (the pair must page at every
    handoff), or if one tenant's state does not fit the budget."""
    n_params, sizes = train_state_sizes(TRAIN)
    wss = sum(sizes)
    pinned = pinned_of(sizes)
    # The update's one temporary (lr * m of the largest parameter) on top.
    budget = budget - transient - max(sizes)
    avail, waited = settled_mem_available()
    log(f"[train] GPT-3 6.7B widths at {TRAIN.depth} layers: "
        f"{n_params / 1e9:.3f} B parameters; per tenant {wss / GiB:.2f} "
        f"GiB of parameters and momentum on the card, {pinned / GiB:.2f} "
        f"GiB of pinned shadows; a step adds {transient / GiB:.2f} GiB -> "
        f"budget {budget / GiB:.2f} GiB of {physical / GiB:.2f} GiB; step "
        f"beside the other tenant's state {(2 * wss + transient) / GiB:.2f}"
        f" GiB = {(2 * wss + transient) / physical:.4f}x the card; pinned "
        f"pair {2 * pinned / GiB:.2f} GiB against MemAvailable "
        f"{avail / GiB:.2f} GiB (settled in {waited:.0f} s) less "
        f"{HOST_HEADROOM / GiB:.0f} GiB headroom")
    if 2 * pinned > avail - HOST_HEADROOM:
        raise RuntimeError(
            f"host memory cannot hold both training tenants' pinned shadows "
            f"(2 x {pinned / GiB:.2f} GiB) at {TRAIN.depth} layers")
    if 2 * wss + transient <= physical:
        raise RuntimeError("a training step beside the other tenant's state "
                           "fits in the card; the pair must oversubscribe it")
    if wss >= budget:
        raise RuntimeError(f"one tenant's state ({wss / GiB:.2f} GiB) does "
                           f"not fit its budget ({budget / GiB:.2f} GiB)")
    return {"params": n_params, "wss_bytes": wss, "pinned_bytes": pinned,
            "budget": budget}


def train_workload(steps: int, cfg: Transformer = None):
    return lm_train_workload(cfg or TRAIN, steps=steps, batch=TRAIN_BATCH,
                             lr=TRAIN_LR, seed=TRAIN_SEED)


def measure_train(budget: int) -> dict:
    """One training tenant's step time (the second of two steps) and one
    warm handoff cycle of its parameters and momentum. Both halves are
    dirty after every step, so this is what each training handoff
    moves."""
    def make_set(a):
        params, opt = vmem.vop(lambda dev: init_lm_state(
            TRAIN, TRAIN_SEED, device=dev))(a.device)
        return [*params.values(), *opt["m"].values()]

    out = probe_tenant("train-probe", budget, make_set, train_workload(2))
    return dict(out, step_s=out.pop("result").step_s[-1])


def train_solo_fault(solo):
    if solo.passed and solo.losses[-1] < solo.losses[0]:
        return None
    return f"losses {solo.losses}, checksum {solo.checksum}"


def run_train(budget: int, sched: Scheduler, steps: int, tq: int) -> dict:
    """The training pair: a solo tenant, then two co-located tenants, each
    holding its parameters and momentum in its own arena. Every co-located
    loss and the final checksum must equal the solo run's bit for bit;
    the solo run's losses must be finite and its last below its first."""
    log(f"[train] {steps} steps per tenant, TQ {tq} s, lr {TRAIN_LR}")
    res = run_pair(
        "train", budget, sched, lambda: train_workload(steps),
        train_solo_fault,
        lambda r, s: None if (r.losses, r.checksum) == (s.losses, s.checksum)
        else f"losses {r.losses} checksum {r.checksum!r} != solo "
             f"{s.losses} {s.checksum!r}")
    solo = res["solo"]
    step_s = statistics.median(solo.step_s)
    log(f"[train] solo median step {step_s:.3f} s; losses "
        f"{solo.losses[0]:.5f} -> {solo.losses[-1]:.5f}; all {steps} losses "
        f"and the checksum {solo.checksum!r} equal solo in both tenants")
    res.update(steps=steps, tq_s=tq, step_s=step_s, losses=solo.losses)
    return res


def train_phases(phases: Phases, budget: int, physical: int,
                 sched: Scheduler) -> dict:
    """The training phases: the full-width training check, the pair's
    sizing, the step time and handoff cycle that set the quantum and the
    number of steps, then the main path with K3, K4 and K5 counted."""
    release_host_cache()
    check = phases.run("check lm training", check_lm_training)
    release_host_cache()
    sizes = size_train_pair(budget, physical, check["transient_bytes"])
    budget = sizes["budget"]
    probe = phases.run("train handoff cycle", measure_train, budget)
    tq = max(2, math.ceil(3.0 * probe["cycle_s"]))
    sched.set_tq(tq)
    steps = max(3, math.ceil(PAIR_QUANTA * tq / probe["step_s"]) + 2)
    log(f"[train] handoff cycle {probe['cycle_s']:.3f} s "
        f"({sizes['wss_bytes'] / GiB:.2f} GiB out and back) -> TQ {tq} s; "
        f"step {probe['step_s']:.3f} s -> {steps} steps")
    wrappers = (flash_attention, flash_backward_dq, flash_backward_dkv)
    reset_counts(*wrappers)
    res = phases.run("main path train", run_train, budget, sched, steps, tq)
    launches = [fn.launches.value for fn in wrappers]
    res["wgmma_launches"] = [fn.route_launches[WGMMA].value
                             for fn in wrappers]
    runs = 3 * steps  # solo + two co-located tenants
    want = [2 * TRAIN.depth * runs, TRAIN.depth * runs, TRAIN.depth * runs]
    if launches != want:
        raise AssertionError(f"K3/K4/K5 launched {launches} times on the "
                             f"training path, not {want}")
    res.update(launches=launches, cycle_s=probe["cycle_s"], check=check,
               **sizes)
    return res


# -- QoS arbitration ---------------------------------------------------------

QOS_SPECS = {"inter": "interactive:2", "batch": "batch:1"}
QOS_ENV = {"TPUSHARE_FLEET": "1", "TPUSHARE_RELEASE_CHECK_S": "30"}
# The server's requests in each leg (the LM pair's first ones; the pair
# brings 9 on the H100): ~7 s of serving beside the trainer's ~13 s, so
# the trainer still holds the card when the server asks for it.
QOS_REQUESTS = 4
FLEET_POLL_S = 0.5


def size_qos_pair(lm: dict, train: dict) -> dict:
    """Both tenants' pinned shadows at once (the LM's parameters and
    cache, the trainer's parameters and momentum) against MemAvailable
    less the headroom. Where they do not fit, the trainer's depth is cut
    a layer at a time, never a width; raises if no depth fits."""
    avail, waited = settled_mem_available()
    room = avail - HOST_HEADROOM - lm["pinned_bytes"]
    depth = TRAIN.depth
    while depth > 1 and pinned_of(train_state_sizes(
            replace(TRAIN, depth=depth))[1]) > room:
        depth -= 1
    train_pinned = pinned_of(train_state_sizes(
        replace(TRAIN, depth=depth))[1])
    pinned = lm["pinned_bytes"] + train_pinned
    log(f"[qos] pinned shadows {lm['pinned_bytes'] / GiB:.2f} GiB (inter) "
        f"+ {train_pinned / GiB:.2f} GiB (batch, {depth} layers) = "
        f"{pinned / GiB:.2f} GiB against MemAvailable {avail / GiB:.2f} "
        f"GiB (settled in {waited:.0f} s) less {HOST_HEADROOM / GiB:.0f} "
        f"GiB headroom; working sets {lm['wss_bytes'] / GiB:.2f} + "
        f"{train['wss_bytes'] / GiB:.2f} GiB at {TRAIN.depth} layers")
    if train_pinned > room:
        raise RuntimeError("host memory cannot hold both QoS tenants' "
                           "pinned shadows at any depth of the trainer")
    if depth < TRAIN.depth:
        log(f"[qos] the trainer is cut from {TRAIN.depth} to {depth} "
            "layers so that both pinned sets fit (widths unchanged)")
    return {"pinned_bytes": pinned, "mem_available": avail,
            "train_depth": depth}


def run_train_solo(cfg: Transformer, budget: int, steps: int) -> dict:
    """A solo run of the trainer at ``cfg`` (the QoS pair's, where its
    depth was cut): the result its co-located runs must equal."""
    t = Tenant(f"qos-train-solo-{cfg.depth}", budget_bytes=budget,
               pool=vmem.PhysicalPool(budget))
    try:
        t0 = time.time()
        res = t.run(train_workload(steps, cfg))
        wall = time.time() - t0
    finally:
        t.close()
    fault = train_solo_fault(res)
    if fault:
        raise AssertionError(f"QoS trainer solo at {cfg.depth} layers: "
                             f"{fault}")
    log(f"[qos] trainer solo at {cfg.depth} layers: {wall:.2f} s, losses "
        f"{res.losses[0]:.5f} -> {res.losses[-1]:.5f}")
    return {"solo": res, "solo_s": wall}


def scrape_metrics(url: str, names) -> dict:
    """One GET of the exporter: the tpushare_lock_* series of each of
    ``names``; raises if the scrape fails or a tenant has none."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as r:
        text = r.read().decode()
    series = {n: [ln.split(" ")[0] for ln in text.splitlines()
                  if ln.startswith("tpushare_lock_")
                  and f'client="{n}"' in ln] for n in names}
    missing = [n for n, ss in series.items() if not ss]
    if missing:
        raise AssertionError(f"/metrics carries no tpushare_lock_* series "
                             f"for {missing}")
    return {n: len(ss) for n, ss in series.items()}


class FleetPoller:
    """Polls the leg's scheduler for the fleet trace every FLEET_POLL_S
    (the replay ring drains on read), and once both tenants have been
    granted runs ``on_both_granted`` (the WFQ leg's scrape and ``top``)."""

    def __init__(self, sock: str, names, on_both_granted=None):
        from nvshare_tpu_torch.telemetry.fleet import FleetCollector

        self.collector = FleetCollector(sock_path=sock)
        self.names = list(names)
        self.on_both_granted = on_both_granted
        self.hook_out = None
        self.error = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="fleet-poller")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(FLEET_POLL_S):
            try:
                self.collector.poll()
                rows = self.collector.tenants
                if (self.on_both_granted is not None
                        and self.hook_out is None
                        and all((rows.get(n, {}).get("grants") or 0) >= 1
                                for n in self.names)):
                    self.hook_out = self.on_both_granted()
            except Exception as e:  # kept and raised by stop()
                self.error = e
                return

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=60)
        if self.error is not None:
            raise self.error
        self.collector.poll()  # the tail


def run_top(sock_dir: str) -> str:
    out = subprocess.run(
        [sys.executable, "-m", "nvshare_tpu_torch.telemetry.top", "--once",
         "--plain"], cwd=REPO, capture_output=True, text=True, timeout=60,
        env=dict(os.environ, TPUSHARE_SOCK_DIR=sock_dir))
    if out.returncode != 0:
        raise RuntimeError(f"top failed: {out.stderr}")
    return out.stdout


def qos_leg(policy: str, lm: dict, train: dict, pool_bytes: int,
            tq: int) -> dict:
    """One leg of the QoS pair under a private scheduler started with
    TPUSHARE_QOS_POLICY=``policy``: the LM server (interactive:2) beside
    the trainer (batch:1), each with its earlier phase's budget and
    counts, the fleet plane on. Every checksum, token, loss and the final
    state sum must equal the earlier phases' solo runs; the live policy
    must be the one asked for; the merged trace must hold both tenants'
    lock spans. In the WFQ leg, /metrics is scraped once and ``top`` run
    once while both tenants are live."""
    from nvshare_tpu_torch.qos import entitled_shares, parse_qos
    from nvshare_tpu_torch.qos.report import build_report, \
        lock_spans_by_tenant
    from nvshare_tpu_torch.telemetry import fleet
    from nvshare_tpu_torch.telemetry.dump import fetch_sched_stats

    names = {role: f"{role}-{policy}" for role in QOS_SPECS}
    sock_dir = tempfile.mkdtemp(prefix=f"tpushare-qos-{policy}-")
    sched = Scheduler(sock_dir, tq=tq, env={"TPUSHARE_QOS_POLICY": policy})
    env = dict(QOS_ENV, TPUSHARE_SOCK_DIR=sock_dir)
    if policy == "wfq":
        env["TPUSHARE_METRICS_PORT"] = "0"
    sock = str(Path(sock_dir) / "scheduler.sock")
    tenants, poller, server = {}, None, None
    try:
        with mock.patch.dict(os.environ, env):
            pool = vmem.PhysicalPool(pool_bytes)
            tenants["inter"] = Tenant(names["inter"],
                                      budget_bytes=lm["budget"], pool=pool,
                                      qos=QOS_SPECS["inter"])
            tenants["batch"] = Tenant(names["batch"],
                                      budget_bytes=train["budget"],
                                      pool=pool, qos=QOS_SPECS["batch"])
            hook = None
            if policy == "wfq":
                server = telemetry.maybe_start_from_env()
                if server is None:
                    raise RuntimeError("TPUSHARE_METRICS_PORT=0 started no "
                                       "exporter")

                def hook():
                    return {"metrics": scrape_metrics(server.url,
                                                      names.values()),
                            "top": run_top(sock_dir)}
            poller = FleetPoller(sock, names.values(), hook)
            report = run_colocated(
                {tenants["inter"]: lm_workload_of(lm["qos_requests"]),
                 tenants["batch"]: train_workload(train["steps"],
                                                  train["cfg"])},
                timeout_s=900)
            stats = fetch_sched_stats(path=sock)
            fleet.reset_streamer()  # its last push carries the tail
            poller.stop()
            revocations = re.findall(REVOKED + r"[^\n]*", sched.text())
    finally:
        if poller is not None:
            poller._stop.set()
        for t in tenants.values():
            t.close()
        fleet.reset_streamer()
        if server is not None:
            server.close()
        sched.stop()
        shutil.rmtree(sock_dir, ignore_errors=True)
    if not report.ok:
        raise RuntimeError(f"[qos {policy}] tenants failed: {report.errors}")
    why = lm_differs(report.results[names["inter"]], lm["solo"],
                     lm["qos_requests"])
    if why:
        raise AssertionError(f"[qos {policy}] inter: {why}")
    got, want = report.results[names["batch"]], train["solo"]
    if (got.losses, got.checksum) != (want.losses, want.checksum):
        raise AssertionError(f"[qos {policy}] batch: losses {got.losses} "
                             f"checksum {got.checksum!r} != solo "
                             f"{want.losses} {want.checksum!r}")
    live = stats["summary"].get("qpol")
    if live != policy:
        raise AssertionError(f"[qos {policy}] live policy {live!r}")
    # The streamer's first push replays the ring from earlier phases too:
    # keep the scheduler's instants and this leg's tenants.
    trace = fleet.merge_trace(
        [fr for fr in poller.collector.aligned_events()
         if fr.get("sender") == "sched" or fr.get("who") in names.values()],
        clock_offsets=poller.collector.offsets)
    spans = lock_spans_by_tenant(trace)
    for n in names.values():
        if not spans.get(n):
            raise AssertionError(f"[qos {policy}] the merged trace has no "
                                 f"lock span of {n}")
    specs = {names[r]: parse_qos(s) for r, s in QOS_SPECS.items()}
    qrep = build_report(trace, specs)
    rows = {c.get("client"): c for c in stats["clients"]}
    occ = {r: rows.get(names[r], {}).get("occ_pm") or 0 for r in QOS_SPECS}
    total_occ = sum(occ.values()) or 1
    entitled = entitled_shares({names[r]: parse_qos(s).weight
                                for r, s in QOS_SPECS.items()})
    waits = {r: [float(e.args["seconds"]) for e in tev.ring().snapshot()
                 if e.kind == tev.GATE_WAIT and e.who == names[r]]
             for r in QOS_SPECS}
    hs = fleet.handoff_summaries(trace)

    def med(key):
        return statistics.median(h[key] for h in hs) if hs else None

    # The server's solo: the LM pair's solo wall less its later requests.
    sr = lm["solo"]
    solo_s = {"inter": lm["solo_s"] - sum(
        sr.score_s[lm["qos_requests"]:] + sr.decode_s[lm["qos_requests"]:]),
        "batch": train["solo_s"]}
    leg = {
        "policy": policy, "policy_live": live,
        "qos_preempts": stats["summary"].get("qpre", 0),
        "revocations": len(revocations),
        "occ_share": {r: round(occ[r] / total_occ, 4) for r in QOS_SPECS},
        "entitled_share": {r: round(entitled[names[r]], 4)
                           for r in QOS_SPECS},
        "trace_share": {r: qrep["tenants"][names[r]]["achieved_share"]
                        for r in QOS_SPECS},
        "gate_wait_p50_s": {r: percentile(w, 50) if w else None
                            for r, w in waits.items()},
        "gate_wait_p99_s": {r: percentile(w, 99) if w else None
                            for r, w in waits.items()},
        "gate_waits": {r: len(w) for r, w in waits.items()},
        "handoffs": len(hs), "writeback_median_s": med("writeback_s"),
        "wire_median_s": med("wire_s"), "pagein_median_s": med("pagein_s"),
        "makespan_s": report.makespan_s,
        "walls_s": {r: report.walls[names[r]] for r in QOS_SPECS},
        "solo_s": solo_s,
        "ratio": report.makespan_s / sum(solo_s.values()),
        "trace_events": len(poller.collector.events),
    }
    leg["share_error"] = {r: round(leg["occ_share"][r]
                                   - leg["entitled_share"][r], 4)
                          for r in QOS_SPECS}
    leg["line"] = (
        f"[qos {policy}] live policy {live}, qos preempts "
        f"{leg['qos_preempts']}, lease revocations {len(revocations)}; "
        f"occupancy (occ_pm) {leg['occ_share']} "
        f"against entitled {leg['entitled_share']}, from the merged trace "
        f"{leg['trace_share']}; gate wait p50 {leg['gate_wait_p50_s']} s, "
        f"p99 {leg['gate_wait_p99_s']} s over the waits "
        f"{ {r: [round(x, 4) for x in w] for r, w in waits.items()} } s; "
        f"{len(hs)} handoffs, median writeback {leg['writeback_median_s']}"
        f" s, wire {leg['wire_median_s']} s, page-in "
        f"{leg['pagein_median_s']} s; makespan {report.makespan_s:.2f} s "
        f"against solos {solo_s['inter']:.2f} + {solo_s['batch']:.2f} s "
        f"({leg['ratio']:.4f}); every checksum, token, loss and the state "
        "sum equal solo")
    log(leg["line"])
    # A revocation grants the peer while the revoked tenant may still hold
    # its working set on the card (PERF.md §7): with the grace fixed above
    # a first handoff, none may happen.
    if revocations:
        raise AssertionError(f"[qos {policy}] the scheduler revoked a lock "
                             f"{len(revocations)} times: {revocations}")
    if poller.hook_out is not None:
        leg["metrics_series"] = poller.hook_out["metrics"]
        log(f"[qos {policy}] /metrics tpushare_lock_* series per tenant "
            f"{leg['metrics_series']}; top --once --plain:\n"
            + poller.hook_out["top"].rstrip())
    elif policy == "wfq":
        raise AssertionError("[qos wfq] the scrape and top never ran: a "
                             "tenant was never granted during the leg")
    return leg


def qos_phase(lm: dict, train: dict, pool_bytes: int) -> dict:
    """The QoS pair, FIFO then WFQ, at the TQ the LM pair's probe
    picked."""
    release_host_cache()
    sizes = size_qos_pair(lm, train)
    cfg = replace(TRAIN, depth=sizes["train_depth"])
    train = dict(train, cfg=cfg)
    if cfg.depth < TRAIN.depth:
        train.update(run_train_solo(cfg, train["budget"], train["steps"]))
    tq = lm["tq_s"]
    lm = dict(lm, qos_requests=min(QOS_REQUESTS, lm["requests"]))
    log(f"[qos] specs {QOS_SPECS}, TQ {tq} s, lease grace {LEASE_GRACE_S} s, "
        f"env {json.dumps(QOS_ENV)}; "
        f"inter: {lm['qos_requests']} requests, budget "
        f"{lm['budget'] / GiB:.2f} GiB; batch: {train['steps']} steps at "
        f"{cfg.depth} layers, "
        f"budget {train['budget'] / GiB:.2f} GiB; pool "
        f"{pool_bytes / GiB:.2f} GiB")
    legs = {p: qos_leg(p, lm, train, pool_bytes, tq)
            for p in ("fifo", "wfq")}
    f50 = legs["fifo"]["gate_wait_p50_s"]["inter"]
    w50 = legs["wfq"]["gate_wait_p50_s"]["inter"]
    ratio = w50 / f50 if f50 and w50 is not None else None
    within = all(abs(e) <= 0.10
                 for e in legs["wfq"]["share_error"].values())
    line = (f"[qos] interactive gate-wait p50 WFQ/FIFO {ratio} (over "
            f"{legs['fifo']['gate_waits']['inter']} and "
            f"{legs['wfq']['gate_waits']['inter']} waits); WFQ within 10% "
            f"of entitlement: {within}")
    log(line)
    return dict(legs, tq_s=tq, p50_ratio_wfq_fifo=ratio, line=line,
                inter_requests=lm["qos_requests"],
                wfq_within_entitlement_10pct=within, **sizes)


# -- process tenants: an oversubscribing pair, native client and chaos link --

# Each process's working set, as a fraction of the card, so that the pair
# oversubscribes it: the reference's tf-matmul beside pytorch-add. Cut
# only by host memory (PROC_HOST_HEADROOM), never below a pair of 1.0x.
PROC_WSS_FRACTION = 0.53
PROC_KINDS = {"nat": "matmul", "cha": "add"}
PROC_WORK_S = 2.5            # burner seconds a tenant brings
# Two handoff cycles of the working set (1.0-1.2 s each way at ~42 GiB on
# this card): each quantum pages the set in and does ~3 s of work. A
# burner run holds the lock ~9 s besides its steps (making and paging
# its set), so 2.5 s of steps span three quanta or more (three handoffs
# a tenant on the H100) and each tenant is dropped at least twice. The
# pair checks the release and exactness; its ratio is not a yardstick at
# this quantum.
PROC_TQ = 4
# Host memory a tenant process adds besides its pinned shadows, on top
# of HOST_HEADROOM: 0.6 GiB measured on the H100 host (its libraries'
# pages are this process's, already charged).
PROC_OVERHEAD = 1 * GiB
# Reserved device memory a process may keep after a handoff released its
# arena's blocks: its tensors outside the arena (none for a burner).
RELEASE_FLOOR = 2 * CHUNK_BYTES
# The chaos link: the reference chaos soak's fault schedule, and its
# lost-frame insurance (a REQ_LOCK re-sent after 1 s at the gate).
PROC_CHAOS_ENV = {"TPUSHARE_PURE_PYTHON": "1",
                  "TPUSHARE_CHAOS": "drop:0.04,seed:11",
                  "TPUSHARE_REQ_RETRY_S": "1",
                  "TPUSHARE_RECONNECT": "1", "TPUSHARE_RECONNECT_S": "1"}
# --pre-repair: the tenant with its handoffs' release taken out, as the
# arena was before it returned freed blocks to the card (this script's
# flag, not the package's).
PRE_REPAIR_TENANT = (
    "import sys\n"
    "from nvshare_tpu_torch import vmem\n"
    "vmem.VirtualHBM._release_to_device = lambda self: None\n"
    "from nvshare_tpu_torch.bench_tenant import main\n"
    "sys.exit(main(sys.argv[1:]))\n")


def start_proc(name: str, cmd: list, env: dict):
    """A child process of this repo's Python with ``env`` added, its
    output kept for :func:`collect_proc`."""
    return subprocess.Popen(
        [sys.executable, "-u", "-X", "faulthandler", *cmd], cwd=REPO,
        env=dict(os.environ, **env, TPUSHARE_JOB_NAME=name),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def start_tenant_proc(name: str, args: list, env: dict,
                      pre_repair: bool = False):
    cmd = (["-c", PRE_REPAIR_TENANT] if pre_repair
           else ["-m", "nvshare_tpu_torch.bench_tenant"])
    return start_proc(name, [*cmd, name, *map(str, args)], env)


def collect_proc(name: str, proc, timeout_s: float) -> dict:
    """The process's RESULT, once it has exited 0. A process that outlives
    ``timeout_s`` is sent SIGABRT, so that its faulthandler prints every
    thread's stack into the kept log."""
    CHILD_LOGS.mkdir(parents=True, exist_ok=True)
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGABRT)
        out, _ = proc.communicate(timeout=60)
        (CHILD_LOGS / f"{name}.log").write_text(out)
        raise RuntimeError(f"{name} timed out:\n{out[-4000:]}")
    (CHILD_LOGS / f"{name}.log").write_text(out)
    if proc.returncode != 0:
        raise RuntimeError(f"{name} exited {proc.returncode}:\n"
                           f"{out[-4000:]}")
    for line in out.splitlines():
        if line.startswith(f"{name} RESULT "):
            return json.loads(line.split(" RESULT ", 1)[1])
    raise RuntimeError(f"{name} printed no RESULT:\n{out[-4000:]}")


def stop_procs(procs) -> None:
    for pr in procs:
        if pr.poll() is None:
            pr.terminate()
            try:
                pr.wait(timeout=60)
            except subprocess.TimeoutExpired:
                pr.kill()
                pr.wait()


def host_charged() -> int:
    """Host memory charged to this job: its cgroup's ``memory.current``
    where the machine has one, else MemTotal less MemAvailable."""
    cg = Path("/sys/fs/cgroup/memory.current")
    if cg.exists():
        return int(cg.read_text())
    return meminfo("MemTotal") - mem_available()


class HostPeak:
    """The most host memory charged (:func:`host_charged`) while a block
    runs, sampled every 0.5 s on a thread of its own."""

    def __enter__(self):
        self.peak = host_charged()
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()
        return self

    def _run(self):
        while not self._stop.wait(0.5):
            self.peak = max(self.peak, host_charged())

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(timeout=5)


def size_proc_pair(physical: int) -> int:
    """Chunks a process: PROC_WSS_FRACTION of the card, cut only by host
    memory (both processes' pinned shadows at once, against MemAvailable
    less HOST_HEADROOM and both processes' own PROC_OVERHEAD). Raises
    where the pair would not exceed the card."""
    release_host_cache()  # the earlier pairs' pinned shadows
    avail, waited = settled_mem_available()
    room = avail - HOST_HEADROOM - 2 * PROC_OVERHEAD
    chunks = int(min(PROC_WSS_FRACTION * physical, room / 2)
                 // CHUNK_BYTES)
    wss = chunks * CHUNK_BYTES
    limit = Path("/sys/fs/cgroup/memory.max")
    log(f"[proc] host memory charged {host_charged() / GiB:.2f} GiB, "
        f"limit {limit.read_text().strip() if limit.exists() else '-'}; "
        f"MemAvailable {avail / GiB:.2f} GiB (settled in "
        f"{waited:.0f} s) less {HOST_HEADROOM / GiB:.0f} GiB headroom and "
        f"2 x {PROC_OVERHEAD / GiB:.0f} GiB a process: {chunks} chunks "
        f"({wss / GiB:.2f} GiB, {wss / physical:.4f} of the card) a "
        f"process, the pair {2 * wss / physical:.4f}x the card's "
        f"{physical / GiB:.2f} GiB")
    if 2 * wss <= physical:
        raise RuntimeError(
            f"host memory holds pinned shadows for a process pair of only "
            f"{2 * wss / physical:.4f}x the card's memory; the pair must "
            "oversubscribe the card")
    return chunks


def proc_args(kind: str, chunks: int, step_s: dict, base_chunks: int
              ) -> list:
    """bench_tenant's arguments: PROC_WORK_S of burner steps of ``kind``
    at ``chunks`` (step time scaled from the main path's calibration at
    ``base_chunks``)."""
    steps = math.ceil(PROC_WORK_S * base_chunks / (step_s[kind] * chunks))
    return [kind, chunks * CHUNK_BYTES, steps, chunks, DEVICE_RATIO]


def run_proc_pair(chunks: int, args: dict, sock_dir: str,
                  pre_repair: bool = False) -> tuple:
    """``nat`` (the native client) and ``cha`` (the Python client over
    the chaos link) started together; their RESULTs, the makespan and the
    scheduler's log."""
    env = {"TPUSHARE_SOCK_DIR": sock_dir,
           "TPUSHARE_LIB_DIR": str(SCHED_DIR),
           "TPUSHARE_METRICS_TEXTFILE": str(Path(sock_dir) / "{job}.prom")}
    envs = {"nat": env, "cha": dict(env, **PROC_CHAOS_ENV)}
    sched = Scheduler(sock_dir, tq=PROC_TQ)
    procs = {}
    try:
        t0 = time.time()
        with HostPeak() as host:
            procs = {n: start_tenant_proc(n, args[n], envs[n], pre_repair)
                     for n in PROC_KINDS}
            res, failed = {}, {}
            for n, pr in procs.items():
                try:
                    res[n] = collect_proc(n, pr, 300)
                except RuntimeError as e:
                    failed[n] = str(e)
        makespan = time.time() - t0
        log(f"[proc] host memory charged at most {host.peak / GiB:.2f} GiB "
            "while the pair ran")
        return res, failed, makespan, sched.text()
    finally:
        stop_procs(procs.values())
        sched.stop()


def proc_phase(physical: int, step_s: dict, base_chunks: int) -> dict:
    """Two OS-process tenants whose working sets together exceed the
    card: ``nat`` runs the matmul burner (K2) through the native client,
    ``cha`` the add burner (K1) through the Python client over a chaos
    link, both on their process arena, under a private scheduler at
    PROC_TQ. First a solo process of each. Both checksums must equal
    their solo's; both must be handed off at least twice, each handoff
    releasing the arena's blocks so that the process keeps at most
    RELEASE_FLOOR reserved; ``nat`` must report a NativeClient; ``cha``'s
    link must have dropped a frame; each tenant's metrics textfile must
    carry its own tpushare_lock_* series; no lease is revoked but for a
    frame the chaos link dropped."""
    chunks = size_proc_pair(physical)
    args = {n: proc_args(k, chunks, step_s, base_chunks)
            for n, k in PROC_KINDS.items()}
    log(f"[proc] TQ {PROC_TQ} s, lease grace {LEASE_GRACE_S} s; nat "
        f"{args['nat']}, cha {args['cha']} (kind, WSS bytes, steps, "
        f"chunks, device ratio); cha env {json.dumps(PROC_CHAOS_ENV)}")
    sock_dir = tempfile.mkdtemp(prefix="tpushare-proc-")
    try:
        solo, solo_s = {}, {}
        env = {"TPUSHARE_SOCK_DIR": sock_dir,
               "TPUSHARE_LIB_DIR": str(SCHED_DIR)}
        sched = Scheduler(sock_dir, tq=PROC_TQ)
        try:
            for n in PROC_KINDS:
                t0 = time.time()
                solo[n] = collect_proc(f"solo-{n}", start_tenant_proc(
                    f"solo-{n}", args[n], env), 600)
                solo_s[n] = time.time() - t0
        finally:
            sched.stop()
        res, failed, makespan, log_text = run_proc_pair(chunks, args,
                                                        sock_dir)
        proms = {n: (Path(sock_dir) / f"{n}.prom").read_text()
                 for n in res}
    finally:
        shutil.rmtree(sock_dir, ignore_errors=True)
    if failed:
        raise AssertionError(f"[proc] tenants failed: {failed}")
    for name, r in res.items():
        if r["checksum"] != solo[name]["checksum"]:
            raise AssertionError(f"{name} checksum {r['checksum']!r} != "
                                 f"solo {solo[name]['checksum']!r}")
        if not any(ln.startswith("tpushare_lock_")
                   and f'client="{name}"' in ln
                   for ln in proms[name].splitlines()):
            raise AssertionError(f"{name}.prom lacks its tpushare_lock_* "
                                 "series")
        drops = len(re.findall(rf"DROP_LOCK -> {name} ", log_text))
        if r["handoffs"] < 2 or drops < 2:
            raise AssertionError(f"{name} was handed off {r['handoffs']} "
                                 f"times ({drops} DROP_LOCKs), not at "
                                 "least twice")
        if r["releases"] < r["handoffs"] or \
                r["reserved_after_release"] > RELEASE_FLOOR:
            raise AssertionError(
                f"{name}: {r['releases']} releases for {r['handoffs']} "
                f"handoffs, {r['reserved_after_release']} bytes still "
                f"reserved after one (floor {RELEASE_FLOOR})")
    if solo["nat"]["client"] != "NativeClient" or \
            res["nat"]["client"] != "NativeClient":
        raise AssertionError(f"nat ran {res['nat']['client']}, solo "
                             f"{solo['nat']['client']}: not the native "
                             "client")
    if res["cha"]["chaos"]["dropped"] < 1:
        raise AssertionError(f"cha's link dropped no frame: "
                             f"{res['cha']['chaos']}")
    # Only a frame the chaos link dropped (a LOCK_RELEASED lost on cha's
    # way out) may leave a grant to the lease police; nat's link is clean.
    revoked = re.findall(REVOKED + r" (\S+)", log_text)
    unexplained = [n for n in revoked if n != "cha"]
    if revoked.count("cha") > res["cha"]["chaos"]["dropped"]:
        unexplained += ["cha"]
    if unexplained:
        raise AssertionError(f"[proc] lease revocations {revoked} that no "
                             f"dropped frame explains: cha's link "
                             f"{res['cha']['chaos']}")
    wss = chunks * CHUNK_BYTES
    both = dict(res, **{f"solo-{n}": s for n, s in solo.items()})
    out = {"chunks": chunks, "wss_bytes": wss,
           "pair_x_card": 2 * wss / physical, "args": args,
           "solo_s": solo_s, "makespan_s": makespan,
           "ratio": makespan / sum(solo_s.values()),
           "walls_s": {n: r["wall_s"] for n, r in res.items()},
           "run_s": {n: r["run_s"] for n, r in both.items()},
           "clients": {n: r["client"] for n, r in res.items()},
           "chaos": res["cha"]["chaos"],
           "req_resends": res["cha"]["req_resends"], "revocations": revoked,
           "paging": {n: r["paging"] for n, r in res.items()},
           "handoffs": {n: r["handoffs"] for n, r in res.items()},
           "reserved_after_release": {
               n: r["reserved_after_release"] for n, r in res.items()},
           "k1_launches": {n: r["launches"]["fused_mix"]
                           for n, r in both.items()},
           "k2_launches": {n: r["launches"]["tiled_matmul"]
                           for n, r in both.items()}}
    out["line"] = (
        f"[proc] {chunks} chunks ({wss / GiB:.2f} GiB) a process, the pair "
        f"{out['pair_x_card']:.4f}x the card; clients {out['clients']}; "
        f"cha's chaos link {out['chaos']}, REQ_LOCK re-sends "
        f"{out['req_resends']}, lease revocations {revoked}; walls "
        f"{out['walls_s']} s (burner runs {out['run_s']} s), makespan "
        f"{makespan:.2f} s against solo processes {solo_s} s (ratio "
        f"{out['ratio']:.4f}); checksums equal solo; handoffs "
        f"{out['handoffs']}, reserved after each release at most "
        f"{ {n: round(b / GiB, 3) for n, b in out['reserved_after_release'].items()} } "
        f"GiB; K2 launches {out['k2_launches']}, K1 launches "
        f"{out['k1_launches']}")
    log(out["line"])
    return out


def pre_repair_phase(physical: int) -> dict:
    """The oversubscribing process pair with each handoff's release taken
    out of the tenants (PRE_REPAIR_TENANT): the peer's page-in must then
    fail with a device OOM, since the evicting process keeps its blocks
    reserved. Step times are the burner's at this size from the main
    path's calibration on an H100 (0.382 s matmul, 0.055 s add at 174
    chunks); the pair runs until the first failure."""
    chunks = size_proc_pair(physical)
    args = {n: proc_args(k, chunks, {"matmul": 0.382, "add": 0.055}, 174)
            for n, k in PROC_KINDS.items()}
    sock_dir = tempfile.mkdtemp(prefix="tpushare-prerepair-")
    try:
        res, failed, makespan, log_text = run_proc_pair(
            chunks, args, sock_dir, pre_repair=True)
    finally:
        shutil.rmtree(sock_dir, ignore_errors=True)
    ooms = {n: e for n, e in failed.items() if "out of memory" in e}
    log(f"[pre-repair] {chunks} chunks a process; finished {sorted(res)}, "
        f"failed {sorted(failed)} in {makespan:.2f} s; device OOM in "
        f"{sorted(ooms)}")
    for n, e in failed.items():
        log(f"[pre-repair] {n}: ...{e[-1500:]}")
    if not ooms:
        raise AssertionError("without the release no tenant ran out of "
                             "device memory")
    return {"chunks": chunks, "failed": sorted(failed),
            "oom": sorted(ooms), "makespan_s": makespan}


# -- unmodified programs: the dispatch-mode gate ------------------------------

# The unmodified LM trainer: GPT-3 6.7B widths (workloads/lm_train.py),
# cut to UNMOD_LAYERS of 32 layers so that its peak reserved memory and
# the MLP trainer's fit the card together (nothing of theirs pages). At
# 16 layers the LM's peak in the pair was 47.1-47.8 GiB (4.7-5.4 GiB
# above solo: the caching allocator refills after each release), and a
# layer adds 2.3 GiB (f32 parameters, momentum and gradients): 24 layers
# reach ~66 GiB, 28 would reach ~75 GiB of the ~77 GiB the MLP and two
# CUDA contexts leave.
UNMOD_LAYERS = 24
UNMOD_LM_STEPS = 10
UNMOD_UNGATED_STEPS = 3       # the ungated solo: the gate's host cost
UNMOD_MLP_STEPS = 400
UNMOD_MLP_BATCH = 1024


def start_workload(name: str, module: str, args: list, env: dict):
    return start_proc(name, ["-m", f"nvshare_tpu_torch.workloads.{module}",
                             "--name", name, *map(str, args)], env)


def check_gated_kernels(name: str, r: dict, layers: int, steps: int,
                        gated: bool) -> None:
    """K3 launched 2 x layers a step (forward and remat recompute), K4 and
    K5 layers a step, every launch by the wgmma route and, under the
    gate, every one in a gated unit."""
    want = {"flash_attention": 2 * layers * steps,
            "flash_backward_dq": layers * steps,
            "flash_backward_dkv": layers * steps}
    for kernel, n in want.items():
        got = r["kernels"][kernel]
        if (got["launches"], got["wgmma"], got["gated"]) != \
                (n, n, n if gated else 0):
            raise AssertionError(f"{name}: {kernel} {got}, want {n} "
                                 f"launches by the wgmma route, "
                                 f"{n if gated else 0} gated")


def unmod_phase() -> dict:
    """The unmodified pair: workloads/lm_train.py (GPT-3 6.7B widths at
    UNMOD_LAYERS) and workloads/mlp_train.py, each made a tenant by its
    one line (``import nvshare_tpu_torch.autoload``). Each alone under a
    private scheduler (the MLP also restored from its midpoint checkpoint
    and run on), the LM once more ungated (``TPUSHARE_DISABLE=1``), then
    both at once at a quantum of at least 3x the measured handoff. Every
    loss and state sum must equal solo bit for bit; both tenants must be
    granted and dropped at least twice; K3-K5 launched by the wgmma route
    at 2L/L/L a step, every launch gated."""
    sock_dir = tempfile.mkdtemp(prefix="tpushare-unmod-")
    ckpt = Path(sock_dir) / "ckpt"
    env = {"TPUSHARE_SOCK_DIR": sock_dir,
           "TPUSHARE_LIB_DIR": str(SCHED_DIR)}
    lm_args = ["--layers", UNMOD_LAYERS, "--steps", UNMOD_LM_STEPS]
    mlp_args = ["--steps", UNMOD_MLP_STEPS, "--batch", UNMOD_MLP_BATCH]
    procs: list = []
    try:
        sched = Scheduler(sock_dir, tq=30)
        try:
            lm = collect_proc("lm-solo", start_workload(
                "lm-solo", "lm_train", lm_args, env), 600)
            ungated = collect_proc("lm-ungated", start_workload(
                "lm-ungated", "lm_train",
                ["--layers", UNMOD_LAYERS, "--steps", UNMOD_UNGATED_STEPS],
                dict(env, TPUSHARE_DISABLE="1")), 600)
            mlp = collect_proc("mlp-solo", start_workload(
                "mlp-solo", "mlp_train", [*mlp_args, "--ckpt", ckpt], env),
                600)
            resumed = collect_proc("mlp-resumed", start_workload(
                "mlp-resumed", "mlp_train", [*mlp_args, "--resume", ckpt],
                env), 600)
        finally:
            sched.stop()
        # A handoff fences the work in flight (at most a step's) and
        # releases the freed blocks: the LM's step bounds it.
        lm_step = statistics.median(lm["step_s"][1:])
        tq = max(3, math.ceil(3.0 * lm_step))
        sched = Scheduler(sock_dir, tq=tq)
        try:
            t0 = time.time()
            procs = [start_workload("lm", "lm_train", lm_args, env),
                     start_workload("mlp", "mlp_train", mlp_args, env)]
            pair = {"lm": collect_proc("lm", procs[0], 900),
                    "mlp": collect_proc("mlp", procs[1], 900)}
            wall = time.time() - t0
            log_text = sched.text()
        finally:
            stop_procs(procs)
            sched.stop()
    finally:
        shutil.rmtree(sock_dir, ignore_errors=True)
    solo = {"lm": lm, "mlp": mlp}
    for name, r in pair.items():
        if r["losses"] != solo[name]["losses"] or \
                r["state_sum"] != solo[name]["state_sum"]:
            raise AssertionError(f"[unmod] {name} differs from solo: "
                                 f"losses {r['losses']} state sum "
                                 f"{r['state_sum']!r}, solo "
                                 f"{solo[name]['losses']} "
                                 f"{solo[name]['state_sum']!r}")
        if not r["gate"] or r["gated_ops"] <= 0:
            raise AssertionError(f"[unmod] {name} ran ungated: {r}")
        grants = len(re.findall(rf"LOCK_OK -> {name} ", log_text))
        drops = len(re.findall(rf"DROP_LOCK -> {name} ", log_text))
        if grants < 2 or drops < 2:
            raise AssertionError(f"[unmod] {name} granted {grants} and "
                                 f"dropped {drops} times, not at least "
                                 "twice each")
        handoff = r["release"]
        if handoff["handoffs"] < 2 or handoff["handoff_s_mean"] * 3.0 > tq:
            raise AssertionError(f"[unmod] {name}'s handoffs {handoff} "
                                 f"against TQ {tq} s")
    if REVOKED in log_text:
        raise AssertionError("[unmod] the scheduler revoked a lock")
    mid = UNMOD_MLP_STEPS // 2
    if resumed["start"] != mid or resumed["losses"] != mlp["losses"][mid:] \
            or resumed["state_sum"] != mlp["state_sum"]:
        raise AssertionError(f"[unmod] the MLP resumed from step "
                             f"{resumed['start']} differs from its "
                             f"uninterrupted run")
    if ungated["gate"] or ungated["gated_ops"] != 0 or \
            ungated["losses"] != lm["losses"][:UNMOD_UNGATED_STEPS]:
        raise AssertionError("[unmod] the ungated LM differs from the "
                             "gated one")
    for name, r, steps, gated in (("lm-solo", lm, UNMOD_LM_STEPS, True),
                                  ("lm", pair["lm"], UNMOD_LM_STEPS, True),
                                  ("lm-ungated", ungated,
                                   UNMOD_UNGATED_STEPS, False)):
        check_gated_kernels(name, r, UNMOD_LAYERS, steps, gated)
    # The training spans (from each state's creation; process start and
    # CUDA init left out): the pair's from the first begin to the last
    # end, against the two solo spans' sum.
    solo_run = {n: r["t_end"] - r["t_begin"] for n, r in solo.items()}
    span = (max(r["t_end"] for r in pair.values())
            - min(r["t_begin"] for r in pair.values()))
    gated_step = statistics.median(lm["step_s"][1:])
    plain_step = statistics.median(ungated["step_s"][1:])
    ops_step = lm["gated_ops"] / UNMOD_LM_STEPS
    out = {
        "layers": UNMOD_LAYERS, "lm_steps": UNMOD_LM_STEPS,
        "mlp_steps": UNMOD_MLP_STEPS, "mlp_batch": UNMOD_MLP_BATCH,
        "tq_s": tq,
        "solo_run_s": solo_run, "makespan_s": span,
        "ratio": span / sum(solo_run.values()), "wall_s": wall,
        "step_s_gated": gated_step, "step_s_ungated": plain_step,
        "gated_ops": {n: r["gated_ops"] for n, r in
                      dict(pair, **{"lm-solo": lm, "mlp-solo": mlp}).items()},
        "gated_ops_per_lm_step": ops_step,
        "gate_us_per_op": (gated_step - plain_step) / ops_step * 1e6,
        "peak_reserved": {n: r["peak_reserved"] for n, r in
                          dict(pair, **{"lm-solo": lm, "mlp-solo": mlp,
                                        "lm-ungated": ungated}).items()},
        "handoffs": {n: r["release"] for n, r in pair.items()},
        "grants_drops": {n: (len(re.findall(rf"LOCK_OK -> {n} ", log_text)),
                             len(re.findall(rf"DROP_LOCK -> {n} ",
                                            log_text))) for n in pair},
        "losses": {"lm": lm["losses"], "mlp_first_last": (
            mlp["losses"][0], mlp["losses"][-1])},
        "state_sum": {n: solo[n]["state_sum"] for n in solo},
        "launches": {n: r["kernels"] for n, r in
                     (("lm-solo", lm), ("lm", pair["lm"]),
                      ("lm-ungated", ungated))},
    }
    out["line"] = (
        f"[unmod] lm_train at {UNMOD_LAYERS} layers x {UNMOD_LM_STEPS} "
        f"steps beside mlp_train x {UNMOD_MLP_STEPS} steps (batch "
        f"{UNMOD_MLP_BATCH}): TQ {tq} s, training makespan {span:.2f} s "
        f"(processes {wall:.2f} s) against solo training spans "
        f"{out['solo_run_s']} s (ratio {out['ratio']:.4f}); "
        f"losses and state sums equal solo, the resumed MLP equal its "
        f"uninterrupted run; grants/drops {out['grants_drops']}; LM step "
        f"{gated_step:.4f} s gated, {plain_step:.4f} s ungated, "
        f"{ops_step:.0f} gated ops a step, gate cost "
        f"{out['gate_us_per_op']:.2f} us an op; peak reserved "
        f"{ {n: round((b or 0) / GiB, 2) for n, b in out['peak_reserved'].items()} } "
        f"GiB; handoffs {out['handoffs']}; K3/K4/K5 launches in the pair's "
        f"LM {[pair['lm']['kernels'][k]['gated'] for k in ('flash_attention', 'flash_backward_dq', 'flash_backward_dkv')]} "
        "gated, every one by the wgmma route")
    log(out["line"])
    return out


# -- parallel ranks ------------------------------------------------------------

# Ranks share the one card as processes under gloo (NCCL refuses two ranks
# on one device); every collective stages through pinned host buffers.
PAR_WORLD = 2
PAR_ATTN = [SCORE_BATCH, LM.seq, LM.heads, LM.head_dim]
PAR_RING_BLOCK = (SCORE_BATCH, LM.seq // PAR_WORLD, LM.heads, LM.head_dim)
# Depth: two f32 replicas of parameters, momentum and gradients (2.4 GiB a
# layer plus 2.5 GiB for the embedding) and the activations would fit 8
# layers (21.6 GiB a rank on an H100), but the time limit does not: the
# gradient all-reduce goes through gloo on the host at ~0.85 GB/s (7.3 GB
# took ~9 s a step at 8 layers, 52 s of the phase), so 2 layers.
PAR_LM = replace(TRAIN, depth=2, remat=True)
PAR_LM_STEPS = 2
PAR_MOE_LM = dict(vocab=LM.vocab, dim=LM.dim, heads=LM.heads, depth=1,
                  seq=LM.seq, rope=True, remat=True)   # experts 8, mlp 4
PAR_MOE_FFN = dict(experts=8, d=LM.dim, hidden=4 * LM.dim,
                   tokens=SCORE_BATCH * LM.seq)
PAR_PIPE = dict(stage="transformer", d=LM.dim, heads=LM.heads,
                xs_shape=[4, 1, LM.seq, LM.dim])
PAR_MLP = dict(model=dict(in_dim=1024, hidden_dim=4096, out_dim=256,
                          depth=4), batch=1024, steps=3)
PAR_TIMEOUT_S = 600
PAR_GATE_TIMEOUT_S = 300
PAR_GATE_TQ = 2
# Tolerances, each with its reason:
# - attention, tile by tile against reference_attention in f32 on the
#   same bf16 inputs: the ring rounds its f32 result to bf16 (2**-9 an
#   entry), Ulysses' wgmma kernels also round P and dS (K3_TILE_REL);
PAR_ATTN_TILE_REL = 1e-2
# - the sequence-parallel step against the same step at world 1: block
#   merges change f32 summation order, which flips a few bf16 roundings
#   downstream; against lm_train_step, whose attention is the bf16 wgmma
#   route (P rounded to bf16) where the ring's is f32;
PAR_LOSS_RTOL = {"world1": 1e-3, "lm_train_step": 5e-3}
PAR_M_RTOL = {"world1": 1e-2, "lm_train_step": 2e-2}
# - the MoE LM: each rank routes its own 4096 tokens with capacity 640,
#   one rank 8192 with capacity 1280, so other tokens are dropped;
PAR_MOE_LOSS_RTOL = 2e-2
# - the EP layer against the per-shard reference on the same card: the
#   experts' products run at other row counts (other cuBLAS tilings), so
#   a hidden activation may round one bf16 step apart;
PAR_MOE_REL = 1e-2
# - the pipeline's stage gradients against the sequential blocks': the
#   same bf16 products, microbatch gradients summed in another order;
PAR_PIPE_REL = 1e-3
# - dp x tp against one process: column shards are other cuBLAS calls.
PAR_MLP_LOSS_RTOL, PAR_MLP_REL = 1e-3, 2e-2


def par_lm_cases(prefix: str, world: int) -> list:
    model = {k: getattr(PAR_LM, k) for k in (
        "vocab", "dim", "heads", "depth", "seq", "rope", "remat")}
    base = dict(model=model, batch=TRAIN_BATCH, steps=PAR_LM_STEPS,
                seed=TRAIN_SEED, lr=TRAIN_LR)
    cases = [dict(base, name=f"{prefix}lm_{a}", case="seq_lm", attn=a)
             for a in ("ring", "ulysses")]
    moe = dict(model=PAR_MOE_LM, batch=TRAIN_BATCH, steps=1,
               seed=TRAIN_SEED)
    cases.append(dict(moe, name=f"{prefix}moe_lm", case="moe_lm"))
    if world == 1:
        cases += [dict(base, name="lm_train_step", case="lm_single"),
                  dict(moe, name="moe_lm_train_step",
                       case="moe_lm_single")]
    return cases


def check_f32_nan_rows(q, k, v, do, o, lse, causal: bool, g_lse) -> None:
    """A NaN reaches K3's, K4's and K5's outputs (f32 route) exactly where
    it reaches the plain versions': a NaN row of q (its scores, then P,
    are NaN) and of v (an operand of P v) in K3; a NaN row of q, one of
    dO, and key 0 of k, each alone, in K4; a NaN row of dO in K5. The NaN
    is written as 0x7fffffff, the one the card's arithmetic gives, whose
    rounding to TF32 would carry into the sign without the split's guard
    (csrc/tf32x3.cuh). The rows are chosen so that the plain versions and
    the tiled kernels reach the same outputs: q's row and dO's row in K4
    only their own dQ row, key 0 every dQ row of its (batch, head) (every
    causal row sees key 0), v's first row and dO's last every row of
    their (batch, head) in K3 and K5."""
    b, s, h, d = q.shape
    qn, kn, vn, don = q.clone(), k.clone(), v.clone(), do.clone()
    for x, at in ((qn, (1, 300, 5)), (kn, (3, 0, 2)), (vn, (2, 0, 7)),
                  (don, (1, s - 1, 5))):
        x[at].view(torch.int32).fill_(0x7FFFFFFF)

    def rows(*cells):
        want = torch.zeros((b, s, h, d), dtype=torch.bool, device="cuda")
        for at in cells:
            want[at] = True
        return want

    want_lse = torch.zeros((b * h, s), dtype=torch.bool, device="cuda")
    want_lse[1 * h + 5, 300] = True
    delta_n = attention_delta(o, don)
    args = (q, k, v, don, lse, delta_n, causal, g_lse)
    dq_cases = [(f"K4 ({name})", (x, y, z, w, lse, dl, causal, g_lse), want)
                for name, x, y, z, w, dl, want in (
                    ("q row", qn, k, v, do, attention_delta(o, do),
                     rows((1, 300, 5))),
                    ("dO row", q, k, v, don, delta_n, rows((1, s - 1, 5))),
                    ("key 0", q, kn, v, do, attention_delta(o, do),
                     rows((3, slice(None), 2))))]
    cases = [("K3", flash_attention_lse(qn, k, vn, causal=causal),
              flash_attention_reference(qn, k, vn, causal=causal),
              (rows((1, 300, 5), (2, slice(None), 7)), want_lse))]
    cases += [(what, (flash_backward_dq(*a),),
               (flash_backward_dq_reference(*a),), (want,))
              for what, a, want in dq_cases]
    want_kv = rows((1, slice(None), 5))
    cases.append(("K5", flash_backward_dkv(*args),
                  flash_backward_dkv_reference(*args), (want_kv, want_kv)))
    for what, got, plain, masks in cases:
        for x, y, want in zip(got, plain, masks):
            if not (torch.equal(torch.isnan(x), want)
                    and torch.equal(torch.isnan(y), want)):
                raise AssertionError(
                    f"{what} f32: NaN in {int(torch.isnan(x).sum())} "
                    f"entries, the plain version in "
                    f"{int(torch.isnan(y).sum())}, {int(want.sum())} "
                    "expected")


def check_f32_ring_blocks(gen) -> dict:
    """K3, K4 and K5 by the f32 ("tf32x3") route at the ring's block
    shapes, [4, 1024, 32, 128]: the causal diagonal block and a full past
    block, each held against its plain version (f32: 2e-5 entry by entry,
    1e-5 tile by tile) with a nonzero LSE cotangent in the backward (the
    ring's merge sends one), and timed beside the plain versions and
    ``scaled_dot_product_attention`` in f32 with TF32 off (forward, and
    its backward for K4/K5). All three multiply on the tensor cores by
    the 3xTF32 split: each runs twice on the same inputs and must give
    the same bits, a zeroed output and one whose later tiles are skipped
    must fail their tile check, and a NaN in a row of q or v (K3), in a
    row of q or dO or in key 0 of k (K4), or in a row of dO (K5) must
    reach the same outputs as in the plain versions (check_f32_nan_rows).
    Bounds, the larger of bytes and operations: the operations as three
    TF32 products over TF32_FLOPS (the design's ceiling; the f32
    CUDA-core figure, over F32_FLOPS, is logged beside it)."""
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, s, h, d = PAR_RING_BLOCK
    out = {}
    for tag, causal in (("causal_diag", True), ("full_past", False)):
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen,
                                   device="cuda").mul_(0.5)
                       for _ in range(4))
        if kernel_route(q, k) != TF32X3:
            raise AssertionError("f32 blocks must take the 3xTF32 route")
        o, lse = flash_attention_lse(q, k, v, causal=causal)
        want_o, want_lse = flash_attention_reference(q, k, v, causal=causal)
        delta = attention_delta(o, do)
        g_lse = torch.randn((b * h, s), generator=gen,
                            device="cuda").mul_(0.5)
        args = (q, k, v, do, lse, delta, causal, g_lse)
        got = (flash_backward_dq(*args), *flash_backward_dkv(*args))
        want = flash_backward_reference(*args)
        # The kernels again on the same inputs: the same bits.
        o2, lse2 = flash_attention_lse(q, k, v, causal=causal)
        again = (flash_backward_dq(*args), *flash_backward_dkv(*args))
        torch.cuda.synchronize()
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)
                and all(torch.equal(x, y) for x, y in zip(got, again))):
            raise AssertionError(f"f32 ring block {tag}: K3, K4 or K5 gave "
                                 "other bits on the same inputs")
        del o2, lse2, again
        errs = [(o - want_o).abs().max().item()] + [
            (g - w).abs().max().item() for g, w in zip(got, want)]
        rels = [tile_rel_err(o, want_o)] + [tile_rel_err(g, w)
                                            for g, w in zip(got, want)]
        torch.testing.assert_close(o, want_o, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-5)
        if max(_excess(g, w, 2e-4) for g, w in zip(got, want)) > 0 or \
                max(rels) > 1e-5:
            raise AssertionError(f"f32 ring block {tag}: max abs err "
                                 f"{errs}, tile-wise {rels}")
        for g, w in ((o, want_o), *zip(got, want)):
            tile_controls(g, w, K3_TILE_REL[torch.float32])
        check_f32_nan_rows(q, k, v, do, o, lse, causal, g_lse)
        log(f"f32 ring block {tag}: tile-wise relative error K3 "
            f"{rels[0]:.3g}, K4 {rels[1]:.3g}, K5 dk {rels[2]:.3g}, dv "
            f"{rels[3]:.3g}; K3, K4 and K5 repeat bit for bit; zeroed and "
            "skipped tiles fail; NaN rows reach the plain versions' "
            "outputs")
        del got, want
        flops = 2.0 * b * h * s * s * d / (2.0 if causal else 1.0)
        io = 4 * b * s * h * d * 4
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        lib_f = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), 5)
        so = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        lib_b = cuda_ms(lambda: torch.autograd.grad(
            so, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), 5)
        rows = b * h * s * 4
        for name, fn, plain, n_mm, out_bytes, lib, err in (
                ("K3", lambda: flash_attention_lse(q, k, v, causal=causal),
                 lambda: flash_attention_reference(q, k, v, causal=causal),
                 2, b * s * h * d * 4 + rows, lib_f, errs[0]),
                ("K4", lambda: flash_backward_dq(*args),
                 lambda: flash_backward_dq_reference(*args), 3,
                 b * s * h * d * 4, lib_b, errs[1]),
                ("K5", lambda: flash_backward_dkv(*args),
                 lambda: flash_backward_dkv_reference(*args), 4,
                 2 * b * s * h * d * 4, lib_b, max(errs[2:]))):
            ms = cuda_ms(fn, 5)
            plain_ms = cuda_ms(plain, 2)
            cuda_core_ms = n_mm * flops / F32_FLOPS * 1e3
            ops_ms = 3 * n_mm * flops / TF32_FLOPS * 1e3
            in_bytes = io - (b * s * h * d * 4 if name == "K3" else 0)
            bytes_ms = (in_bytes + out_bytes + (2 * rows if name != "K3"
                                                else 0)) \
                / HBM_BYTES_PER_S * 1e3
            entry = dict(
                design=TF32X3, ms=ms, plain_ms=plain_ms,
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                library_ms=lib, max_abs_err=err)
            line = (f"{name} f32 ring block {tag} [{b},{s},{h},{d}] "
                    f"({TF32X3}): {ms:.3f} ms "
                    f"({n_mm * flops / ms / 1e9:.1f} TFLOP/s), plain "
                    f"{plain_ms:.3f} ms, bound {entry['bound_ms']:.3f} ms")
            line += (" (three TF32 products), "
                     f"{max(cuda_core_ms, bytes_ms):.3f} ms on the f32 "
                     "CUDA cores")
            out.setdefault(name, {})[tag] = entry
            log(f"{line}, SDPA f32 {'backward ' if name != 'K3' else ''}"
                f"{lib:.3f} ms; max abs err {err:.3g}")
        del q, k, v, do, o, lse, args, qt, kt, vt, so
        torch.cuda.empty_cache()
    return out


def _route_sum(results, cases, kernel: str, route: str) -> int:
    return sum(r["meta"]["cases"][c]["launches"][kernel][route]
               for r in results for c in cases if c in r["meta"]["cases"])


def _rank_lines(tag: str, results) -> None:
    for r in results:
        m = r["meta"]
        for name, rec in m["cases"].items():
            log(f"[{tag}] rank {m['rank']} {name}: backend {rec['backend']}"
                f"{' (host-staged)' if rec['staged'] else ''}, "
                f"{rec['seconds']:.2f} s, peak "
                f"{rec['peak_bytes'] / GiB:.2f} GiB, collectives "
                + json.dumps(rec["transport"]))


def _close(what: str, got: float, want: float, rtol: float) -> None:
    if not math.isclose(got, want, rel_tol=rtol):
        raise AssertionError(f"{what}: {got!r} against {want!r} (rtol "
                             f"{rtol})")


def _mlp_assemble(results, key: str) -> np.ndarray:
    row = sorted((r for r in results if int(r["tp"]["coords"][0]) == 0),
                 key=lambda r: int(r["tp"]["coords"][1]))
    return np.concatenate([r["tp"][f"params/{key}"] for r in row],
                          axis=1 if key.startswith("w") else 0)


# The ring under the gate: forward only (its collectives are where a rank
# may hold the lock while it waits), at the attention cases' shape.
PAR_GATE_CASE = dict(impl="ring", causal=True, digest=True,
                     dtype="bfloat16", shape=PAR_ATTN, seed=11)


def _gated_deadlock(e: "dryrun.RankFailure") -> bool:
    """Whether the gate's run failed as a deadlock of its gated case: a
    rank had finished the ungated ring, not the gated one, and a
    collective (or the run) timed out."""
    logs = list(e.logs.values())
    in_gated = any(f"rank {r} ungated:" in t and f"rank {r} gated:" not in t
                   for r, t in e.logs.items())
    timed_out = "outlived" in str(e) or any(
        "timed out" in t.lower() for t in logs)
    return in_gated and timed_out


def gated_ring() -> tuple:
    """The ring ungated and again with each rank a tenant of one private
    scheduler (TQ PAR_GATE_TQ, lease grace 30 s,
    TPUSHARE_FORCE_MULTIHOST=1), in one pair of ranks of their own:
    every result's bits must be equal. Returns (results, the gate's
    record). Any failure fails the phase; where it is the gated case's
    deadlock (a rank that holds the lock while it waits in a collective,
    cut by gloo's timeout), the scheduler's log is kept and the guard's
    default refusal shown first."""
    sock_dir = tempfile.mkdtemp(prefix="tpushare-ring-gate-")
    sched = Scheduler(sock_dir, tq=PAR_GATE_TQ)
    env = {"TPUSHARE_SOCK_DIR": sock_dir, "TPUSHARE_FORCE_MULTIHOST": "1",
           "TPUSHARE_PURE_PYTHON": "1"}
    gate = [dict(PAR_GATE_CASE, name="ungated", case="attention"),
            dict(PAR_GATE_CASE, name="gated", case="gated_attention")]
    try:
        res = dryrun.spawn(PAR_WORLD, gate, device="cuda", env=env,
                           timeout_s=PAR_GATE_TIMEOUT_S)
    except dryrun.RankFailure as e:
        text = sched.text()
        CHILD_LOGS.mkdir(parents=True, exist_ok=True)
        (CHILD_LOGS / "ring_gate_scheduler.log").write_text(text)
        if not _gated_deadlock(e):
            raise
        refusal = dryrun.spawn(PAR_WORLD, [dict(name="guard", case="guard")],
                               device="cuda", timeout_s=120)
        raise AssertionError(
            f"the gated ring deadlocked (the guard, unforced, gates the "
            f"ranks: {[r['guard']['gated'] for r in refusal]}); scheduler "
            f"log tail:\n{text[-3000:]}") from e
    finally:
        sched.stop()
        shutil.rmtree(sock_dir, ignore_errors=True)
    for r in res:
        a, g = r["ungated"], r["gated"]
        diff = [k for k in a if k.startswith("sha/") and a[k] != g[k]]
        if diff:
            raise AssertionError(f"gated ring rank {r['meta']['rank']} "
                                 f"differs from ungated in {diff}")
    counts = [json.loads(r["gated"]["lock_counts"]) for r in res]
    log(f"gated ring: equal to ungated bit for bit; lock counters per rank "
        f"{counts}")
    return res, {"equal": True, "lock_counts": counts,
                 "seconds": [r["meta"]["cases"]["gated"]["seconds"]
                             for r in res],
                 "ungated_seconds": [r["meta"]["cases"]["ungated"]["seconds"]
                                     for r in res]}


def parallel_phase() -> dict:
    """Phase 12: the parallel package as ranks sharing the one card
    (``parallel/dryrun.py``'s spawn; gloo, host-staged collectives), each
    result held against a world-1 run of the same code on the same card
    or a single-process reference, by the tolerances above."""
    out: dict = {}
    # World 2: attention, the sequence-parallel and MoE LM steps, the EP
    # FFN and the pipeline, in one pair of ranks; the gated ring in a
    # second pair.
    attn = [dict(name=f"{impl}_{'causal' if c else 'full'}",
                 case="attention", impl=impl, causal=c, grads=True,
                 check=True, dtype="bfloat16", shape=PAR_ATTN, seed=i)
            for i, (impl, c) in enumerate(
                (i_, c_) for i_ in ("ring", "ulysses")
                for c_ in (True, False))]
    cases = attn + par_lm_cases("", PAR_WORLD) + [
        dict(PAR_MOE_FFN, name="moe_ffn", case="moe_ffn", check=True),
        dict(PAR_PIPE, name="pipeline", case="pipeline", check=True)]
    t0 = time.perf_counter()
    w2 = dryrun.spawn(PAR_WORLD, cases, device="cuda",
                      timeout_s=PAR_TIMEOUT_S)
    out["world2_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gate, out["gated_ring"] = gated_ring()
    out["gate_s"] = time.perf_counter() - t0
    _rank_lines("world 2", w2 + gate)
    for a in attn:
        errs = {k: v for k, v in w2[0][a["name"]].items()
                if k.startswith("err")}
        log(f"{a['name']} {PAR_ATTN} bf16: tile-wise error against f32 "
            f"reference_attention {errs}")
        if len(errs) != 4 or max(errs.values()) > PAR_ATTN_TILE_REL:
            raise AssertionError(f"{a['name']}: {errs} (limit "
                                 f"{PAR_ATTN_TILE_REL})")
        out[a["name"]] = errs
    for r in w2:
        moe = r["moe_ffn"]
        if moe["rel_err"] > PAR_MOE_REL:
            raise AssertionError(f"moe_ffn rank {r['meta']['rank']}: {moe}")
        pipe = {k: v for k, v in r["pipeline"].items()
                if k.startswith("rel_err")}
        if max(pipe.values()) > PAR_PIPE_REL:
            raise AssertionError(f"pipeline rank {r['meta']['rank']}: {pipe}")
        _close("pipeline loss", float(r["pipeline"]["losses"][0]),
               r["pipeline"]["loss_want"], 1e-5)
    out["moe_ffn"] = [r["moe_ffn"] for r in w2]
    out["pipeline"] = [{k: v for k, v in r["pipeline"].items()
                        if k != "losses"} for r in w2]
    # Routes: the ring's f32 blocks by the 3xTF32 kernels; Ulysses and the
    # pipeline's bf16 stages on the wgmma kernels.
    ring = ["ring_causal", "ring_full", "lm_ring", "moe_lm", "ungated",
            "gated"]
    bf16 = ["ulysses_causal", "ulysses_full", "lm_ulysses", "pipeline"]
    kernels = ("flash_attention", "flash_backward_dq", "flash_backward_dkv")
    runs = w2 + gate
    routes = {k: {"ring tf32x3": _route_sum(runs, ring, k, TF32X3),
                  "ring wgmma": _route_sum(runs, ring, k, WGMMA),
                  "bf16 wgmma": _route_sum(runs, bf16, k, WGMMA),
                  "bf16 tf32x3": _route_sum(runs, bf16, k, TF32X3),
                  "all": sum(n for r in runs
                             for rec in r["meta"]["cases"].values()
                             for n in rec["launches"][k].values())}
              for k in kernels}
    log(f"world-2 launches by route: {json.dumps(routes)}")
    for k, rt in routes.items():
        if rt["ring tf32x3"] == 0 or rt["ring wgmma"] or \
                rt["bf16 wgmma"] == 0 or rt["bf16 tf32x3"]:
            raise AssertionError(f"{k}: launches by route {rt}")
    out["launches"] = routes
    # World 1: the same steps at one rank, and the single-process steps.
    t0 = time.perf_counter()
    # (In this process: no process start, and its CUDA is warm.)
    w1 = dryrun.run_local(par_lm_cases("", 1) + [
        dict(PAR_MLP, name="mlp_single", case="mlp_single")],
        device="cuda")
    out["world1_s"] = time.perf_counter() - t0
    _rank_lines("world 1", [{"meta": w1["meta"]}])
    lm = {}
    for name, ref, rtol_l, rtol_m in (
            ("lm_ring", "lm_ring", PAR_LOSS_RTOL["world1"],
             PAR_M_RTOL["world1"]),
            ("lm_ulysses", "lm_ulysses", PAR_LOSS_RTOL["world1"],
             PAR_M_RTOL["world1"]),
            ("lm_ring", "lm_train_step", PAR_LOSS_RTOL["lm_train_step"],
             PAR_M_RTOL["lm_train_step"]),
            ("lm_ulysses", "lm_train_step", PAR_LOSS_RTOL["lm_train_step"],
             PAR_M_RTOL["lm_train_step"]),
            ("moe_lm", "moe_lm", PAR_MOE_LOSS_RTOL, 5 * PAR_MOE_LOSS_RTOL),
            ("moe_lm", "moe_lm_train_step", PAR_MOE_LOSS_RTOL,
             5 * PAR_MOE_LOSS_RTOL)):
        got, want = w2[0][name], w1[ref]
        for r in w2[1:]:
            if r[name]["param_sum"] != got["param_sum"] or \
                    r[name]["m_abs"] != got["m_abs"]:
                raise AssertionError(f"{name}: the ranks' states differ")
        for i, (a, b) in enumerate(zip(got["losses"], want["losses"])):
            _close(f"{name} loss {i} vs {ref}", float(a), float(b), rtol_l)
        _close(f"{name} sum|m| vs {ref}", got["m_abs"], want["m_abs"],
               rtol_m)
        # The parameters moved by lr x (m1 + m2): their sums may differ by
        # a share of that move, never by more.
        move = TRAIN_LR * (got["m_abs"] + want["m_abs"])
        if abs(got["param_sum"] - want["param_sum"]) > 0.05 * move:
            raise AssertionError(f"{name} param sum {got['param_sum']!r} "
                                 f"vs {ref} {want['param_sum']!r}")
        lm[f"{name} vs {ref}"] = {
            "losses": [float(x) for x in got["losses"]],
            "ref_losses": [float(x) for x in want["losses"]],
            "m_abs": got["m_abs"], "ref_m_abs": want["m_abs"],
            "param_sum": got["param_sum"], "ref_param_sum": want["param_sum"],
            "step_s": [float(x) for x in got["step_s"]],
            "ref_step_s": [float(x) for x in want["step_s"]]}
        log(f"{name} (world 2) vs {ref}: " + json.dumps(lm[f"{name} vs "
                                                        f"{ref}"]))
    out["lm"] = lm
    # World 4: dp x tp on a 2 x 2 grid against one process.
    t0 = time.perf_counter()
    w4 = dryrun.spawn(4, [dict(PAR_MLP, name="tp", case="mlp")],
                      device="cuda", timeout_s=PAR_TIMEOUT_S)
    out["world4_s"] = time.perf_counter() - t0
    _rank_lines("world 4", w4)
    single = w1["mlp_single"]
    for a, b in zip(w4[0]["tp"]["losses"], single["losses"]):
        _close("dp x tp MLP loss", float(a), float(b), PAR_MLP_LOSS_RTOL)
    # The updates (final less initial parameters, the same seed-0 draw on
    # this card) are what the steps computed: held norm-wise.
    p0 = MLP(**PAR_MLP["model"]).init(0, device="cuda")
    rels = {}
    for k, v in p0.items():
        v = v.cpu().numpy()
        got = _mlp_assemble(w4, k) - v
        want = single[f"params/{k}"] - v
        rels[k] = float(np.linalg.norm(got - want)
                        / max(np.linalg.norm(want), 1e-30))
    del p0
    log(f"dp x tp MLP (2 x 2 grid, world 4) vs train_step: losses "
        f"{[float(x) for x in w4[0]['tp']['losses']]} vs "
        f"{[float(x) for x in single['losses']]}; update rel err {rels}")
    if max(rels.values()) > PAR_MLP_REL:
        raise AssertionError(f"dp x tp MLP updates: {rels}")
    out["mlp"] = {"losses": [float(x) for x in w4[0]["tp"]["losses"]],
                  "ref_losses": [float(x) for x in single["losses"]],
                  "param_rel_err": rels,
                  "shape": [int(s) for s in w4[0]["tp"]["shape"]]}
    out["backend"] = {n: [r["meta"]["backend"] for r in res]
                      for n, res in (("world2", w2), ("gate", gate),
                                     ("world4", w4))}
    out["transport"], out["peak_gib"] = {}, {}
    for r in runs:
        rank = r["meta"]["rank"]
        for name, rec in r["meta"]["cases"].items():
            out["transport"].setdefault(rank, {})[name] = rec["transport"]
            out["peak_gib"].setdefault(f"world2 rank {rank}", {})[name] = \
                rec["peak_bytes"] / GiB
    out["line"] = ("parallel ranks: " + json.dumps({
        "attention_tile_err": {a["name"]: max(out[a["name"]].values())
                               for a in attn},
        "lm": {k: v["losses"] for k, v in lm.items()},
        "moe_ffn_rel_err": [m["rel_err"] for m in out["moe_ffn"]],
        "gated_ring": {k: v for k, v in out["gated_ring"].items()
                       if k != "lock_counts"},
        "seconds": {k: round(out[k], 3) for k in ("world2_s", "gate_s",
                                                   "world1_s", "world4_s")}}))
    log(out["line"])
    return out


def pre_repair_main(phases: Phases, card: str) -> int:
    """``--pre-repair``: only the oversubscribing process pair, with the
    release of each handoff's freed blocks taken out of the tenants."""
    os.environ["TPUSHARE_REQUIRE_SCHEDULER"] = "1"
    os.environ["TPUSHARE_PALLAS_MATMUL"] = "1"
    physical = torch.cuda.mem_get_info()[1]
    out = phases.run("pre-repair process pair", pre_repair_phase, physical)
    log("phase seconds: " + json.dumps(phases.seconds))
    log(card)
    log(json.dumps({"pre_repair": out}))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
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
    if argv == ["--pre-repair"]:
        return pre_repair_main(phases, card)
    if argv:
        raise SystemExit(f"usage: chip_smoke.py [--pre-repair]; got {argv}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    mix_entry = phases.run("check fused_mix", check_mix, gen)
    mm_entry = phases.run("check tiled_matmul", check_matmul, gen)
    att_entry = phases.run("check flash_attention", check_attention, gen)
    dq_entry, dkv_entry = phases.run("check flash backward",
                                     check_attention_backward, gen)
    f32_ring = phases.run("check f32 ring blocks", check_f32_ring_blocks,
                          gen)

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
                             chunks, budget, chunks * mm_entry["wrapper_ms"]
                             / 1e3 / DEVICE_RATIO)
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
        ab = phases.run("pager a/b", pager_ab, chunks, budget, sched, tq)
        # Phases 7, 11 and 12 run between the pairs that size themselves
        # against host memory: the host takes the freed pinned shadows
        # back over seconds, which the next pair's sizing waits for
        # (settled_mem_available), so let it happen while they run.
        serve = phases.run("serving phases", serving_phases, sched)
        lm = lm_phases(phases, budget, physical, sched)
        train = train_phases(phases, budget, physical, sched)
        release_host_cache()
        unmod = phases.run("unmodified pair", unmod_phase)
        wrappers = (flash_attention, flash_backward_dq, flash_backward_dkv)
        reset_counts(*wrappers)
        qos = phases.run("qos pair", qos_phase, dict(lm, budget=budget),
                         train, budget)
        qos_launches = [fn.launches.value for fn in wrappers]
        qos_wgmma = [fn.route_launches[WGMMA].value for fn in wrappers]
        depth = qos["train_depth"]
        want = [2 * (LM.depth * qos["inter_requests"]
                     + 2 * depth * train["steps"]),
                2 * depth * train["steps"], 2 * depth * train["steps"]]
        if qos_launches != want or qos_wgmma != want:
            raise AssertionError(f"K3/K4/K5 launched {qos_launches} times "
                                 f"({qos_wgmma} by the wgmma route) on the "
                                 f"QoS path, not {want}")
        # The ranks are processes of their own: hand them the card and the
        # host's pinned memory this process still caches.
        release_host_cache()
        par = phases.run("parallel ranks", parallel_phase)
        proc = phases.run("process pair", proc_phase, physical,
                          {"matmul": mm_step, "add": add_step}, chunks)
    finally:
        sched.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    if mm_launches == 0 or mix_launches == 0:
        raise AssertionError(f"kernel launches on the main path: matmul "
                             f"{mm_launches}, mix {mix_launches}")
    proc_k1 = sum(proc["k1_launches"].values())
    proc_k2 = sum(proc["k2_launches"].values())
    if proc_k1 == 0 or proc_k2 == 0:
        raise AssertionError(f"process tenants' launches: fused_mix "
                             f"{proc_k1}, tiled_matmul {proc_k2}")
    # The unmodified LM runs, each checked to the launch (unmod_phase).
    unmod_launches = [sum(r[k]["launches"] for r in unmod["launches"].values())
                      for k in ("flash_attention", "flash_backward_dq",
                                "flash_backward_dkv")]
    k3_launches, k4_launches, k5_launches = train["launches"]
    lm_launches = lm["launches"] + lm["pager_launches"]
    k3_wgmma = (lm["wgmma_launches"] + lm["pager_wgmma_launches"]
                + train["wgmma_launches"][0])
    k4_wgmma, k5_wgmma = train["wgmma_launches"][1:]
    log(f"main-path launches: tiled_matmul {mm_launches} + {proc_k2} "
        f"(process tenants), fused_mix "
        f"{mix_launches} + {proc_k1} (process tenants), flash_attention "
        f"{lm['launches']} (serving) + {lm['pager_launches']} (serving, "
        f"pager) + {k3_launches} (training) + {qos_launches[0]} (QoS pair) "
        f"+ {unmod_launches[0]} (unmodified LM), "
        f"{k3_wgmma + qos_wgmma[0]} of the first four by the wgmma route, "
        f"flash_backward_dq {k4_launches} + {qos_launches[1]} + "
        f"{unmod_launches[1]}, "
        f"{k4_wgmma + qos_wgmma[1]} of the first two by the wgmma route, "
        f"flash_backward_dkv {k5_launches} + {qos_launches[2]} + "
        f"{unmod_launches[2]}, {k5_wgmma + qos_wgmma[2]} of the first two "
        "by the wgmma route (the unmodified LM's: every one, "
        "unmod_phase)")
    if k3_wgmma != lm_launches + k3_launches or \
            k4_wgmma != k4_launches or k5_wgmma != k5_launches:
        raise AssertionError("a main-path launch of K3, K4 or K5 did not "
                             "take the wgmma route")
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
        "lm_check": lm["check"],
        "pager_knobs": PAGER_ENV,
        "pager_ab": ab,
        "lm_pager": {k: lm["pager_pair"][k] for k in (
            "makespan_s", "ratio", "handoffs", "handoff_mean_s", "drops",
            "pager", "sync", "trickled_bytes", "peak_bytes")},
        "serving_phases": serve,
        "train": {k: train[k] for k in (
            "steps", "tq_s", "cycle_s", "solo_s", "makespan_s", "ratio",
            "step_s", "losses", "handoffs", "handoff_mean_s", "drops",
            "wss_bytes", "pinned_bytes", "budget", "solo_peak_bytes",
            "peak_bytes")},
        "train_check": train["check"],
        "qos": qos, "process_pair": proc, "unmodified_pair": unmod,
        "parallel_ranks": {k: v for k, v in par.items() if k != "line"},
        "f32_ring_blocks": f32_ring},
        default=str))
    # The newest pairs' readings and the phase seconds again, after the
    # long line, so that the end of the output carries them.
    for line in (qos["line"], proc["line"], unmod["line"], par["line"],
                 "phase seconds: " + json.dumps(phases.seconds),
                 f"script total: {time.perf_counter() - STARTED:.1f} s"):
        log(line)
    # Phase 12's launches (every rank's, every case's), and the f32 route
    # at the ring's block shapes, beside each attention kernel's entry.
    par_launches = [par["launches"][k]["all"] for k in (
        "flash_attention", "flash_backward_dq", "flash_backward_dkv")]
    f32_extra = [dict(f32_ring=dict(f32_ring[k], route=TF32X3,
                                    shape=list(PAR_RING_BLOCK),
                                    ring_launches=par["launches"][n][
                                        "ring tf32x3"]))
                 for k, n in (("K3", "flash_attention"),
                              ("K4", "flash_backward_dq"),
                              ("K5", "flash_backward_dkv"))]
    kernels = [
        # K1 runs on the CUDA cores.
        dict(name="fused_mix", route="cuda", design="cuda cores",
             source="nvshare_tpu_torch/csrc/mix.cu",
             replaces="nvshare_tpu/ops/mix.py:42",
             launches=mix_launches + proc_k1,
             **mix_entry),
        dict(name="tiled_matmul", route="cuda",
             source="nvshare_tpu_torch/csrc/matmul_sm90.cu",
             replaces="nvshare_tpu/ops/matmul.py:58",
             launches=mm_launches + proc_k2, **mm_entry),
        dict(name="flash_attention", route="cuda",
             source="nvshare_tpu_torch/csrc/attention_sm90.cu",
             replaces="nvshare_tpu/ops/attention.py:120",
             launches=lm_launches + k3_launches + qos_launches[0]
             + unmod_launches[0] + par_launches[0], **att_entry,
             **f32_extra[0]),
        dict(name="flash_backward_dq", route="cuda",
             source="nvshare_tpu_torch/csrc/attention_bwd_sm90.cu",
             replaces="nvshare_tpu/ops/attention.py:267",
             launches=k4_launches + qos_launches[1] + unmod_launches[1]
             + par_launches[1], **dq_entry, **f32_extra[1]),
        dict(name="flash_backward_dkv", route="cuda",
             source="nvshare_tpu_torch/csrc/attention_bwd_sm90.cu",
             replaces="nvshare_tpu/ops/attention.py:286",
             launches=k5_launches + qos_launches[2] + unmod_launches[2]
             + par_launches[2], **dkv_entry, **f32_extra[2]),
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
