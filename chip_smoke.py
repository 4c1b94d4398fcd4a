#!/usr/bin/env python3
"""Drive nvshare_tpu_torch end to end on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and
``make``/``g++``; exits non-zero without printing a result otherwise.

Phases (each one's seconds are printed; any failure exits non-zero):

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
   (``kernel_route``): bf16 K3, K4 and K5 run the wgmma + TMA kernels,
   f32 the CUDA-core ones. Times from CUDA events; ``torch.matmul`` in
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
import threading
import time
from pathlib import Path
from unittest import mock

import torch

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
    CUDA_CORE,
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
AB_QUANTA = 3.5          # quanta of work each A/B tenant brings
# The serving phases: the mock decoder at the LM's cache widths.
SERVE = dict(layers=2, batch=DECODE_BATCH, max_len=2048, d_model=4096)
SERVE_TOKENS = 640
SERVE_REQUESTS = 4
SERVE_THINK_S = 0.01     # inter-token host work of the decode tenant
# Prefill bursts of 2048 x 2048 activations, long enough on the card that
# a handoff almost always finds one resident (a burst's host-side draw of
# its input is a few percent of it).
PREFILL = dict(bursts=12, seq=2048, steps_per_burst=2048, gap_s=0.0)
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


TILE_ROWS = 64


def tile_rel_err(got, want) -> float:
    """The largest norm-wise relative error ||got - want|| / ||want|| over
    the tiles of TILE_ROWS rows of one head of a [B, S, H, D] gradient. It
    does not depend on the gradients' scale, and a wrong or skipped tile
    shows wherever it lies. A tile whose reference is below 1e-6 of the
    largest tile's norm (causal dK, dV of keys no query sees) is measured
    against that floor."""
    b, s, h, d = want.shape
    shape = (b, s // TILE_ROWS, TILE_ROWS, h, d)
    diff = (got.float() - want.float()).reshape(shape).norm(dim=(2, 4))
    ref = want.float().reshape(shape).norm(dim=(2, 4))
    floor = max(1e-6 * ref.max().item(), torch.finfo(torch.float32).tiny)
    return (diff / ref.clamp(min=floor)).max().item()


# The tight limits on tile_rel_err for K3 and for K4 and K5 against their
# plain versions, which compute in f32 and round only their outputs.
# f32 (the CUDA-core kernels): only the summation order differs (at most
# 1.3e-6 read for K3 and 1.6e-7 for K4/K5 on an H100, PERF.md). bf16: the
# wgmma kernels also round an operand of their last products to bf16,
# where the plain versions keep f32: K3 its probabilities P, K5 its P^T
# and dS^T, K4 its dS (before dS k). That is a relative rounding of at
# most 2**-9 = 2.0e-3 an entry, averaged over each sum, on top of the
# output's own rounding to bf16 (2.6e-3 to 3.6e-3 read for K3 and K5 at
# every check shape and layer, PERF.md; the CUDA-core K4, which rounded
# only its output, read at most 8e-4). 1e-2 holds these with room, and a
# zeroed or skipped tile (1.0) fails it by two orders of magnitude.
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
        raise RuntimeError(f"{name} co-located tenants failed: "
                           f"{report.errors}")
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
    # Each tenant's device work spans >= 3 quanta, so with both tenants
    # waiting on each other it is dropped at least twice.
    steps = max(3, math.ceil(3.0 * tq / step_s) + 2)
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
    steps = max(3 * chunks, math.ceil(AB_QUANTA * tq / AB_SLEEP_S))
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


def lm_differs(res, solo):
    if res.checksums != solo.checksums:
        return f"scoring checksums {res.checksums} != solo {solo.checksums}"
    if not (res.tokens == solo.tokens).all():
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
    # Each tenant's device work spans >= 3 quanta (dropped at least
    # twice), within one session of LM.seq cached positions.
    requests = min(LM.seq // DECODE_TOKENS,
                   max(3, math.ceil(3.0 * tq / probe["request_s"]) + 2))
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
    params, opt = init_lm_state(TRAIN, device="meta")
    sizes = [x.numel() * x.element_size()
             for x in (*params.values(), *opt["m"].values())]
    wss = sum(sizes)
    pinned = sum(1 << (n - 1).bit_length() for n in sizes)
    n_params = sum(x.numel() for x in params.values())
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


def train_workload(steps: int):
    return lm_train_workload(TRAIN, steps=steps, batch=TRAIN_BATCH,
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
    # Each tenant's device work spans >= 3 quanta (dropped at least twice).
    steps = max(3, math.ceil(3.0 * tq / probe["step_s"]) + 2)
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
    dq_entry, dkv_entry = phases.run("check flash backward",
                                     check_attention_backward, gen)

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
        lm = lm_phases(phases, budget, physical, sched)
        serve = phases.run("serving phases", serving_phases, sched)
        train = train_phases(phases, budget, physical, sched)
    finally:
        sched.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    if mm_launches == 0 or mix_launches == 0:
        raise AssertionError(f"kernel launches on the main path: matmul "
                             f"{mm_launches}, mix {mix_launches}")
    k3_launches, k4_launches, k5_launches = train["launches"]
    lm_launches = lm["launches"] + lm["pager_launches"]
    k3_wgmma = (lm["wgmma_launches"] + lm["pager_wgmma_launches"]
                + train["wgmma_launches"][0])
    k4_wgmma, k5_wgmma = train["wgmma_launches"][1:]
    log(f"main-path launches: tiled_matmul {mm_launches}, fused_mix "
        f"{mix_launches}, flash_attention {lm['launches']} (serving) + "
        f"{lm['pager_launches']} (serving, pager) + "
        f"{k3_launches} (training), {k3_wgmma} of them by the wgmma route, "
        f"flash_backward_dq {k4_launches}, {k4_wgmma} by the wgmma route, "
        f"flash_backward_dkv {k5_launches}, {k5_wgmma} by the wgmma route")
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
        "train_check": train["check"]}))
    kernels = [
        # K1 runs on the CUDA cores.
        dict(name="fused_mix", route="cuda", design=CUDA_CORE,
             source="nvshare_tpu_torch/csrc/mix.cu",
             replaces="nvshare_tpu/ops/mix.py:42", launches=mix_launches,
             **mix_entry),
        dict(name="tiled_matmul", route="cuda",
             source="nvshare_tpu_torch/csrc/matmul_sm90.cu",
             replaces="nvshare_tpu/ops/matmul.py:58", launches=mm_launches,
             **mm_entry),
        dict(name="flash_attention", route="cuda",
             source="nvshare_tpu_torch/csrc/attention_sm90.cu",
             replaces="nvshare_tpu/ops/attention.py:120",
             launches=lm_launches + k3_launches, **att_entry),
        dict(name="flash_backward_dq", route="cuda",
             source="nvshare_tpu_torch/csrc/attention_bwd_sm90.cu",
             replaces="nvshare_tpu/ops/attention.py:267",
             launches=k4_launches, **dq_entry),
        dict(name="flash_backward_dkv", route="cuda",
             source="nvshare_tpu_torch/csrc/attention_bwd_sm90.cu",
             replaces="nvshare_tpu/ops/attention.py:286",
             launches=k5_launches, **dkv_entry),
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
