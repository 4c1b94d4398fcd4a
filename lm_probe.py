#!/usr/bin/env python3
"""Where the language model's inference time and rounding go, on one card.

    python3 lm_probe.py

Needs one CUDA card and ``nvcc``, as ``chip_smoke.py`` does, and builds the
flash-attention kernel the same way. At the widths ``chip_smoke.py`` runs
(GPT-3 6.7B: 32 layers, d_model 4096, 32 heads, context 2048, vocabulary
50257; random weights from seed 0) it measures, without the arena:

1. one greedy decode step at batch 16 (host clock, synchronized), the
   same step on meta tensors (what ``vop`` runs to size its outputs), and
   a profiler breakdown of three steps: device time, host time, and the
   ops that take the most device time;
2. the scoring forward on [4, 2048] tokens the same way, K3's share
   included;
3. for depths 2, 4, 8, 16 and 32, the logits of the forward through K3
   against the forward through the plain attention: max abs error, the
   share of logits outside rtol = atol = 2e-2, the norm-wise relative
   error and the argmax agreement.

Prints one line per measurement and, last, the card's name and power limit
and one JSON object of all of them.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from chip_smoke import LM, card_line, logits_agreement, log  # noqa: E402
from nvshare_tpu_torch.models.decode import decode_step, init_kv_cache  # noqa: E402
from nvshare_tpu_torch.models.transformer import (  # noqa: E402
    local_attn,
    synthetic_tokens,
    transformer_forward,
)
from nvshare_tpu_torch.ops import _build, flash_attention_reference  # noqa: E402


def wall_ms(fn, reps: int) -> float:
    """Mean host-clock milliseconds of ``fn()``, synchronized, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def breakdown(fn, reps: int, top: int = 6) -> dict:
    """Device and host milliseconds per call from ``torch.profiler``, and
    the ops and the kernels with the most device time (the flash kernel
    is launched through ctypes, so it shows as a kernel, not an op)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # As the profiler's own table sums them: device time over the
    # kernels (device events), host time over every event.
    device = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA) / 1e3 / reps
    host = sum(e.self_cpu_time_total for e in events) / 1e3 / reps
    ops = sorted((e for e in events if e.key.startswith("aten::")),
                 key=lambda e: -e.device_time_total)[:top]
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)[:top]
    return {"device_ms": device, "host_ms": host,
            "top_ops_device_ms": {e.key: e.device_time_total / 1e3 / reps
                                  for e in ops},
            "top_kernels_device_ms": {
                e.key[:60]: e.self_device_time_total / 1e3 / reps
                for e in kernels}}


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_probe: no CUDA device is available", file=sys.stderr)
        return 2
    card = card_line()
    _build.build(["attention"])
    out = {"card": card}
    dev = torch.device("cuda")
    params = LM.init(0, device=dev)
    meta = torch.device("meta")

    cache = init_kv_cache(LM, 16, LM.seq, device=dev)
    token = torch.zeros(16, dtype=torch.long, device=dev)
    mparams = {k: torch.empty(v.shape, dtype=v.dtype, device=meta)
               for k, v in params.items()}
    mcache = {k: torch.empty(v.shape, dtype=v.dtype, device=meta)
              for k, v in cache.items()}
    step = lambda: decode_step(params, LM, cache, 100, token)  # noqa: E731
    out["decode"] = {
        "wall_ms": wall_ms(step, 10),
        "meta_pass_ms": wall_ms(lambda: decode_step(
            mparams, LM, mcache, 100,
            torch.empty(16, dtype=torch.long, device=meta)), 3),
        **breakdown(step, 3)}
    log(f"decode step, batch 16: {json.dumps(out['decode'])}")
    del cache

    toks = torch.from_numpy(
        synthetic_tokens(LM, 4, 0)[:, :LM.seq]).to(dev)
    score = lambda: transformer_forward(params, LM, toks)  # noqa: E731
    out["score"] = {"wall_ms": wall_ms(score, 3), **breakdown(score, 2)}
    log(f"scoring forward [4,{LM.seq}]: {json.dumps(out['score'])}")

    def plain(q, k, v, causal):
        return flash_attention_reference(q, k, v, causal=causal)[0]

    out["depth"] = {}
    for depth in (2, 4, 8, 16, 32):
        model = dataclasses.replace(LM, depth=depth)
        got = transformer_forward(params, model, toks)
        want = transformer_forward(params, model, toks,
                                   local_attn(model, plain))
        err, outside, rel, agree = logits_agreement(got, want).tolist()
        out["depth"][depth] = {"max_abs_err": err, "outside": outside,
                               "rel": rel, "argmax_agree": agree}
        log(f"depth {depth}: K3 forward vs plain-attention forward: max abs "
            f"err {err:.4g}, share outside rtol/atol 2e-2 {outside:.4g}, "
            f"norm-wise relative error {rel:.3g}, argmax agreement "
            f"{agree:.4f}")
        del got, want
        torch.cuda.empty_cache()

    log(card)
    log(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
