#!/usr/bin/env python3
"""Where the language model's time and rounding go, on one card.

    python3 lm_probe.py [infer] [train]

Needs one CUDA card and ``nvcc``, as ``chip_smoke.py`` does, and builds the
flash-attention kernels the same way. Runs the named parts (both by
default). ``infer``, at the widths ``chip_smoke.py`` serves (GPT-3 6.7B:
32 layers, d_model 4096, 32 heads, context 2048, vocabulary 50257; random
weights from seed 0), measures without the arena:

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

``train``, at the widths ``chip_smoke.py`` trains (the same model at 24
layers, remat on, 4 x 2048 tokens a step), measures without the arena one
``lm_train_step`` (host clock, synchronized), its pass on meta tensors
(what ``vop`` runs once to size its outputs) and a profiler breakdown of
one step: device time, host time, the device's idle share of the step,
the kernels with the most device time, and K3's, K4's and K5's, each
under the route its kernel took (``kernel_route``).

Prints one line per measurement and, last, the card's name and power limit
and one JSON object of all of them.
"""

from __future__ import annotations

import dataclasses
import json
import re
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from chip_smoke import (  # noqa: E402
    LM,
    TRAIN,
    TRAIN_BATCH,
    TRAIN_LR,
    card_line,
    log,
    logits_agreement,
)
from nvshare_tpu_torch.models.decode import decode_step, init_kv_cache  # noqa: E402
from nvshare_tpu_torch.models.transformer import (  # noqa: E402
    init_lm_state,
    lm_train_step,
    local_attn,
    synthetic_tokens,
    transformer_forward,
)
from nvshare_tpu_torch.ops import _build, flash_attention_reference  # noqa: E402
from nvshare_tpu_torch.ops.attention import CUDA_CORE, WGMMA  # noqa: E402

# The flash kernels' names in a trace: (kernel, route).
FLASH_KERNELS = {
    "flash_fwd_sm90": ("K3", WGMMA), "flash_fwd": ("K3", CUDA_CORE),
    "flash_bwd_dq_sm90": ("K4", WGMMA), "flash_bwd_dq": ("K4", CUDA_CORE),
    "flash_bwd_dkv_sm90": ("K5", WGMMA), "flash_bwd_dkv": ("K5", CUDA_CORE),
}


def flash_label(key: str):
    """'K4 wgmma+tma' for a trace event of a flash kernel, else None."""
    m = re.search(r"\b(flash_\w+?)<", key)
    if m is None or m.group(1) not in FLASH_KERNELS:
        return None
    return " ".join(FLASH_KERNELS[m.group(1)])


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
    """Device and host milliseconds per call from ``torch.profiler``, the
    ops and the kernels with the most device time, and every flash
    kernel's under its kernel and route, as "K4 wgmma+tma" (launched
    through ctypes, they show as kernels, not ops)."""
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
    flash: dict = {}
    for e in events:
        label = flash_label(e.key)
        if e.device_type == DeviceType.CUDA and label:
            flash[label] = (flash.get(label, 0.0)
                            + e.self_device_time_total / 1e3 / reps)
    return {"device_ms": device, "host_ms": host,
            "top_ops_device_ms": {e.key: e.device_time_total / 1e3 / reps
                                  for e in ops},
            "top_kernels_device_ms": {
                e.key[:60]: e.self_device_time_total / 1e3 / reps
                for e in kernels},
            "flash_kernels_device_ms": flash}


def train_probe(out: dict) -> None:
    """One training step at TRAIN's widths: wall, meta pass, breakdown."""
    dev = torch.device("cuda")
    params, opt = init_lm_state(TRAIN, 0, device=dev)
    toks = torch.from_numpy(synthetic_tokens(TRAIN, TRAIN_BATCH, 1)).to(dev)

    def step():
        lm_train_step(params, opt, toks, TRAIN, TRAIN_LR)

    mparams, mopt = init_lm_state(TRAIN, device="meta")
    mtoks = torch.empty(toks.shape, dtype=toks.dtype, device="meta")
    wall = wall_ms(step, 2)
    parts = breakdown(step, 1, top=8)
    out["train"] = {
        "wall_ms": wall,
        "meta_pass_ms": wall_ms(lambda: lm_train_step(
            mparams, mopt, mtoks, TRAIN, TRAIN_LR), 1),
        "device_idle_share": 1.0 - parts["device_ms"] / wall,
        **parts}
    log(f"train step [{TRAIN_BATCH},{TRAIN.seq}] at {TRAIN.depth} layers, "
        f"remat: {json.dumps(out['train'])}")
    del params, opt
    torch.cuda.empty_cache()


def infer_probe(out: dict) -> None:
    """Decode and scoring at LM's widths, and the logits against depth."""
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


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_probe: no CUDA device is available", file=sys.stderr)
        return 2
    parts = sys.argv[1:] or ["infer", "train"]
    card = card_line()
    _build.build([n for n in _build.SOURCES if n.startswith("attention")])
    out = {"card": card}
    if "train" in parts:
        train_probe(out)
    if "infer" in parts:
        infer_probe(out)
    log(card)
    log(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
