"""Mock LLM serving workloads: ragged decode loops and prefill bursts.

The port of ``nvshare_tpu/models/serving.py``, the phase plane's user:
**decode** is a latency-bound per-token loop over a hot-forever KV cache
with RAGGED batches (requests join and finish mid-stream, so the active
rows vary token to token), and **prefill** is a throughput-bound burst of
large activations consumed at the handoff. Both run through a
:class:`~nvshare_tpu_torch.vmem.VirtualHBM` arena with serving-phase
residency tags — KV arrays carry ``phase_hint="kv"`` (evicted last while
decoding), prefill activations ``phase_hint="act"`` (they leave the hot
set at the handoff) — and the workloads declare their phase on both planes
through :meth:`~nvshare_tpu_torch.colocate.Tenant.set_phase`. The inputs
come from the same numpy generators as the JAX package's, so the two
packages serve the same values.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from nvshare_tpu_torch import vmem


def _decode_layer(k, v, w, x, mask):
    """One decode position against one layer's cache: score the hidden
    state over the cached keys, mix the values back, project — active
    rows move, finished rows hold. Reads the WHOLE K/V pair."""
    p = torch.softmax(torch.einsum("bld,bd->bl", k, x)
                      / math.sqrt(k.shape[-1] * 1.0), dim=-1)
    m = mask[:, None]
    return (torch.tanh((torch.einsum("bl,bld->bd", p, v) + x) @ w) * m
            + x * (1.0 - m))


class ServingModel:
    """Per-tenant mock decoder state: per-layer K/V cache arrays (tagged
    ``"kv"``), a shared projection weight, a live hidden state, and a
    small cycling set of ragged batch masks."""

    def __init__(self, arena, layers: int = 2, batch: int = 4,
                 max_len: int = 64, d_model: int = 64,
                 n_masks: int = 4, seed: int = 0):
        self.arena = arena
        self.layers = layers
        self.batch = batch
        self.d_model = d_model
        rng = np.random.default_rng(seed)
        self.kv = []
        for _ in range(layers):
            k = arena.array(rng.standard_normal(
                (batch, max_len, d_model)).astype(np.float32))
            v = arena.array(rng.standard_normal(
                (batch, max_len, d_model)).astype(np.float32))
            # Hot forever while decoding: the tag the KV-protected
            # eviction order reads.
            k.phase_hint = "kv"
            v.phase_hint = "kv"
            self.kv.append((k, v))
        self.w = arena.array(
            (rng.standard_normal((d_model, d_model)) / np.sqrt(d_model))
            .astype(np.float32))
        self.x = arena.array(
            rng.standard_normal((batch, d_model)).astype(np.float32))
        # Ragged active-row masks: requests join/finish mid-stream, so
        # each token step serves a different subset of the batch.
        self.masks = []
        for i in range(max(n_masks, 1)):
            active = rng.random(batch) < (0.35 + 0.6 * (i + 1) / n_masks)
            if not active.any():
                active[int(rng.integers(batch))] = True
            self.masks.append(arena.array(active.astype(np.float32)))
        self.kv_bytes = sum(k.nbytes + v.nbytes for k, v in self.kv)

    _step = staticmethod(vmem.vop(_decode_layer, donate_argnums=(3,)))

    def decode_token(self, step: int):
        """One token across every layer (the ragged mask cycles per
        step)."""
        mask = self.masks[step % len(self.masks)]
        for k, v in self.kv:
            self.x = self._step(k, v, self.w, self.x, mask)
        return self.x

    def checksum(self) -> float:
        return float(np.asarray(self.x.numpy()).sum())


def decode_workload(tokens: int, layers: int = 2, batch: int = 4,
                    max_len: int = 64, d_model: int = 64,
                    seed: int = 0, think_s: float = 0.0,
                    start_delay_s: float = 0.0, requests: int = 1,
                    inter_request_s: float = 0.05) -> Callable:
    """A latency-bound decode tenant for ``run_colocated``: declares the
    decode phase, then serves ``tokens`` positions as ``requests``
    separate request streams, recording each token's wall latency (gate
    wait included).

    ``think_s`` models inter-token host work; ``start_delay_s`` the first
    request arriving after the fleet is busy. Between requests the tenant
    RELEASES the device and pauses ``inter_request_s``, so each request's
    first token re-arrives against whatever tenant took the lock."""

    def work(tenant):
        if start_delay_s > 0:
            time.sleep(start_delay_s)
        model = ServingModel(tenant.arena, layers=layers, batch=batch,
                             max_len=max_len, d_model=d_model, seed=seed)
        tenant.set_phase("decode")
        lats = []
        n_req = max(1, min(requests, tokens))
        per_req = max(1, tokens // n_req)
        served = 0
        for r in range(n_req):
            want = per_req if r < n_req - 1 else tokens - served
            for _ in range(want):
                t0 = time.monotonic()
                model.decode_token(served)
                tenant.client.mark_activity()
                lats.append(time.monotonic() - t0)
                served += 1
                if think_s > 0:
                    time.sleep(think_s)
            if r < n_req - 1:
                # Request boundary: the stream drains, the tenant yields
                # the device and the next request re-arrives cold.
                tenant.client.release_now()
                if inter_request_s > 0:
                    time.sleep(inter_request_s)
        checksum = model.checksum()  # forces the tail step
        tenant.set_phase("idle")
        return {"tokens": served, "requests": n_req, "token_lat_s": lats,
                "kv_bytes": model.kv_bytes, "checksum": checksum}

    return work


def _prefill_layer(a, w):
    return torch.tanh(a @ w) * 0.99


def prefill_workload(bursts: int, seq: int = 192, d_model: int = 64,
                     steps_per_burst: int = 4, seed: int = 1,
                     gap_s: float = 0.0) -> Callable:
    """A throughput-bound prefill tenant: declares the prefill phase and
    runs ``bursts`` prompt passes, each allocating ``seq`` x ``seq``
    activations (tagged ``"act"``: consumed at the handoff, never
    prefetched back) and multiplying them by a PERSISTENT weight matrix
    that stays hot across bursts. ``d_model`` is accepted for the JAX
    package's signature and sizes nothing there either. Beside the JAX
    package's result keys, ``checksum`` is the f64 sum of the last
    burst's output, which the burst reads back anyway."""

    op = vmem.vop(_prefill_layer)

    def work(tenant):
        rng = np.random.default_rng(seed)
        tenant.set_phase("prefill")
        weights = tenant.arena.array(
            (rng.standard_normal((seq, seq)) / np.sqrt(seq))
            .astype(np.float32))
        done, checksum = 0, 0.0
        for _ in range(bursts):
            act = tenant.arena.array(
                rng.standard_normal((seq, seq)).astype(np.float32))
            act.phase_hint = "act"
            for _ in range(steps_per_burst):
                act = op(act, weights)
                act.phase_hint = "act"  # the op made a new array
                tenant.client.mark_activity()
            # Fence the burst like a returned prompt pass.
            checksum = float(act.numpy().astype(np.float64).sum())
            act.delete()
            done += 1
            if gap_s > 0:
                time.sleep(gap_s)
        tenant.set_phase("idle")
        return {"bursts": done, "act_bytes": seq * seq * 4,
                "weight_bytes": weights.nbytes, "checksum": checksum}

    return work


def gate_wait_samples(names, ring_snapshot) -> dict:
    """Per-tenant exact gate-wait samples (seconds) from a telemetry
    event-ring snapshot. ``names`` maps tenant name -> role; returns
    {role: [seconds, ...]} in arrival order."""
    from nvshare_tpu_torch.telemetry import events as tev

    out: dict = {role: [] for role in set(names.values())}
    for ev in ring_snapshot:
        if ev.kind == tev.GATE_WAIT and ev.who in names:
            try:
                out[names[ev.who]].append(
                    float((ev.args or {}).get("seconds", 0.0)))
            except (TypeError, ValueError):
                pass
    return out


def percentile(samples, q: float) -> Optional[float]:
    """Interpolation-free ceil-rank percentile of ``samples`` (None when
    empty); at q=99 exactly
    :func:`nvshare_tpu_torch.utils.config.ceil_rank_p99`."""
    if not samples:
        return None
    from nvshare_tpu_torch.utils.config import ceil_rank_p99

    if q == 99:
        return ceil_rank_p99(samples)
    s = sorted(samples)
    rank = max(0, -(-int(q) * len(s) // 100) - 1)
    return s[min(rank, len(s) - 1)]
