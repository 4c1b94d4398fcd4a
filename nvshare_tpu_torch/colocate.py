"""Multi-tenant co-location harness (in-process tenants).

The port of ``nvshare_tpu/colocate.py``: one process owns the card and
hosts several tenants, each with its *own* :class:`VirtualHBM` arena and
its own scheduler registration, arbitrated by the real
``tpushare-scheduler``. Each hand-off swaps the outgoing tenant's working
set out for the incoming one's. (Process tenants, each its own process,
run ``python -m nvshare_tpu_torch.bench_tenant``.) Workloads: the burners,
an LM serving requests (:func:`lm_workload`) and an LM training
(:func:`lm_train_workload`).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from nvshare_tpu_torch import interpose, vmem
from nvshare_tpu_torch.device import DeviceLike
from nvshare_tpu_torch.pager import client_callbacks, maybe_attach_pager
from nvshare_tpu_torch.runtime.client import PurePythonClient
from nvshare_tpu_torch.utils import get_logger

log = get_logger("colocate")


class Tenant:
    """One tenant: an arena (its virtual device memory) + a scheduler
    registration.

    ``budget_bytes`` is this tenant's view of capacity; with N tenants
    oversubscribing, each still sees the whole budget. ``pool`` models the
    one card's physical memory shared by every co-located tenant. ``name``
    doubles as the telemetry label. ``use_pager`` attaches the proactive
    pager (default: ``$TPUSHARE_PAGER``). ``qos`` is this tenant's QoS
    declaration (``"interactive:2"``, ``"batch:1"`` or a
    :class:`~nvshare_tpu_torch.qos.QosSpec`), per tenant because
    in-process tenants share one environment; default
    ``$TPUSHARE_QOS``, and None/unset declares nothing (FIFO).
    """

    def __init__(self, name: str, budget_bytes: Optional[int] = None,
                 device: DeviceLike = None,
                 pool: Optional[vmem.PhysicalPool] = None,
                 use_pager: Optional[bool] = None, qos=None):
        self.arena = vmem.VirtualHBM(device=device,
                                     budget_bytes=budget_bytes,
                                     pool=pool, name=name)
        # The arena may have deduped a reused name (job -> job-2); the
        # tenant AND its client carry the arena's final label.
        self.name = self.arena.name
        # The same wiring site as interpose.client(): the pager (if
        # enabled) overrides the handoff callbacks, and its threads start
        # only at bind_client, once the client below exists.
        self.pager = maybe_attach_pager(self.arena, enabled=use_pager)
        self.client = PurePythonClient(
            job_name=self.arena.name, qos=qos,
            **client_callbacks(self.arena, self.pager))
        self.qos = self.client.qos
        if self.pager is not None:
            self.pager.bind_client(self.client)

    def set_phase(self, phase: Optional[str]) -> None:
        """Declare this tenant's serving phase (``"idle"``/``"prefill"``/
        ``"decode"``/None) on both planes: the arena's KV-residency
        eviction order and, when ``$TPUSHARE_PHASE=1`` armed the wire
        capability, the scheduler's PHASE_INFO advisory. None is idle on
        the wire."""
        self.arena.set_phase(phase)
        self.client.set_phase("idle" if phase is None else phase)

    def run(self, workload: Callable[["Tenant"], object]):
        """Run ``workload(self)``; every managed op inside gates through
        THIS tenant's client (thread-local override)."""
        try:
            with interpose.tenant_context(self.client, self.arena):
                return workload(self)
        finally:
            self.client.release_now()

    def telemetry_snapshot(self) -> dict:
        """This tenant's paging counters (legacy stats keys)."""
        return self.arena.telemetry_snapshot()

    def close(self) -> None:
        self.client.shutdown()
        # Retire the arena too, so the shared pool does not leak capacity.
        self.arena.close()


@dataclass
class ColocationReport:
    names: list
    walls: dict = field(default_factory=dict)
    makespan_s: float = 0.0
    results: dict = field(default_factory=dict)
    errors: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.errors


def run_colocated(tenants_workloads: dict, timeout_s: float = 3600
                  ) -> ColocationReport:
    """Run ``{tenant: workload}`` concurrently (one thread per tenant) and
    report per-tenant walls + total makespan."""
    report = ColocationReport(names=[t.name for t in tenants_workloads])

    def runner(tenant: Tenant, workload):
        t0 = time.time()
        try:
            report.results[tenant.name] = tenant.run(workload)
        except Exception as e:  # report, don't kill the harness
            log.error("tenant %s failed: %s", tenant.name, e)
            report.errors[tenant.name] = e
        finally:
            report.walls[tenant.name] = time.time() - t0

    threads = [
        threading.Thread(target=runner, args=(t, w), name=f"tenant-{t.name}")
        for t, w in tenants_workloads.items()
    ]
    t0 = time.time()
    for th in threads:
        th.start()
    deadline = t0 + timeout_s
    for th in threads:
        th.join(timeout=max(0.0, deadline - time.time()))
        if th.is_alive():
            # A hung tenant is a failure, not a silently-missing result.
            name = th.name.removeprefix("tenant-")
            report.errors[name] = TimeoutError(
                f"tenant {name} still running after {timeout_s:.0f}s")
    report.makespan_s = time.time() - t0
    return report


def burner_workload(kind: str, wss_bytes: int, steps: int,
                    chunks: int = 8, device_ratio: float = 0.9
                    ) -> Callable[[Tenant], object]:
    """A gated burner workload for :func:`run_colocated`."""
    from nvshare_tpu_torch.models.burner import (
        AddBurner,
        MatmulBurner,
        MixBurner,
    )

    cls = {"matmul": MatmulBurner, "add": AddBurner, "mix": MixBurner}[kind]

    def work(tenant: Tenant):
        burner = cls(wss_bytes, chunks=chunks, arena=tenant.arena,
                     device_ratio=device_ratio)
        return burner.run(
            steps, step_hook=lambda _s: tenant.client.mark_activity())

    return work


@dataclass
class LMResult:
    """What an LM serving tenant answered: per request, the f64 sum of the
    scoring logits and the greedily decoded tokens; host-clock seconds of
    each part (each request ends in a readback, so they include the
    device's work)."""

    checksums: list
    tokens: np.ndarray          # [requests, decode_batch, decode_tokens]
    score_s: list
    decode_s: list
    wall_s: float

    @property
    def passed(self) -> bool:
        return bool(np.isfinite(self.checksums).all())


def _score_sum(params: dict, model, tokens: torch.Tensor) -> torch.Tensor:
    """One scoring forward, reduced on the device to the f64 sum of its
    logits (the logits themselves are never adopted by the arena)."""
    from nvshare_tpu_torch.models.transformer import transformer_forward

    return transformer_forward(params, model, tokens).sum(
        dtype=torch.float64)


def lm_workload(model, *, requests: int, score_batch: int,
                decode_batch: int, decode_tokens: int,
                max_len: Optional[int] = None, seed: int = 0
                ) -> Callable[[Tenant], LMResult]:
    """A gated LM serving workload for :func:`run_colocated`.

    The tenant creates its parameters and a KV cache of ``decode_batch`` x
    ``max_len`` (default ``model.seq``) on its device, through ``vop``s
    whose dict outputs its arena adopts. Each request then scores
    ``score_batch`` sequences of ``model.seq`` tokens with
    :func:`transformer_forward` (the flash kernel once per layer) and
    decodes ``decode_tokens`` greedy tokens for ``decode_batch`` streams
    against the donated cache, continuing one session from request to
    request. Every value is a function of ``seed``, so a co-located run
    must reproduce a solo run bit for bit.
    """
    from nvshare_tpu_torch.models.decode import greedy_step, init_kv_cache
    from nvshare_tpu_torch.models.transformer import synthetic_tokens

    max_len = model.seq if max_len is None else max_len
    if requests * decode_tokens > max_len:
        raise ValueError(f"{requests} requests of {decode_tokens} tokens "
                         f"overrun a cache of {max_len} positions")

    def work(tenant: Tenant) -> LMResult:
        a = tenant.arena
        t_start = time.perf_counter()
        params = vmem.vop(lambda dev: model.init(seed, device=dev))(a.device)
        cache = vmem.vop(lambda dev: init_kv_cache(
            model, decode_batch, max_len, device=dev))(a.device)
        score = vmem.vop(_score_sum, static_argnums=(1,))
        step = vmem.vop(greedy_step, static_argnums=(1,),
                        donate_argnums=(2,))
        first = synthetic_tokens(model, decode_batch, seed)[:, 0]
        token = a.array(first.astype(np.int64))
        checksums, tokens, score_s, decode_s = [], [], [], []
        for r in range(requests):
            batch = a.array(synthetic_tokens(
                model, score_batch, seed + 1 + r)[:, :model.seq])
            t0 = time.perf_counter()
            checksums.append(float(score(params, model, batch).numpy()))
            t1 = time.perf_counter()
            out = []
            for t in range(decode_tokens):
                token, cache = step(params, model, cache,
                                    r * decode_tokens + t, token)
                out.append(token)
            tokens.append(np.stack(vmem.tree_numpy(out), axis=1))
            decode_s.append(time.perf_counter() - t1)
            score_s.append(t1 - t0)
            batch.delete()
            tenant.client.mark_activity()
        # The server shuts down: its state goes, and is not paged out.
        for va in [*params.values(), *cache.values(), token]:
            va.delete()
        return LMResult(checksums, np.stack(tokens), score_s, decode_s,
                        time.perf_counter() - t_start)

    return work


@dataclass
class LMTrainResult:
    """What an LM training tenant did: the loss of every step, the f64 sum
    of its final parameters and momentum, and host-clock seconds of each
    step (each ends in reading its loss back, so they include the
    device's work)."""

    losses: list
    checksum: float
    step_s: list
    wall_s: float

    @property
    def passed(self) -> bool:
        return bool(np.isfinite(self.losses).all()
                    and np.isfinite(self.checksum))


def _state_sum(params: dict, opt_state: dict) -> torch.Tensor:
    """The f64 sum of every parameter and momentum entry, on the device."""
    leaves = [*params.values(), *opt_state["m"].values()]
    return torch.stack([x.sum(dtype=torch.float64) for x in leaves]).sum()


def lm_train_workload(model, *, steps: int, batch: int, lr: float = 1e-2,
                      seed: int = 0) -> Callable[[Tenant], LMTrainResult]:
    """A gated LM training workload for :func:`run_colocated`.

    The tenant creates ``init_lm_state(model, seed)`` on its device
    through a ``vop`` whose outputs its arena adopts. Each step is
    ``vop(lm_train_step, static_argnums=(3,), donate_argnums=(0, 1))`` on
    a fresh ``synthetic_tokens(model, batch, seed + 1 + s)`` batch, the
    parameters and momentum updated in place. Every value is a function
    of ``seed``, so a co-located run must reproduce a solo run bit for
    bit.
    """
    from nvshare_tpu_torch.models.transformer import (
        init_lm_state,
        lm_train_step,
        synthetic_tokens,
    )

    def work(tenant: Tenant) -> LMTrainResult:
        a = tenant.arena
        t_start = time.perf_counter()
        params, opt_state = vmem.vop(
            lambda dev: init_lm_state(model, seed, device=dev))(a.device)
        step = vmem.vop(lm_train_step, static_argnums=(3,),
                        donate_argnums=(0, 1))
        losses, step_s = [], []
        for s in range(steps):
            tokens = a.array(synthetic_tokens(model, batch, seed + 1 + s))
            t0 = time.perf_counter()
            params, opt_state, loss = step(params, opt_state, tokens, model,
                                           lr)
            losses.append(float(loss.numpy()))
            step_s.append(time.perf_counter() - t0)
            tokens.delete()
            loss.delete()
            tenant.client.mark_activity()
        checksum = float(vmem.vop(_state_sum)(params, opt_state).numpy())
        # The job ends: its state goes, and is not paged out.
        for va in [*params.values(), *opt_state["m"].values()]:
            va.delete()
        return LMTrainResult(losses, checksum, step_s,
                             time.perf_counter() - t_start)

    return work
