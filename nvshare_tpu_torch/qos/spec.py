"""QoS spec: the ``TPUSHARE_QOS=class:weight`` declaration.

One tenant's quality-of-service contract is two numbers:

  * a **latency class** — ``interactive`` (decode/serving: cares about
    gate-wait latency, may preempt batch holders within the scheduler's
    bounded budget) or ``batch`` (training/throughput: cares about
    aggregate occupancy);
  * an **entitlement weight** (1..255) — under the scheduler's WFQ policy
    each tenant's long-run occupancy converges to
    ``weight_i / sum(weights)`` of the contended window.

The spec travels in the HIGH bits of the REGISTER capability arg
(:data:`~nvshare_tpu_torch.runtime.protocol.CAP_QOS` — zero new frames, zero
new fields; unset keeps the byte-for-byte reference wire exchange). This
module is the single Python parser/validator/encoder, shared by
``colocate.Tenant``, both client runtimes, ``interpose`` (via the
runtime's env default), and the ``qos`` report tool; ``src/client.cpp``
mirrors the grammar for the native runtime.

Grammar::

    spec     := class [":" weight]
    class    := "interactive" | "batch"
    weight   := integer in [1, 255]        (default 1)

Examples: ``interactive:2``, ``batch:1``, ``interactive``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

from nvshare_tpu_torch.runtime.protocol import (
    CAP_QOS,
    QOS_CLASS_BATCH,
    QOS_CLASS_INTERACTIVE,
    QOS_CLASS_MASK,
    QOS_CLASS_SHIFT,
    QOS_WEIGHT_MASK,
    QOS_WEIGHT_SHIFT,
)
from nvshare_tpu_torch.utils import get_logger

log = get_logger("qos")

ENV = "TPUSHARE_QOS"

#: class name <-> wire id. New classes append here AND in comm.hpp.
CLASS_IDS = {"batch": QOS_CLASS_BATCH, "interactive": QOS_CLASS_INTERACTIVE}
CLASS_NAMES = {v: k for k, v in CLASS_IDS.items()}
#: The short class tokens the scheduler emits in fairness rows
#: (``qos=int`` / ``qos=bat``) — kept to 3 chars so the row's met/paging
#: tail survives the fixed wire frame.
ROW_TOKENS = {QOS_CLASS_BATCH: "bat", QOS_CLASS_INTERACTIVE: "int"}
TOKEN_CLASSES = {v: k for k, v in ROW_TOKENS.items()}

MIN_WEIGHT, MAX_WEIGHT = 1, QOS_WEIGHT_MASK


@dataclass(frozen=True)
class QosSpec:
    """A validated class + weight pair."""

    klass: int   # QOS_CLASS_BATCH / QOS_CLASS_INTERACTIVE
    weight: int  # 1..255

    @property
    def class_name(self) -> str:
        return CLASS_NAMES.get(self.klass, f"class-{self.klass}")

    @property
    def interactive(self) -> bool:
        return self.klass == QOS_CLASS_INTERACTIVE

    def to_caps(self) -> int:
        """The REGISTER-arg bits declaring this spec (OR into caps)."""
        return (CAP_QOS
                | ((self.klass & QOS_CLASS_MASK) << QOS_CLASS_SHIFT)
                | ((self.weight & QOS_WEIGHT_MASK) << QOS_WEIGHT_SHIFT))

    @staticmethod
    def from_caps(arg: int) -> Optional["QosSpec"]:
        """Decode a REGISTER capability arg; None when CAP_QOS is absent
        (every pre-QoS client)."""
        if not arg & CAP_QOS:
            return None
        klass = (arg >> QOS_CLASS_SHIFT) & QOS_CLASS_MASK
        weight = (arg >> QOS_WEIGHT_SHIFT) & QOS_WEIGHT_MASK
        return QosSpec(klass=klass if klass in CLASS_NAMES
                       else QOS_CLASS_BATCH,
                       weight=weight if weight >= MIN_WEIGHT else 1)

    def __str__(self) -> str:
        return f"{self.class_name}:{self.weight}"


def parse_qos(text: str) -> Optional[QosSpec]:
    """``"interactive:2"`` -> QosSpec. ``""``/None -> None (undeclared).

    Raises :class:`ValueError` on anything else — callers passing an
    explicit spec (``Tenant(qos=...)``) want the typo surfaced; env-driven
    callers go through :func:`from_env`, which degrades loudly instead.
    """
    if not text:
        return None
    cls_name, _, weight_s = text.strip().partition(":")
    if cls_name not in CLASS_IDS:
        raise ValueError(
            f"unknown QoS class {cls_name!r} in {text!r} "
            f"(want one of {sorted(CLASS_IDS)})")
    weight = 1
    if weight_s:
        try:
            weight = int(weight_s)
        except ValueError:
            raise ValueError(f"QoS weight {weight_s!r} in {text!r} "
                             "is not an integer") from None
    if not MIN_WEIGHT <= weight <= MAX_WEIGHT:
        raise ValueError(f"QoS weight {weight} in {text!r} out of range "
                         f"[{MIN_WEIGHT}, {MAX_WEIGHT}]")
    return QosSpec(klass=CLASS_IDS[cls_name], weight=weight)


def coerce(spec) -> Optional[QosSpec]:
    """Accept a QosSpec, a spec string, or None (explicit-param callers)."""
    if spec is None or isinstance(spec, QosSpec):
        return spec
    return parse_qos(str(spec))


def from_env() -> Optional[QosSpec]:
    """The process default from ``$TPUSHARE_QOS``. A malformed value
    warns loudly and returns None (the tenant stays on reference FIFO):
    a typo must not take a production tenant down, but silently running
    the wrong arbitration experiment is worse than a log line — mirrors
    the native runtime's fallback (src/client.cpp)."""
    text = os.environ.get(ENV, "")
    if not text:
        return None
    try:
        return parse_qos(text)
    except ValueError as e:
        log.warning("ignoring %s=%r (%s) — tenant keeps reference FIFO "
                    "arbitration", ENV, text, e)
        return None


def entitled_shares(weights: dict) -> dict:
    """``{name: weight}`` -> ``{name: entitled share in [0, 1]}``.
    Undeclared tenants (weight None/0) count as weight 1 — exactly how
    the scheduler's WFQ treats them."""
    eff = {n: (w if isinstance(w, int) and w >= 1 else 1)
           for n, w in weights.items()}
    total = sum(eff.values())
    if total <= 0:
        return {}
    return {n: w / total for n, w in eff.items()}
