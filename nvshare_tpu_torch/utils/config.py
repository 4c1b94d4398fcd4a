"""Env-var driven configuration helpers (the same readers as the JAX
package's ``utils/config.py``, kept as a copy so this package never
imports it).

Every tunable in the system is an env var with a compiled-in default, the
configuration model the reference uses throughout (SURVEY.md §5.6 lists its
NVSHARE_* vars); the TPUSHARE_* namespace is documented in README.md.
"""

from __future__ import annotations

import os
import re


def env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if not v:
        return default
    try:
        return int(v)
    except ValueError:
        return default


def env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if not v:
        return default
    try:
        return float(v)
    except ValueError:
        return default


def env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v not in ("0", "false", "no", "off")


_SIZE_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*([kmgt]i?b?|b)?\s*$", re.I)
_MULT = {
    "b": 1,
    "k": 1000, "kb": 1000, "ki": 1 << 10, "kib": 1 << 10,
    "m": 1000 ** 2, "mb": 1000 ** 2, "mi": 1 << 20, "mib": 1 << 20,
    "g": 1000 ** 3, "gb": 1000 ** 3, "gi": 1 << 30, "gib": 1 << 30,
    "t": 1000 ** 4, "tb": 1000 ** 4, "ti": 1 << 40, "tib": 1 << 40,
}


def parse_bytes(text: str) -> int:
    """'12GiB', '1.5g', '4096' → bytes."""
    m = _SIZE_RE.match(text)
    if not m:
        raise ValueError(f"unparseable size {text!r}")
    value, unit = m.groups()
    return int(float(value) * _MULT[(unit or "b").lower()])


def env_bytes(name: str, default: int) -> int:
    v = os.environ.get(name)
    if not v:
        return default
    try:
        return parse_bytes(v)
    except ValueError:
        return default


def ceil_rank_p99(samples):
    """Interpolation-free ceil-rank p99 over a non-empty sequence: with
    fewer than 100 samples this is the max. The JAX package's definition,
    so the two packages' tails mean the same thing."""
    s = sorted(samples)
    if not s:
        raise ValueError("p99 of an empty sample set")
    rank = max(0, -(-99 * len(s) // 100) - 1)
    return s[rank]
