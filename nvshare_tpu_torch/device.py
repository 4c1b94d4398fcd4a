"""Explicit device resolution for every entry point of the port.

Entry points take a ``device`` argument that defaults to ``cuda``. Only an
explicit ``cpu`` runs on the CPU (the tests ask for it); asking for CUDA
on a machine without a usable card raises instead of quietly running the
work on the CPU, so a measurement can never be taken on the wrong device.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a :class:`torch.device` (default ``cuda``).

    ``cuda`` without an index means the current card. Raises
    :class:`RuntimeError` when CUDA is asked for and unavailable, and
    :class:`ValueError` for any device type other than ``cuda``/``cpu``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(
            f"unsupported device {dev}: nvshare_tpu_torch runs on 'cuda' "
            "or, when asked explicitly, on 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def generator(device: torch.device, seed: int) -> torch.Generator:
    """A seeded :class:`torch.Generator` on ``device`` (random data is
    drawn from an explicit generator, never the global one)."""
    return torch.Generator(device=device).manual_seed(int(seed))

