"""Leveled stderr logging, parity with the reference's log macros
(grgalex/nvshare src/common.h:17-52): ``[TPUSHARE][LEVEL][tag]`` lines,
DEBUG gated by ``$TPUSHARE_DEBUG`` — same env var the native components use.
"""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "[TPUSHARE][%(levelname)s][%(name)s] %(message)s"
_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    root = logging.getLogger("tpushare")
    root.addHandler(handler)
    root.propagate = False
    debug = os.environ.get("TPUSHARE_DEBUG", "")
    root.setLevel(logging.DEBUG if debug and debug != "0" else logging.INFO)
    _configured = True


def get_logger(tag: str) -> logging.Logger:
    _configure()
    return logging.getLogger(f"tpushare.{tag}")
