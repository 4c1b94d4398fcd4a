"""The native scheduler and CLI, built once before any test runs.

Many tests start ``tpushare-scheduler`` through the session fixture
``native_build``, which runs ``make -C src`` when the binaries are
missing. Under pytest-xdist every worker runs that fixture, so on a fresh
tree several ``make`` runs write the same objects at once and link
half-written ones. Every worker imports every test module before it runs
any test, so this module builds at import time, under an exclusive lock
on one file in the temporary directory: the first worker builds, the
others wait for it and find the binaries in place.
"""

import fcntl
import os
import tempfile

from tests import conftest


def _build_once() -> None:
    lock = os.path.join(tempfile.gettempdir(), "tpushare-native-build.lock")
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            conftest._ensure_native_built()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


_build_once()


def test_scheduler_and_ctl_binaries_exist():
    assert conftest.SCHEDULER_BIN.is_file(), conftest.SCHEDULER_BIN
    assert conftest.CTL_BIN.is_file(), conftest.CTL_BIN
