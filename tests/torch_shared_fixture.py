"""Build an expensive module fixture once per test run, however many
pytest-xdist workers ask for it.

Under ``--dist load`` the tests of one module are spread over several
workers, and each worker would build the module's fixtures itself.
:func:`build_once` runs the build in the first worker that asks, into a
directory under the run's base temporary directory, which every worker
of the run shares (xdist gives each worker its own directory below it,
as its documentation shows); the others wait on a file lock, with a
timeout, and then read what the first wrote.  A build writes only numpy
arrays and text tables.  A build that raises marks nothing as done, so
the next worker that asks builds again, and its tests fail as well:
nothing is skipped.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

from filelock import FileLock

# Longer than any fixture build of the suite takes on a loaded machine.
LOCK_TIMEOUT_S = 900


def shared_root(tmp_path_factory) -> Path:
    """The run's base temporary directory: shared by all xdist workers
    of the run, fresh for each run."""
    base = tmp_path_factory.getbasetemp()
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


def build_once(tmp_path_factory, name: str, build) -> Path:
    """Run ``build(root)`` once per test run and return ``root``, the
    directory it wrote into."""
    root = shared_root(tmp_path_factory) / name
    done = root / ".complete"
    with FileLock(f"{root}.lock", timeout=LOCK_TIMEOUT_S):
        if not done.exists():
            shutil.rmtree(root, ignore_errors=True)
            root.mkdir(parents=True)
            build(root)
            done.touch()
    return root
