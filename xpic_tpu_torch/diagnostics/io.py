"""Binary dump I/O for the field/moment diagnostics
(a copy of ``xpic_tpu/diagnostics/io.py``).

The reference overlaps dump I/O with compute through MPI-IO
(src/utils/mpi_binary_file.{h,cpp}); the runtime's equivalent is the
native background-thread writer (native/xpic_native.cpp AsyncWriter):
``submit`` copies the buffer and returns immediately, so the main loop
dispatches the next step while the file hits disk.  Falls back to a
synchronous ``tofile`` when the native library is unavailable.  In a
run over several ranks only rank 0 writes (``tables.is_writer``).
"""

from __future__ import annotations

import numpy as np

_writer = None  # None = not tried, False = unavailable


def binary_dump(path: str, data: np.ndarray) -> None:
    """Write ``data`` to ``path``, in the background when possible."""
    global _writer
    from .tables import is_writer

    if not is_writer():
        return
    if _writer is None:
        try:
            from ..runtime.native import AsyncWriter

            _writer = AsyncWriter()
        except Exception:
            _writer = False
    if _writer:
        _writer.submit(path, np.ascontiguousarray(data))
    else:
        data.tofile(path)


def flush_dumps() -> int:
    """Join all pending background writes; returns bytes written since
    the last flush (0 when the synchronous fallback was used)."""
    if _writer:
        return _writer.flush()
    return 0
