"""Column-formatted text tables matching the reference layout
(a copy of ``xpic_tpu/diagnostics/tables.py``).

Reference: src/diagnostics/utils/table_diagnostic.{h,cpp} — titles are
left-aligned in their column width, values centered, columns joined by
two spaces, trailing spaces stripped.  In a run over several ranks only
rank 0 writes (:func:`is_writer`); the others format into the null
device, so that every rank runs the same code.
"""

from __future__ import annotations

import os


def is_writer() -> bool:
    """True unless this process is a rank other than 0 of a process
    group: the one process of a run that writes its files."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


class TableDiagnostic:
    def __init__(self, filename: str):
        self.filename = filename
        if is_writer():
            os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
            self._file = open(filename, "w")
        else:
            self._file = open(os.devnull, "w")
        self.titles: list[str] = []
        self.values: list[str] = []
        self._wrote_header = False

    def add(self, width: int, title: str, value, fmt: str = "{: .6e}",
            pos: int = -1) -> None:
        t = f"{title:<{width}.{width}s}"
        v = fmt.format(value)
        v = f"{v:^{width}.{width}s}"
        if pos >= 0:
            self.titles.insert(pos, t)
            self.values.insert(pos, v)
        else:
            self.titles.append(t)
            self.values.append(v)

    def _write_row(self, container: list[str]) -> None:
        line = "  ".join(container[:-1])
        if len(container) > 1:
            line += "  "
        line += container[-1].rstrip()
        self._file.write(line + "\n")

    def commit(self, t: int, diagnose_period: int = 1) -> None:
        if self.values:
            if not self._wrote_header:
                self._write_row(self.titles)
                self._wrote_header = True
            self._write_row(self.values)
            self.titles.clear()
            self.values.clear()
        if diagnose_period and t % diagnose_period == 0:
            self._file.flush()

    def finalize(self) -> None:
        self._file.flush()
        self._file.close()
