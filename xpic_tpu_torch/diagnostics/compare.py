"""Hold the temporal tables of two runs of one config against each other.

Each column is compared within a relative tolerance of its scale, which
is the column's largest magnitude except for two kinds of cancelled
quantities, whose rounding the cancellation lifts far above the
tolerance of their own size:

* the energy-conservation columns are differences of energies, and the
  closure dE+dB+dK is ~1e-10 of the total energy in float64: a 1e-15
  difference of the energies is 1e-5 of that column.  They are held
  against the total energy wE + wB + sum wK;
* a standard deviation sX = sqrt(<X^2> - <X>^2) of a uniform field (B at
  step 0) is the root of a difference that rounds to 0 or to one ulp.
  The s columns of the energy table are compared squared, against their
  largest square plus the mean square 2 w / n_cells of the energy column
  they belong to;
* where a scheme conserves charge exactly (eccapfim), the continuity
  norms of the charge-conservation table are rounding noise of the
  difference d(rho)/dt + div J.  A caller that knows it passes
  ``charge_scale``, the matching norm of the charge density over dt,
  and those columns are held against it.
"""

from __future__ import annotations

import os

import numpy as np

TABLES = ("energy.txt", "energy_conservation.txt",
          "charge_conservation.txt", "momentum_conservation.txt")


def read_table(path):
    """``(header, rows)`` of a temporal table; rows [n_rows, n_cols]."""
    with open(path) as fh:
        header = fh.readline().split()
        rows = np.loadtxt(fh, ndmin=2)
    return header, rows


def table_errors(table: str, ref_dir, got_dir, n_cells: int,
                 charge_scale: float = 0.0) -> dict:
    """Per-column max |got - ref| / scale of ``temporal/<table>`` under
    two output directories; raises ``ValueError`` when the headers or the
    row counts differ.  ``charge_scale`` (default 0: unused) is the floor
    of the charge-conservation columns' scale."""
    h_ref, ref = read_table(os.path.join(ref_dir, "temporal", table))
    h_got, got = read_table(os.path.join(got_dir, "temporal", table))
    if h_got != h_ref or got.shape != ref.shape:
        raise ValueError(f"{table}: header/shape {h_got} {got.shape} != "
                         f"{h_ref} {ref.shape}")
    _, energies = read_table(os.path.join(ref_dir, "temporal", "energy.txt"))
    n_energy = (energies.shape[1] - 1) // 2  # wE, wB, wK_<species>...
    total = np.abs(energies[:, 1:1 + n_energy].sum(axis=1)).max()
    errs = {}
    for c, name in enumerate(h_ref):
        a, b = got[:, c], ref[:, c]
        scale = np.abs(b).max()
        if table == "energy_conservation.txt":
            scale = max(scale, total)
        elif table == "charge_conservation.txt" and name != "Time":
            scale = max(scale, charge_scale)
        elif table == "energy.txt" and name.startswith("s"):
            w = ref[:, h_ref.index("w" + name[1:])]
            a, b = a * a, b * b
            scale = np.abs(b).max() + 2.0 * np.abs(w).max() / n_cells
        errs[name] = float(np.abs(a - b).max() / max(scale, 1e-300))
    return errs
