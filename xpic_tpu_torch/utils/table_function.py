"""Tabulated 1-D function with linear interpolation from a binary file
(counterpart of ``xpic_tpu/utils/table_function.py``).

Reference: src/utils/table_function.{h,cpp} — the file layout is an
(xmin, xmax, dx) float64 header followed by the value array.  The values
are a float64 tensor on the CPU; ``get_value`` evaluates on the device
and in the dtype of a tensor argument.
"""

from __future__ import annotations

import numpy as np
import torch


class TableFunction:
    def __init__(self, filename: str | None = None):
        self.xmin = 0.0
        self.xmax = 0.0
        self.dx = 1.0
        self.values = torch.zeros((1,), dtype=torch.float64)
        if filename is not None:
            self.evaluate_from_file(filename)

    def evaluate_from_file(self, filename: str) -> None:
        raw = np.fromfile(filename, dtype=np.float64)
        if raw.size < 4:
            raise ValueError(f"{filename}: too short for a table function")
        self.xmin, self.xmax, self.dx = raw[0], raw[1], raw[2]
        self.values = torch.from_numpy(raw[3:].copy())
        n_expected = int(round((self.xmax - self.xmin) / self.dx)) + 1
        if self.values.shape[0] < n_expected:
            raise ValueError(
                f"{filename}: {self.values.shape[0]} values for "
                f"{n_expected} grid points"
            )

    @classmethod
    def from_arrays(cls, xmin: float, dx: float, values) -> "TableFunction":
        tf = cls()
        tf.xmin = float(xmin)
        tf.dx = float(dx)
        tf.values = torch.as_tensor(values, dtype=torch.float64)
        tf.xmax = tf.xmin + (tf.values.shape[0] - 1) * tf.dx
        return tf

    def save(self, filename: str) -> None:
        header = np.array([self.xmin, self.xmax, self.dx], dtype=np.float64)
        np.concatenate([header, self.values.cpu().numpy()]).tofile(filename)

    def scale_coordinates(self, scale: float) -> None:
        self.xmin *= scale
        self.xmax *= scale
        self.dx *= scale

    def scale_values(self, scale: float) -> None:
        self.values = self.values * scale

    def get_value(self, x):
        """Linearly interpolated value(s); clamps to the table range
        (matching the reference's edge behavior)."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x, dtype=torch.float64)
        values = self.values.to(device=x.device, dtype=x.dtype)
        # dx as a device tensor: CUDA divides by a host scalar through its
        # reciprocal, which can move a point on a grid node to the next
        # interval.
        dx = torch.tensor(self.dx, dtype=x.dtype, device=x.device)
        t = (x - self.xmin) / dx
        n = values.shape[0]
        i0 = torch.clamp(torch.floor(t).to(torch.int64), 0, n - 2)
        frac = torch.clamp(t - i0, 0.0, 1.0)
        return values[i0] * (1.0 - frac) + values[i0 + 1] * frac
