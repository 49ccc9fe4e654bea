"""B-spline particle form factors of orders 0-5 on tensors
(counterpart of ``xpic_tpu/ops/splines.py``).

``shape_radius(order) = (order + 1) / 2`` and the stencil support covers
``shape_width = 2 * radius + 1`` grid points.
"""

from __future__ import annotations

import torch


def shape_radius(order: int) -> float:
    return 0.5 * (order + 1)


def shape_width(order: int) -> int:
    return int(2.0 * shape_radius(order)) + 1


def spline_0(s):
    s = torch.abs(s)
    return torch.where(s <= 0.5, torch.ones_like(s), torch.zeros_like(s))


def spline_1(s):
    s = torch.abs(s)
    return torch.where(s <= 1.0, 1.0 - s, torch.zeros_like(s))


def spline_2(s):
    s = torch.abs(s)
    inner = 0.75 - s * s
    outer = 0.5 * (1.5 - s) ** 2
    return torch.where(s <= 0.5, inner,
                       torch.where(s < 1.5, outer, torch.zeros_like(s)))


def spline_3(s):
    s = torch.abs(s)
    s2 = s * s
    s3 = s2 * s
    inner = (4.0 - 6.0 * s2 + 3.0 * s3) / 6.0
    outer = (2.0 - s) ** 3 / 6.0
    return torch.where(s < 1.0, inner,
                       torch.where(s < 2.0, outer, torch.zeros_like(s)))


def spline_4(s):
    s = torch.abs(s)
    s2 = s * s
    s3 = s2 * s
    s4 = s2 * s2
    r0 = 115.0 / 192.0 - 5.0 / 8.0 * s2 + 0.25 * s4
    r1 = (55.0 + 20.0 * s - 120.0 * s2 + 80.0 * s3 - 16.0 * s4) / 96.0
    r2 = (5.0 - 2.0 * s) ** 4 / 384.0
    z = torch.zeros_like(s)
    return torch.where(s <= 0.5, r0, torch.where(
        s <= 1.5, r1, torch.where(s < 2.5, r2, z)))


def spline_5(s):
    s = torch.abs(s)
    s2 = s * s
    s3 = s2 * s
    s4 = s2 * s2
    s5 = s4 * s
    r0 = 11.0 / 20.0 - 0.5 * s2 + 0.25 * s4 - s5 / 12.0
    r1 = (
        17.0 / 40.0
        + 5.0 / 8.0 * s
        - 7.0 / 4.0 * s2
        + 5.0 / 4.0 * s3
        - 3.0 / 8.0 * s4
        + s5 / 24.0
    )
    r2 = (3.0 - s) ** 5 / 120.0
    z = torch.zeros_like(s)
    return torch.where(s <= 1.0, r0, torch.where(
        s <= 2.0, r1, torch.where(s < 3.0, r2, z)))


SPLINES = (spline_0, spline_1, spline_2, spline_3, spline_4, spline_5)


def spline(order: int):
    """Return the spline callable for a static order 0..5."""
    return SPLINES[order]
