"""Particle velocity update (counterpart of ``xpic_tpu/pushers.py``,
the electromagnetic Boris ``update_vEB`` only).  ``p`` is velocity in
units of c (non-relativistic)."""

from __future__ import annotations

import torch


def update_vEB(dt, qm, p, E, B):
    """Electromagnetic Boris update:
    w = v + a/2;  v += a + (b x w + 0.5 b x (b x w)) / (1 + b^2/4)
    with a = dt*qm*E, b = -dt*qm*B."""
    alpha = dt * qm
    a = alpha * E
    b = -alpha * B
    w = p + 0.5 * a
    b2 = torch.sum(b * b, dim=-1, keepdim=True)
    bxw = torch.linalg.cross(b, w)
    return p + a + (bxw + 0.5 * torch.linalg.cross(b, bxw)) / (1.0 + 0.25 * b2)
