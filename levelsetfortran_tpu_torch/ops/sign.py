"""Smeared sign function (port of ``levelsetfortran_tpu/ops/sign.py``;
reference ``subs.f90:152-172``, gM enters unsquared as written; the
commented-out hard sign is :func:`hard_sign`)."""

from __future__ import annotations

import torch


def smeared_sign(ps: torch.Tensor, dx, grad_mag) -> torch.Tensor:
    """``pS / sqrt(pS^2 + dx^2 * gM)`` (subs.f90:169), denominator floored
    so the degenerate point gives 0 instead of NaN."""
    denom = torch.sqrt(ps * ps + dx * dx * grad_mag)
    return ps / torch.clamp_min(denom, 1e-30)


def hard_sign(ps: torch.Tensor) -> torch.Tensor:
    """Non-smeared sign (the commented-out branch, subs.f90:160-166)."""
    return torch.sign(ps)
