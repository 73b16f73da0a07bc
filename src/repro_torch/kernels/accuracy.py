"""How a kernel's output below float32 is held against its plain version:
in units of the last place of its dtype.

The card's checks (``chip_smoke.py`` and the card tests) hold a bfloat16 or
float16 output within one unit of the plain version computed in float64 and
rounded once to the output's dtype: the correctly rounded answer, which a
float32 sum rounded once can miss by at most one unit.
"""

from __future__ import annotations

import torch


def ulp_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| in units of the last place of got's dtype, each
    element scaled by max(1, |ref|)."""
    eps = torch.finfo(got.dtype).eps
    return float(((got.float() - ref.float()).abs() / (eps * ref.float().abs().clamp(min=1.0)))
                 .max())


def within_one_ulp(got: torch.Tensor, exact: torch.Tensor) -> bool:
    """``got`` within one unit in the last place of ``exact`` (the plain
    version in float64), rounded once to got's dtype."""
    return ulp_err(got, exact.to(got.dtype)) <= 1.0
