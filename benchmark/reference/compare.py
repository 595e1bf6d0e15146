"""The numbers that decide ``correct``."""

from __future__ import annotations

import math
from typing import Dict, Iterable, Sequence, Tuple

import torch


def pred_error(pairs: Iterable[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]) -> float:
    """``sqrt(sum |p - r|^2 / sum |r - s|^2)`` over ``(program, reference,
    skip)`` HR predictions: the program's error against the reference's own
    part of the prediction (what the network adds to the bilinear skip)."""
    num = den = 0.0
    for p, r, s in pairs:
        r64 = r.double()
        num += float((p.double().to(r64.device) - r64).square().sum())
        den += float((r64 - s.double().to(r64.device)).square().sum())
    return math.sqrt(num / den) if den > 0 else float("inf")


def leaf_gap(program: Dict[str, float], reference: Dict[str, float],
             leaves: Sequence[str]) -> Tuple[float, str]:
    """The worst leaf's ``|a - b| / max(b, median b)`` of per-leaf norms ``a``
    (the program's) and ``b`` (the reference's), and that leaf's name."""
    ref = sorted(reference[k] for k in leaves)
    med = ref[len(ref) // 2] if ref else 0.0
    worst, which = 0.0, ""
    for k in leaves:
        a, b = program.get(k, float("nan")), reference[k]
        g = abs(a - b) / max(b, med) if max(b, med) > 0 else float("inf")
        if not g <= worst:  # NaN counts as the worst
            worst, which = g, k
            if math.isnan(g):
                worst = float("inf")
    return worst, which
