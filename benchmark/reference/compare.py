"""The numbers that decide ``correct``, each against its limit."""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

import torch


def film_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """sum |program - reference| / sum |reference| over the checked
    pixels and channels: the film's error as a share of its light.  A
    pixel that is not finite makes it infinite."""
    p = program.double().reshape(-1)
    r = reference.double().reshape(-1).to(p.device)
    if not bool(torch.isfinite(p).all()):
        return math.inf
    return float((p - r).abs().sum() / r.abs().sum().clamp_min(1e-300))


def rel_gap(program: float, reference: float) -> float:
    """|program - reference| / |reference|; infinite where the program's
    number is not finite."""
    g = abs(program - reference) / max(abs(reference), 1e-300)
    return g if math.isfinite(g) else math.inf


def leaf_gaps(program: Dict[str, torch.Tensor],
              reference: Dict[str, torch.Tensor],
              counted: Sequence[str]) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, against the larger of the reference's norm of that leaf
    and of the median leaf."""
    ref = {n: float(torch.linalg.vector_norm(reference[n].double()))
           for n in reference}
    med = statistics.median(ref.values())
    worst = 0.0
    for n in counted:
        p = float(torch.linalg.vector_norm(program[n].double()))
        if not math.isfinite(p):
            return math.inf
        worst = max(worst, abs(p - ref[n]) / max(ref[n], med, 1e-300))
    return worst


def counted_leaves(first_grad: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is above a thousandth of the median
    leaf's: the others move under Adam by round-off alone."""
    norms = {n: float(torch.linalg.vector_norm(g.double()))
             for n, g in first_grad.items()}
    med = statistics.median(norms.values())
    return [n for n, v in norms.items() if v > 1e-3 * med]


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{"correct": bool, "checks": {name: {"value", "limit"}}}: every
    number at or under its limit, and finite."""
    checks = {n: {"value": numbers[n], "limit": limits[n]} for n in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return {"correct": ok, "checks": checks}
