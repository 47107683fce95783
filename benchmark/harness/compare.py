"""The numbers that decide `correct`: the program's outputs against the reference's, each with its limit."""

from __future__ import annotations

import contextlib
import math
import statistics


def rel_gap(got: float, want: float) -> float:
    """|got - want| / |want|; 0 where neither is finite (both say that the solve diverged), inf where only one is."""
    if not (math.isfinite(got) and math.isfinite(want)):
        return 0.0 if not (math.isfinite(got) or math.isfinite(want)) else math.inf
    return abs(got - want) / max(abs(want), 1e-300)


def worst_leaf_gap(got: dict, want: dict, leaves) -> float:
    """The worst leaf's gap between the program's norm and the reference's, against the larger of that leaf's
    reference norm and the median leaf's."""
    norms = {n: float(want[n].double().norm()) for n in leaves}
    median = statistics.median(norms.values())
    worst = 0.0
    for n in leaves:
        g = float(got[n].double().norm())
        if not math.isfinite(g):
            return math.inf
        worst = max(worst, abs(g - norms[n]) / max(norms[n], median, 1e-300))
    return worst


def moved_leaves(ref_grads: dict) -> list:
    """Leaves whose reference gradient is at least a thousandth of the median leaf's: the others (a bias under
    softmax, a remainder the loss cannot see) move under Adam by round-off alone."""
    norms = {n: float(g.double().norm()) for n, g in ref_grads.items()}
    median = statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= 1e-3 * median]


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """-> (every value finite and within its limit, {name: {"value", "limit"}})."""
    checks = {name: {"value": values[name], "limit": limits[name]["limit"]} for name in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


@contextlib.contextmanager
def tf32():
    """The control's precision: float32 matrix products on the card's TF32 tensor cores."""
    import torch

    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
