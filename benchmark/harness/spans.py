"""The program's own spans, read in the process that ran it: the ring of its recorder
(`hybridode_torch.utils.logging.RECORDER`).

A span stamps integer nanoseconds on the Unix-epoch clock of torch.profiler's events; the harness's trace
(`harness/trace.py`) holds microseconds on that clock. A program that records no spans gives none here, and the
readers of the metrics built on them then return None.
"""

from __future__ import annotations


def recorded() -> list:
    """The spans the program has recorded in this process, oldest first; [] where it records none."""
    try:
        from hybridode_torch.utils.logging import RECORDER
    except ImportError:
        return []
    return list(RECORDER.spans)


def seconds(s) -> float:
    return (s.t1 - s.t0) / 1e9


def requests(rec: dict, found: list):
    """-> (the window's `evaluate` spans, the traced requests' `evaluate` spans) of a forecast run's record: the
    last `rec["requests"]` that end before the first event of `rec["trace"]`, and the first
    `rec["trace"]["requests"]` that end after it; None without a trace with events, or with fewer spans."""
    trace, n = rec.get("trace"), rec.get("requests")
    if not trace or not n:
        return None
    starts = [e[1] for e in trace["kernels"]] + [e[1] for e in trace["host"]]
    if not starts:
        return None
    first = min(starts)
    evaluates = [s for s in found if s.name == "evaluate" and s.parent is None]
    window = [s for s in evaluates if s.t1 / 1e3 < first][-n:]
    traced = [s for s in evaluates if s.t1 / 1e3 >= first][:trace["requests"]]
    if len(window) < n or len(traced) < trace["requests"]:
        return None
    return window, traced


def under(found: list, name: str, roots: list) -> list:
    """The spans named `name` whose root is one of the spans `roots`."""
    ids = {r.id for r in roots}
    return [s for s in found if s.name == name and s.root in ids]


def union(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(intervals) -> list:
    """The stretches between the union of the intervals, first to last."""
    merged = union(intervals)
    return [(a[1], b[0]) for a, b in zip(merged, merged[1:])]


def overlap(a: list, b: list) -> float:
    """The length that two lists of sorted disjoint intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
