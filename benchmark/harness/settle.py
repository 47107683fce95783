"""The last part of set-up: the cell's unit of work, repeated until its time settles, so that the window holds only
steady work."""

from __future__ import annotations

import time


def settle(unit, rule: dict) -> list[float]:
    """Call `unit()` (which ends in a read of the device) until two calls in a row agree within `rule["tol"]` of the
    earlier, after at least `rule["min_units"]` calls, or until `rule["max_s"]` seconds have passed -> each call's
    seconds."""
    times, t_start = [], time.perf_counter()
    while True:
        t = time.perf_counter()
        unit()
        times.append(time.perf_counter() - t)
        if len(times) >= rule["min_units"] and abs(times[-1] - times[-2]) <= rule["tol"] * times[-2]:
            return times
        if time.perf_counter() - t_start >= rule["max_s"]:
            return times
