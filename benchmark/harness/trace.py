"""torch.profiler over a stretch of eager work: the device's kernels, the host's ops, and what they add up to.

The profiler's raw events are read (`kineto_results.events()`): building
its Python tree of events takes minutes on a trace of a million. Never used
on a CUDA graph replay, whose trace ended the process on the H100.
"""

from __future__ import annotations

import gc
import time

TRANSFERS = ("Memcpy", "Memset")


def profile(fn, device) -> dict:
    """fn() under torch.profiler -> {window_s, kernels: [(name, start_us, end_us)], host: [(name, start_us,
    end_us)]}; empty lists off CUDA."""
    import torch
    from torch.profiler import ProfilerActivity

    if device.type != "cuda":
        t = time.perf_counter()
        fn()
        return {"window_s": time.perf_counter() - t, "kernels": [], "host": []}
    torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t
    kernels, host = [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            kernels.append(span)
        else:
            host.append(span)
    del prof
    gc.collect()
    kernels.sort(key=lambda k: k[1])
    return {"window_s": window_s, "kernels": kernels, "host": host}


def busy_s(kernels) -> float:
    """Seconds in which at least one device operation ran: the union of their intervals."""
    total, end = 0.0, None
    for _, s, e in kernels:
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


def compute_kernels(kernels) -> list:
    return [k for k in kernels if not k[0].startswith(TRANSFERS)]


def top_ops(kernels, n: int = 10) -> list:
    """[[name, seconds]] of the device operations that took most time, summed by name."""
    by = {}
    for name, s, e in kernels:
        by[name] = by.get(name, 0.0) + (e - s) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(kernels, host, n: int = 10) -> list:
    """[[what the host was doing, seconds]] of the longest gaps between device operations: each gap named by the
    innermost host op that covers its middle."""
    gaps, end = [], None
    for _, s, e in kernels:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:n]:
        mid = (s + e) / 2
        covering = [h for h in host if h[1] <= mid <= h[2]]
        name = min(covering, key=lambda h: h[2] - h[1])[0] if covering else "host outside any traced op"
        out.append([name, (e - s) / 1e6])
    return out
