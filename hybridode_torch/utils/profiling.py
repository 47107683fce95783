"""Phase timers and a torch.profiler trace (counterpart of hybridode/utils/profiling.py:18, 43).

`PhaseTimer` aggregates wall-clock seconds per named phase across
iterations; `trace_to(logdir)` writes a trace of the code under it that
TensorBoard's PyTorch profiler plugin (or chrome://tracing) reads.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class PhaseTimer:
    """Accumulates wall-clock per named phase; report() prints a summary."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            tot, n = self.totals[name], self.counts[name]
            lines.append(f"{name}: total={tot:.3f}s n={n} mean={tot / max(n, 1) * 1e3:.2f}ms")
        return "\n".join(lines)


@contextlib.contextmanager
def trace_to(logdir: str):
    """Trace the code under the context into `logdir` (CPU ops, and CUDA kernels when a GPU is present).

    A trace with CUDA activity slows every later GPU step of its process by
    ~1.3x, even after its events are collected (measured on an H100 by
    `flow_step_study.py`), so trace after every timed phase of a process,
    never before one.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield
