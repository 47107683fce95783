"""Device kernels (transfers left out) in the profiler's trace of the traced requests, over those requests."""

from benchmark.harness import trace


def read(rec):
    t = rec.get("trace")
    if not t or not t["kernels"]:
        return None
    return len(trace.compute_kernels(t["kernels"])) / t["requests"]
