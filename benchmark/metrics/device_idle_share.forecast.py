"""1 - the union of the device's operations in the profiler's trace over the traced requests' seconds, in %."""

from benchmark.harness import trace


def read(rec):
    t = rec.get("trace")
    if not t or not t["kernels"]:
        return None
    return 100.0 * (1.0 - trace.busy_s(t["kernels"]) / t["window_s"])
