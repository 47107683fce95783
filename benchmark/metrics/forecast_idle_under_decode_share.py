"""Of the device's idle time between the operations of the profiler's trace of the traced requests, the share that
lies inside the program's `decode` spans of those requests, in % (spans and trace on one clock): how much of the
idle device waits on the host's decode."""

from benchmark.harness import spans


def read(rec):
    found = spans.recorded()
    requests = spans.requests(rec, found)
    if requests is None:
        return None
    idle = spans.gaps([(s, e) for _, s, e in rec["trace"]["kernels"]])
    total = sum(e - s for s, e in idle)
    if not total:
        return None
    decodes = spans.union((s.t0 / 1e3, s.t1 / 1e3) for s in spans.under(found, "decode", requests[1]))
    return 100.0 * spans.overlap(idle, decodes) / total
