"""The share of the window's requests' time that their decodes took, in %: the program's `decode` spans over its
`evaluate` spans, for the window's requests (the last `requests` that end before the traced ones)."""

from benchmark.harness import spans


def read(rec):
    found = spans.recorded()
    requests = spans.requests(rec, found)
    if requests is None:
        return None
    window = requests[0]
    total = sum(spans.seconds(s) for s in window)
    decode = sum(spans.seconds(s) for s in spans.under(found, "decode", window))
    return 100.0 * decode / total if total else None
