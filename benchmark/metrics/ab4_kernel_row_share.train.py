"""The share of the real-track rows that the captured training step and validation decoded through the explicit-Adams
kernels in the measured windows, in %: the program's own counts, made on the device inside both graphs and read at
each window's one read, summed over its last `validations` window spans (`ab4_kernel_rows` over `ab4_rows_decoded`).
None where the program keeps no such count."""

from benchmark.harness import spans


def read(rec):
    n = rec.get("validations")
    if not n:
        return None
    windows = [s for s in spans.recorded() if s.name == "window"][-n:]
    decoded = sum(w.fields.get("ab4_rows_decoded", 0) for w in windows)
    if len(windows) < n or not decoded:
        return None
    return 100.0 * sum(w.fields.get("ab4_kernel_rows", 0) for w in windows) / decoded
