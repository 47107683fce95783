"""Host seconds of the eager warm-up calls that come before the captures of the step and validation graphs: the
program's `warmup` spans under its last `restart` span, in set-up."""

from benchmark.harness import spans


def read(rec):
    if "iterations" not in rec:
        return None
    found = spans.recorded()
    restarts = [s for s in found if s.name == "restart"]
    warm = spans.under(found, "warmup", restarts[-1:])
    return sum(spans.seconds(s) for s in warm) if warm else None
