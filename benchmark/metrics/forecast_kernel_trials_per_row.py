"""Trial steps a row of the program's eager per-row DOPRI5 kernel launches in this process, over their rows: the
program's counter (`hybridode_torch.ops.roche_dopri5.EAGER`), read once after the window. A program without
the counter, or whose decodes never took the kernel, gives None."""


def read(rec):
    if "requests" not in rec:
        return None
    try:
        from hybridode_torch.ops.roche_dopri5 import EAGER
    except ImportError:
        return None
    counts = EAGER.read()
    return counts["trial_steps"] / counts["rows"] if counts["rows"] else None
