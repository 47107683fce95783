"""1 - the window's graph replays' device time (CUDA events, step and validation) over the window's seconds, in %:
the device idle between replays, not inside one."""


def read(rec):
    replays = rec.get("replays")
    if not replays:
        return None
    busy_s = (sum(replays["step"]) + sum(replays["validation"])) / 1e3
    return 100.0 * (1.0 - busy_s / rec["window_s"])
