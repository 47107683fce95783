"""The live share of the trial steps that the captured training step's DOPRI5 solves ran in the measured windows,
in %: the program's own counts, made on the device inside the step graph and read at each window's one read, summed
over its last `validations` window spans (`step_trials_live` over `step_trials_run`)."""

from benchmark.harness import spans


def read(rec):
    n = rec.get("validations")
    if not n:
        return None
    windows = [s for s in spans.recorded() if s.name == "window"][-n:]
    run = sum(w.fields.get("step_trials_run", 0) for w in windows)
    if len(windows) < n or not run:
        return None
    return 100.0 * sum(w.fields.get("step_trials_live", 0) for w in windows) / run
