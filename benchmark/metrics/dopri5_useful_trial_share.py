"""Trial steps the window's last batch needs (the program's Dopri5Stats of one eager decode at the final parameters)
over the trial steps the captured step runs for them (its budget for every patient), in %."""


def read(rec):
    trials = rec.get("dopri5_program_trials")
    if not trials:
        return None
    return 100.0 * sum(trials) / (len(trials) * rec["dopri5_budget"])
