"""A cell cut to a size the CPU runs in seconds, for the benchmark's own tests (widths kept, patients and draws cut)."""


def adjust(spec):
    cohort, mix = spec.config["cohort"], spec.mix
    if mix["kind"] == "train":
        cohort.update(train=64, val=16) if spec.config["kind"] == "sim" else cohort.update(train=64, val=16, test=16)
        mix.update(batch_size=8, test_freq=2, ring=8, settle=dict(mix["settle"], max_s=0))
    else:
        cohort.update(test=16)
        mix.update(patients_per_request=8, mc_itr=5, checked_requests=2, traced_requests=1,
                   settle=dict(mix["settle"], requests=1, max_s=0))


def run(workload: str, trace: int = 0, seed: int = 3_000_000_019, seconds: float = 1.0) -> dict:
    from benchmark import run as bench_run

    return bench_run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--trace",
                           str(trace)], allow_cpu=True, adjust=adjust)
