"""The training window's FLOPs (benchmark/costs: the trial steps the reference needed, not the captured budget) over
its seconds, against the card's FP32 peak outside the tensor cores, in %."""

from benchmark import costs
from benchmark.harness import peaks


def read(rec):
    peak = peaks.of(rec)
    if peak is None or "iterations" not in rec:
        return None
    spec = rec["spec"]
    flops = costs.train_window(spec.config, spec.mix, rec["iterations"], rec["validations"], rec["reference_trials"])
    return None if flops is None else 100.0 * flops / rec["window_s"] / peak["fp32_flops_per_s"]
