"""The window's requests' FLOPs (benchmark/costs; DOPRI5 at the trial steps the reference needed) over its seconds,
against the card's FP32 peak outside the tensor cores, in %."""

from benchmark import costs
from benchmark.harness import peaks


def read(rec):
    peak = peaks.of(rec)
    if peak is None or "requests" not in rec:
        return None
    spec = rec["spec"]
    flops = costs.forecast_request(spec.config, spec.mix, rec["reference_trials"])
    return None if flops is None else 100.0 * rec["requests"] * flops / rec["window_s"] / peak["fp32_flops_per_s"]
