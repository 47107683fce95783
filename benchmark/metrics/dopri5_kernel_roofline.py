"""The per-row DOPRI5 kernel's share of its roofline, in %: the FLOPs of one launch (`benchmark/costs/dopri5_kernel`,
at the rows a launch and the trial steps a row of the program's eager counter) over the mean device time of the
trace's `roche_dopri5_kernel` launches, against the card's FP32 peak outside the tensor cores (the kernel's bytes are
negligible, so FP32 is its bound). None without such launches in the trace or without the program's counter."""

from benchmark.costs import dopri5_kernel
from benchmark.harness import peaks

KERNEL = "roche_dopri5_kernel"


def read(rec):
    peak, t = peaks.of(rec), rec.get("trace")
    if peak is None or not t:
        return None
    launches = [e - s for name, s, e in t["kernels"] if KERNEL in name]
    if not launches:
        return None
    try:
        from hybridode_torch.ops.roche_dopri5 import EAGER
    except ImportError:
        return None
    counts = EAGER.read()
    if not counts["launches"] or not counts["rows"]:
        return None
    cfg = rec["spec"].config
    flops = dopri5_kernel.flops(counts["rows"] / counts["launches"], counts["trial_steps"] / counts["rows"],
                                cfg["latent_dim"], cfg["expert_dim"])
    seconds = sum(launches) / len(launches) / 1e6
    return 100.0 * flops / seconds / peak["fp32_flops_per_s"]
