"""Run one cell of the benchmark of hybridode_torch and print its result as the last line of standard output.

    python3 benchmark/run.py --workload sim_hybrid.train --seed 7 --seconds 30 --trace 0

The cell (BENCHMARK.json at the root of the checkout) names a configuration
(`benchmark/configs/`, whose `kind` names the modules of its model family
under `reference/`, `costs/` and `builders/`), a traffic mix
(`benchmark/traffic/`, a file of parameters read by the generator
`benchmark/generators/<kind>.py` of its `kind`) and its limits
(`benchmark/limits/<cell>.json`); each per-layer metric has a reader of its
own (`benchmark/metrics/<metric>.py`). With `--trace 0` the line holds the
cell's end-to-end metrics, with `--trace 1` its per-layer metrics and the
device's busy and window seconds. Every run checks what its timed path
produced against the plain reference (`benchmark/reference/`) and prints
each number compared beside its limit, last, on standard error and in the
line. It exits non-zero, printing no result, without a CUDA device, and if
anything of JAX or of the JAX package `hybridode` was loaded.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", required=True, type=int, choices=(0, 1))
    return p.parse_args(argv)


def breakdown(rec: dict) -> dict:
    from benchmark.harness import trace

    if "trace" in rec:
        t = rec["trace"]
        return {"device_ops": trace.top_ops(t["kernels"]), "idle_gaps": trace.idle_gaps(t["kernels"], t["host"])}
    replays = rec.get("replays") or {}
    ops = [[f"{kind} graph replay", sum(replays.get(kind, [])) / 1e3] for kind in ("step", "validation")]
    gaps = sorted(replays.get("gaps", []), key=lambda g: -g[1])[:10]
    return {"device_ops": ops, "idle_gaps": [[name, ms / 1e3] for name, ms in gaps]}


def result(spec, rec: dict, traced: bool, card: dict) -> dict:
    """The last line: correct, attempted, failed, metrics, device, (breakdown), and the compared numbers last."""
    from benchmark.harness import compare, spec as spec_mod

    correct, checks = compare.verdict(rec["values"], spec.limits)
    metrics = {}
    for m in spec.metrics(traced):
        if traced:
            value = spec_mod.reader(m["name"])(rec)
        else:
            value = rec.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if card["kind"] != "cpu" else "cpu", "kind": card["kind"], "count": 1,
              "memory_peak_bytes": rec["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": rec["attempted"], "failed": rec["failed"], "metrics": metrics,
            "device": device}
    if traced:
        if "trace" in rec:
            from benchmark.harness import trace

            device.update(busy_s=trace.busy_s(rec["trace"]["kernels"]), window_s=rec["trace"]["window_s"])
        else:
            replays = rec.get("replays") or {}
            device.update(busy_s=(sum(replays.get("step", [])) + sum(replays.get("validation", []))) / 1e3,
                          window_s=rec["window_s"])
        line["breakdown"] = breakdown(rec)
    line["checks"] = checks
    return line


def main(argv=None, allow_cpu: bool = False, adjust=None) -> dict:
    """One run; -> the result line. For the benchmark's CPU tests, `allow_cpu` skips the look for a GPU and
    `adjust(spec)` may shrink the cell."""
    args = parse(argv)
    if not os.path.isdir(os.path.join(ROOT, "hybridode_torch")):
        raise SystemExit(f"the program under test, hybridode_torch, is not in {ROOT}")
    from benchmark.harness import env

    work = env.prepare(ROOT)
    from benchmark.harness import spec as spec_mod

    spec = spec_mod.load(args.workload)
    if adjust is not None:
        adjust(spec)
    device = env.device(spec.workload["chips"], allow_cpu)
    card = env.card(device)
    generator = spec_mod.generator(spec.mix["kind"])
    rec = generator.run(spec, args.seed, args.seconds, bool(args.trace), device, ROOT, work, T_PROCESS)
    rec.update(spec=spec, device_kind=card["kind"])
    found = env.jax_modules()
    if found:
        raise SystemExit(f"JAX or the JAX package was loaded: {found}")
    line = result(spec, rec, bool(args.trace), card)
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"card": card["kind"], "power_limit": card["power_limit"], "setup_s": rec["setup_s"],
                      "settle_s": rec.get("settle_s"), "window_s": rec["window_s"], "windows_s": rec.get("windows_s"),
                      "reference_trials": rec.get("reference_trials")}))
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
