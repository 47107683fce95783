"""The readings that a cell's limits are set from, on the chip at the cell's own size.

    python3 benchmark/calibrate.py --workload sim_hybrid.train --seeds 12 --control 3 --out cal.json

For each number that decides a cell's `correct`:

* lower: the program's gap to the reference, one reading a seed (training:
  the set-up is built once and each seed restarts it from that seed's
  weights and inputs, as a run's compared steps do; forecasts: a short run a
  seed, with its checked requests);
* control: the reference in the program's place in the precision below the
  configuration's float32, that is float32 with TF32 matrix products;
* witness (training): the reference itself in float32 without TF32, which
  shows what float32 alone makes of a seed;
* faults: half of each batch left out (the reference on the first half,
  the mean over it), and for forecasts another chunk's answer given for a
  request; a state left unchanged reads 1 on `change` by construction.

Each generator (`generators/<kind>.py`) reads its own cells' readings
(`calibrate`). Prints one JSON object, and writes it to `--out`.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def summary(out: dict) -> dict:
    names = [k for k in out["program"][0] if k not in ("seed", "seconds", "requests")]
    res = {}
    for name in names:
        res[name] = {"lower": max(r[name] for r in out["program"])}
        for kind in out:
            if kind == "witness":
                res[name][kind] = max(r[name] for r in out[kind])
            elif kind != "program" and out[kind]:
                res[name][kind] = min(r[name] for r in out[kind])
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description="the readings a cell's limits are set from")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--first_seed", type=int, default=4_100_000_000)
    p.add_argument("--extra_seeds", type=int, nargs="*", default=[], help="seeds read besides the series")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness import env, spec as spec_mod

    work = env.prepare(ROOT)
    spec = spec_mod.load(args.workload)
    device = env.device(spec.workload["chips"])
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)] + args.extra_seeds
    out = spec_mod.generator(spec.mix["kind"]).calibrate(spec, seeds, args.control, device, ROOT, work,
                                                         args.seconds)
    result = {"workload": args.workload, "card": env.card(device), "summary": summary(out), "runs": out,
              "seconds": time.time() - T_PROCESS}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in ("workload", "card", "summary", "seconds")}), flush=True)


if __name__ == "__main__":
    main()
