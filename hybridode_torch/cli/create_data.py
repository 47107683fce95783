"""Dataset creation CLI: the seed-666 simulation cohorts.

    python -m hybridode_torch.cli.create_data --which train --out data/ [--device c]

Counterpart of hybridode/cli/create_data.py: the same flags, files and
stdout. It builds the train cohort (n=1300), the test cohort (n=2100), its
noise variants (0.4 / 0.8), and the dim8 and dim12 cohorts, one flag each or
all in one process. Each ground truth is one float64 DOPRI5 solve on the GPU;
`--device c` asks for the CPU. The files are the JAX package's format
(either package loads them). `main` returns the cohorts it wrote, by path.
"""

from __future__ import annotations

import argparse
import os

from .. import resolve_device
from ..data import SyntheticCohort, add_noise, make_dim_cohort, make_test_cohort, make_train_cohort


def main(argv=None):
    parser = argparse.ArgumentParser("generate data")
    parser.add_argument("--which", default="all",
                        choices=["all", "train", "test", "noise0.4", "noise0.8", "dim8", "dim12"])
    parser.add_argument("--out", default="data/")
    parser.add_argument("--seed", default=666, type=int)
    parser.add_argument("--device", choices=["0", "1", "c"], default="1", type=str,
                        help="c: solve on the CPU; 0 or 1: solve on the GPU")
    args = parser.parse_args(argv)
    device = resolve_device("cpu" if args.device == "c" else "cuda")

    os.makedirs(args.out, exist_ok=True)
    which = args.which
    written = {}

    def save(cohort, name):
        path = os.path.join(args.out, name)
        cohort.save(path)
        print("wrote", path)
        written[path] = cohort

    if which in ("all", "train"):
        save(make_train_cohort(seed=args.seed, device=device), "datafile_dose_exp.pkl")
    test_path = os.path.join(args.out, "datafile_dose_exp_test.pkl")
    if which in ("all", "test"):
        save(make_test_cohort(seed=args.seed, device=device), "datafile_dose_exp_test.pkl")
    for lvl in (0.4, 0.8):
        if which in ("all", f"noise{lvl}"):
            # Each noise variant starts from the test file, so noise never compounds.
            if not os.path.exists(test_path):
                make_test_cohort(seed=args.seed, device=device).save(test_path)
            noisy = SyntheticCohort.load(test_path, device=device)
            save(add_noise(noisy, lvl, seed=args.seed), f"datafile_dose_noise_{lvl}.pkl")
    if which in ("all", "dim8"):
        save(make_dim_cohort(8, seed=args.seed, device=device), "datafile_dim8.pkl")
    if which in ("all", "dim12"):
        save(make_dim_cohort(12, seed=args.seed, device=device), "datafile_dim12.pkl")
    return written


if __name__ == "__main__":
    main()
