"""Eval-only CLI: load a simulation checkpoint, run the horizon evaluation, pickle it.

    python -m hybridode_torch.cli.run_eval --method expert --path model/v_ \
        --data_path data_s123/datafile_dose_exp.pkl --result_path model/horizon.pkl

Counterpart of hybridode/cli/run_eval.py: the same flags (`--eval` must be
`y`), `Overall best loss:` on stdout, then `evaluate_horizon` (10 posterior
decodes a patient) over the test fold past t0; with `--result_path` its dict
of numpy arrays (`rmse_x`, `rmse_x_sd`, `cprs_x`, `cprs_x_sd`, each of length
T - t0) is pickled, which a plain `pickle.load` reads in either package.

It runs on the GPU; `--device c` asks for the CPU. The noise comes from a CPU
`torch.Generator` seeded with `--seed`.
"""

from __future__ import annotations

import argparse
import pickle

import torch

from .. import resolve_device
from ..config import EvalConfig, OptimConfig
from ..data import SyntheticCohort
from ..eval import evaluate_horizon
from ..inference import load_checkpoint
from . import common


def run(seed, data_path, data_config, model_method, path, optim_config, eval_config, encoder_output_dim=None,
        result_path=None, device=None) -> dict:
    """-> the dict of `evaluate_horizon` for the checkpoint at `path`."""
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)

    dg = SyntheticCohort.load(data_path, device=device)
    model = common.build_sim_model(model_method, data_config, encoder_output_dim=encoder_output_dim,
                                   ode_method=optim_config.ode_method)
    params, _, best_loss = load_checkpoint(path, model.model_name, device)
    print("Overall best loss: {:.6f}".format(best_loss))

    res = evaluate_horizon(params, model, dg, optim_config.batch_size, eval_config.t0, generator=generator,
                           device=device)
    if result_path is not None:
        with open(result_path, "wb") as f:
            pickle.dump(res, f)
    return res


def main(argv=None):
    parser = argparse.ArgumentParser("PKPD eval")
    parser.add_argument("--method", choices=["expert", "neural", "hybrid"], default="hybrid", type=str)
    parser.add_argument("--device", choices=["0", "1", "c"], default="1", type=str,
                        help="c: run on the CPU; 0 or 1: run on the GPU")
    parser.add_argument("--seed", default=666, type=int)
    parser.add_argument("--sample", default=1000, type=int)
    parser.add_argument("--path", default=None, type=str)
    parser.add_argument("--eval", default="y", type=str)
    parser.add_argument("--batch_size", default=50, type=int)
    parser.add_argument("--t0", default=5, type=int)
    parser.add_argument("--data_config", default=None, type=str)
    parser.add_argument("--encoder_output_dim", default=None, type=int)
    parser.add_argument("--data_path", default="data/datafile_dose_exp_test.pkl", type=str)
    parser.add_argument("--result_path", default=None, type=str)
    args = parser.parse_args(argv)

    if args.eval != "y":
        parser.error("run_eval is eval-only: --eval must be y")
    data_config = common.resolve_data_config(args.data_config, args.sample)
    run(args.seed, args.data_path, data_config, args.method, args.path, OptimConfig(batch_size=args.batch_size),
        EvalConfig(t0=args.t0), args.encoder_output_dim, args.result_path,
        device="cpu" if args.device == "c" else "cuda")


if __name__ == "__main__":
    main()
