"""Simulation-study NNLS ensemble of a trained expert model and a trained neural model.

    python -m hybridode_torch.cli.run_simulation_ensemble --path model/v_ \
        --data_path data_s123/datafile_dose_exp.pkl

Counterpart of hybridode/cli/run_simulation_ensemble.py: both members load
their checkpoints from `--path` (as `run_simulation --method expert|neural`
wrote them), one NNLS weight pair per step past t0 is learned on the first
`--sample` patients of the val fold (the FULL sequence encoded to the
posterior mean), `Ensemble weights learned.` is printed, then
`evaluate_ensemble` prints the 4-line CSV; with `--horizon` the dict of
`evaluate_ensemble_horizon` is pickled to `--result_path` instead.
`--horizon` keeps the JAX flag's `type=bool` (any non-empty value is true).

It runs on the GPU; `--device c` asks for the CPU. The noise comes from a CPU
`torch.Generator` seeded with `--seed`, after the two members' random
initialisations.
"""

from __future__ import annotations

import argparse
import pickle

import torch

from .. import resolve_device
from ..config import EvalConfig, OptimConfig
from ..data import SyntheticCohort
from ..ensembles import learn_ensemble_weights
from ..eval import evaluate_ensemble, evaluate_ensemble_horizon
from ..inference import init_vi, load_checkpoint
from ..inference.elbo import decode, encode
from . import common


def init_and_load(method, data_config, optim_config, generator, init_path=None, device=None):
    """-> (params, model) of one member: random weights from `generator`, replaced by
    `init_path`'s checkpoint when given."""
    model = common.build_sim_model(method, data_config, elbo=True, ode_method=optim_config.ode_method)
    params = init_vi(generator, model, device=device)
    if init_path is not None:
        params, _, _ = load_checkpoint(init_path, model.model_name, device)
    return params, model


@torch.no_grad()
def predict_mean(params, model, data):
    """Decode of the posterior mean of the FULL sequence."""
    mu = encode(params, model, data["measurements"], data["actions"], data["masks"])[0]
    x_hat, _ = decode(params, model, mu, data)
    return x_hat


def run(seed, data_path, sample, data_config, path, optim_config, eval_config, horizon=False, result_path=None,
        device=None):
    """-> the six numbers of `evaluate_ensemble`, or with `horizon` the pickled dict."""
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)

    dg = SyntheticCohort.load(data_path, device=device)
    params_e, model_e = init_and_load("expert", data_config, optim_config, generator, path, device)
    params_m, model_m = init_and_load("neural", data_config, optim_config, generator, path, device)

    val = {k: v[:, :sample] for k, v in dg.data_val.items()}
    weights_e, weights_m = learn_ensemble_weights(val["measurements"], predict_mean(params_e, model_e, val),
                                                  predict_mean(params_m, model_m, val), eval_config.t0)
    print("Ensemble weights learned.")

    args = (params_e, model_e, params_m, model_m, dg, optim_config.batch_size, eval_config.t0)
    kw = dict(weight_expert=weights_e, weight_ml=weights_m, generator=generator, device=device)
    if not horizon:
        return evaluate_ensemble(*args, **kw)
    res = evaluate_ensemble_horizon(*args, **kw)
    with open(result_path, "wb") as f:
        pickle.dump(res, f)
    return res


def main(argv=None):
    parser = argparse.ArgumentParser("PKPD simulation ensemble")
    parser.add_argument("--method", choices=["ensemble"], default="ensemble", type=str)
    parser.add_argument("--device", choices=["0", "1", "c"], default="1", type=str,
                        help="c: run on the CPU; 0 or 1: run on the GPU")
    parser.add_argument("--seed", default=666, type=int)
    parser.add_argument("--sample", default=1000, type=int)
    parser.add_argument("--path", default=None, type=str)
    parser.add_argument("--t0", default=5, type=int)
    parser.add_argument("--restart", default=5, type=int)
    parser.add_argument("--eval", default="n", type=str)
    parser.add_argument("--data_path", default="data/datafile_dose_exp.pkl", type=str)
    parser.add_argument("--data_config", default=None, type=str)
    parser.add_argument("--horizon", default=False, type=bool)
    parser.add_argument("--result_path", default=None, type=str)
    args = parser.parse_args(argv)

    data_config = common.resolve_data_config(args.data_config, args.sample)
    optim_config = OptimConfig(shuffle=False, n_restart=args.restart)
    run(args.seed, args.data_path, args.sample, data_config, args.path, optim_config, EvalConfig(t0=args.t0),
        args.horizon, args.result_path, device="cpu" if args.device == "c" else "cuda")


if __name__ == "__main__":
    main()
