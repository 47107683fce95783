"""The port's run_simulation_flow, run_eval, run_simulation_ensemble and run_simulation_residual CLIs on the CPU.

They run on a small cohort that the JAX package generates as tests/test_cli.py
does (48 patients: 24 train, 8 val, 16 test; obs 8, latent 6, T=15), from
expert and neural checkpoints that the port's run_simulation trains for 2
iterations. Checked: the stdout contract, the checkpoint names (which the JAX
package loads), the pickles' keys and shapes (vectors of length T - t0 = 10),
and the deterministic point metrics against the JAX package's own functions
on the same checkpoints: `rmse_x` of `run_eval` (a posterior-mean decode per
patient) and `rmse_z0` / `rmse_x` of the ensemble (NNLS weights from
posterior-mean decodes of the val fold), within rtol 2e-3 as
tests/test_torch_cli.py holds `evaluate`.
"""

import dataclasses
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from hybridode.cli import run_simulation_ensemble as j_ensemble
from hybridode.cli.common import build_sim_model as j_build_sim_model
from hybridode.config import DataConfig as JDataConfig
from hybridode.config import OptimConfig as JOptimConfig
from hybridode.config import RocheConfig as JRocheConfig
from hybridode.data import SyntheticCohort as JSyntheticCohort
from hybridode.ensembles import learn_ensemble_weights as j_learn_ensemble_weights
from hybridode.eval import evaluate_ensemble as j_evaluate_ensemble
from hybridode.eval import evaluate_horizon as j_evaluate_horizon
from hybridode.inference import init_vi as j_init_vi
from hybridode.inference import load_checkpoint as j_load_checkpoint
from hybridode_torch.cli import run_eval, run_simulation, run_simulation_ensemble, run_simulation_flow
from hybridode_torch.cli import common, run_simulation_residual
from hybridode_torch.config import DataConfig, EvalConfig, OptimConfig

DC, JDC = DataConfig(obs_dim=8, latent_dim=6), JDataConfig(obs_dim=8, latent_dim=6)
CSV = ["rmse_z0", "rmse_x", "cprs_z0", "cprs_x"]
HORIZON_KEYS = ["cprs_x", "cprs_x_sd", "rmse_x", "rmse_x_sd"]
OPTIM = OptimConfig(shuffle=False, n_restart=1, batch_size=8, niters=2, test_freq=2, early_stop=10)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


@pytest.fixture(scope="module")
def small_data(tmp_path_factory):
    dg = JSyntheticCohort(
        n_sample=48, obs_dim=8, t_max=14, step_size=1, roche_config=JRocheConfig(kel=1),
        output_sigma=0.2, dose_max=10, latent_dim=6, sparsity=0.5, output_sparsity=0.5,
        p_remove=0.5, val_size=8, test_size=16, rng=np.random.RandomState(666),
    )
    dg.generate_data()
    dg.split_sample()
    path = str(tmp_path_factory.mktemp("data") / "cohort.pkl")
    dg.save(path)
    return path


@pytest.fixture(scope="module")
def members(small_data, tmp_path_factory):
    """Expert and neural checkpoints under one path prefix, as the ensemble and residual CLIs read them."""
    path = str(tmp_path_factory.mktemp("models")) + "/"
    for method in ("expert", "neural"):
        run_simulation.run(seed=1, elbo=True, eval_only=False, init_path=None, data_path=small_data, sample=40,
                           data_config=DC, model_method=method, path=path, optim_config=OPTIM,
                           eval_config=EvalConfig(t0=5), device="cpu")
    return path


@pytest.fixture
def small_config(monkeypatch):
    """The CLIs' `main` resolves the small cohort's data config (the CLIs know only the default, dim8 and dim12)."""
    monkeypatch.setattr(common, "resolve_data_config",
                        lambda name, sample: dataclasses.replace(DC, n_sample=sample))


def _csv(lines):
    return [ln.split(",")[0] for ln in lines[-4:]] == CSV and all(len(ln.split(",")) == 3 for ln in lines[-4:])


def test_run_simulation_flow_prints_the_contract_and_jax_loads_its_checkpoint(small_data, tmp_path, capsys,
                                                                            small_config):
    path = str(tmp_path) + "/"
    params, model, scores = run_simulation_flow.run(
        seed=1, eval_only=False, data_path=small_data, sample=40, data_config=DC, path=path,
        optim_config=dataclasses.replace(OPTIM, niters=4),
        eval_config=EvalConfig(t0=5), events_path=str(tmp_path / "events.jsonl"), device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "Training with 40 samples" and _csv(lines)
    assert [ln[:9] for ln in lines if ln.startswith("Iter")] == ["Iter 0002", "Iter 0004"]
    assert lines[-6].startswith("Time: ") and lines[-5].startswith("Overall best loss: ")
    assert (model.kind, model.mc_size, model.encoder_spec.num_flows) == ("flow", 50, 4)
    assert model.model_name == "VI_FLOW_PlanarLSTMEncoder_HybridDecoder.pkl" and os.path.exists(path + model.model_name)
    assert len(scores) == 6 and np.isfinite(scores).all()
    assert open(tmp_path / "events.jsonl").read().count('"event": "window"') == 2  # the fused loop's windows

    # The JAX package loads the checkpoint into its own flow model's tree.
    jparams, itr, _ = j_load_checkpoint(path, model.model_name)
    jm = j_build_sim_model("hybrid", JDC, flow=True, num_flows=4, mc_size=50)
    want = {k: v.shape for k, v in _leaves(j_init_vi(jax.random.PRNGKey(0), jm))}
    assert {k: v.shape for k, v in _leaves(jparams)} == want and itr in (2, 4)

    # --eval y: the checkpoint is loaded, its best loss printed, and evaluated again with the same noise.
    run_simulation_flow.main(["--eval", "y", "--device", "c", "--data_path", small_data, "--path", path, "--seed", "1",
                              "--sample", "40", "--batch_size", "8", "--restart", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[1].startswith("Overall best loss: ") and _csv(lines)


@pytest.mark.parametrize("mode", ["shard"])
def test_run_simulation_flow_refuses_unported_restart_modes(small_data, tmp_path, mode, capfd, small_config):
    """The name is the one this test had while the flow CLI refused `--restart_mode shard`, which is ported: a
    restart count its devices do not divide raises JAX's ValueError before anything runs or is written; 2 restarts
    over 2 gloo ranks (one lane a rank) run, rank 0 alone printing the contract and writing the one checkpoint."""
    refused, path = tmp_path / "refused", str(tmp_path / "shard") + "/"
    refused.mkdir()
    with pytest.raises(ValueError, match="n_restart 3 not divisible by restart_devices 2"):
        run_simulation_flow.main(["--device", "c", "--data_path", small_data, "--path", str(refused) + "/",
                                  "--restart_mode", mode, "--restart_devices", "2"])
    assert not list(refused.iterdir())
    capfd.readouterr()
    run_simulation_flow.main(["--device", "c", "--data_path", small_data, "--path", path, "--restart_mode", mode,
                              "--restart", "2", "--restart_devices", "2", "--arg_itr", "2", "--sample", "40",
                              "--batch_size", "8"])
    lines = capfd.readouterr().out.strip().splitlines()
    assert lines.count("Training with 40 samples") == 1 and _csv(lines)
    assert os.listdir(path) == ["VI_FLOW_PlanarLSTMEncoder_HybridDecoder.pkl"]


def test_run_eval_pickles_the_horizon_and_its_rmse_matches_jax(small_data, members, tmp_path, capsys, small_config):
    result = str(tmp_path / "horizon.pkl")
    run_eval.main(["--method", "expert", "--device", "c", "--path", members, "--data_path", small_data,
                   "--batch_size", "8", "--result_path", result])
    assert capsys.readouterr().out.startswith("Overall best loss: ")
    with open(result, "rb") as f:
        got = pickle.load(f)
    assert sorted(got) == HORIZON_KEYS
    for k, v in got.items():
        assert isinstance(v, np.ndarray) and v.shape == (10,) and np.isfinite(v).all(), k

    jm = j_build_sim_model("expert", JDC)
    jparams, _, _ = j_load_checkpoint(members, jm.model_name)
    want = j_evaluate_horizon(jparams, jm, JSyntheticCohort.load(small_data), 8, 5, key=jax.random.PRNGKey(0))
    np.testing.assert_allclose(got["rmse_x"], want["rmse_x"], rtol=2e-3)

    with pytest.raises(SystemExit):
        run_eval.main(["--eval", "n", "--device", "c", "--path", members, "--data_path", small_data])


def test_run_simulation_ensemble_matches_jax_point_metrics(small_data, members, tmp_path, capsys):
    scores = run_simulation_ensemble.run(seed=1, data_path=small_data, sample=40, data_config=DC, path=members,
                                         optim_config=OptimConfig(shuffle=False, batch_size=8),
                                         eval_config=EvalConfig(t0=5), device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "Ensemble weights learned." and _csv(lines) and np.isfinite(scores).all()

    jdg = JSyntheticCohort.load(small_data)
    jopt = JOptimConfig(shuffle=False, batch_size=8)
    jp_e, jm_e = j_ensemble.init_and_load("expert", JDC, jopt, jax.random.PRNGKey(0), init_path=members)
    jp_m, jm_m = j_ensemble.init_and_load("neural", JDC, jopt, jax.random.PRNGKey(1), init_path=members)
    val = {k: v[:, :40] for k, v in jdg.data_val.items()}
    w_e, w_m = j_learn_ensemble_weights(val["measurements"], j_ensemble.predict_mean(jp_e, jm_e, val),
                                        j_ensemble.predict_mean(jp_m, jm_m, val), 5)
    want = j_evaluate_ensemble(jp_e, jm_e, jp_m, jm_m, jdg, 8, 5, weight_expert=w_e, weight_ml=w_m, verbose=False)
    for i, name in ((0, "rmse_z0"), (3, "rmse_x")):
        np.testing.assert_allclose(scores[i], want[i], rtol=2e-3, err_msg=name)

    # horizon=True: the per-step dict, pickled.
    result = str(tmp_path / "ens.pkl")
    run_simulation_ensemble.run(seed=1, data_path=small_data, sample=40, data_config=DC, path=members,
                                optim_config=OptimConfig(shuffle=False, batch_size=8), eval_config=EvalConfig(t0=5),
                                horizon=True, result_path=result, device="cpu")
    with open(result, "rb") as f:
        got = pickle.load(f)
    assert sorted(got) == HORIZON_KEYS and all(v.shape == (10,) for v in got.values())


def test_run_simulation_residual_trains_on_the_val_residuals(small_data, members, tmp_path, capsys):
    res_path = str(tmp_path) + "/res_"
    scores = run_simulation_residual.run(seed=1, eval_only=False, data_path=small_data, sample=40, data_config=DC,
                                         path=members, res_path=res_path, optim_config=OPTIM,
                                         eval_config=EvalConfig(t0=5), device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "Training with 40 samples" and "Ensemble weights learned." in lines and _csv(lines)
    assert [ln[:9] for ln in lines if ln.startswith("Iter")] == ["Iter 0002"]
    assert os.path.exists(res_path + "VI_LSTMEncoder_NeuralODEDecoder.pkl") and np.isfinite(scores).all()

    result = str(tmp_path / "res.pkl")
    run_simulation_residual.run(seed=1, eval_only=True, data_path=small_data, sample=8, data_config=DC, path=members,
                                res_path=res_path, optim_config=OPTIM, eval_config=EvalConfig(t0=5), horizon=True,
                                result_path=result, device="cpu")
    with open(result, "rb") as f:
        got = pickle.load(f)
    assert sorted(got) == HORIZON_KEYS and all(v.shape == (10,) for v in got.values())


@pytest.mark.parametrize("cli,argv,want", [
    (run_simulation_ensemble, ["--path", "m/", "--horizon", "y", "--result_path", "r.pkl", "--t0", "4"],
     dict(path="m/", horizon=True, result_path="r.pkl", t0=4, n_restart=5)),
    (run_simulation_residual, ["--path", "m/", "--restart", "2", "--lr", "0.1", "--eval", "y"],
     dict(path="m/", res_path="m/res", horizon=False, eval_only=True, t0=5, n_restart=2, lr=0.1)),
    (run_simulation_residual, ["--path", "m/", "--res_path", "r/", "--val_criterion", "elbo"],
     dict(res_path="r/", val_criterion="elbo", eval_only=False)),
], ids=["ensemble", "residual", "residual_res_path"])
def test_main_maps_the_jax_flags(monkeypatch, cli, argv, want):
    """`main` hands `run` the JAX CLI's values (`--horizon` keeps its `type=bool`); `--device c` is the CPU."""
    got = {}
    monkeypatch.setattr(cli, "run", lambda *args, **kw: got.update(kw, args=args))
    cli.main(argv + ["--device", "c"])
    names = ["seed", "eval_only", "data_path", "sample", "data_config", "path", "res_path", "optim_config",
             "eval_config", "horizon", "result_path"]
    if cli is run_simulation_ensemble:
        names = [n for n in names if n not in ("eval_only", "res_path")]
    got.update(zip(names, got.pop("args")))
    got.update(t0=got["eval_config"].t0, n_restart=got["optim_config"].n_restart, lr=got["optim_config"].lr)
    assert got["device"] == "cpu" and got["seed"] == 666 and got["sample"] == 1000
    for k, v in want.items():
        assert got[k] == v, k


def test_residual_val_fold_is_cut_to_the_sample(small_data):
    from hybridode_torch.data import SyntheticCohort

    jdg, dg = JSyntheticCohort.load(small_data), SyntheticCohort.load(small_data, device="cpu")
    jdg.set_val_size(5)
    dg.set_val_size(5)
    assert dg.val_size == jdg.val_size == 5
    for k, v in jdg.data_val.items():
        np.testing.assert_array_equal(dg.data_val[k].numpy(), np.asarray(v), err_msg=k)
    assert torch.equal(dg.get_split("val", 8, 0)["measurements"], dg.data_val["measurements"])
