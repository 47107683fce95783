"""The port's run_simulation CLI: its stdout, its checkpoint (which JAX's `evaluate` scores alike), every method.

The hybrid run trains 4 iterations on a small cohort generated as
tests/test_cli.py generates it (48 patients, obs 8), validating every 2.
JAX's `evaluate` on the port's checkpoint must give the port's `rmse_z0` and
`rmse_x` within rtol 2e-3: both are posterior-mean decodes (no noise), held
to the tolerance of the evaluation parity tests (tests/test_torch_eval.py).
"""

import os

import jax
import numpy as np
import pytest
import torch

from hybridode.cli.common import build_sim_model as j_build_sim_model
from hybridode.config import DataConfig as JDataConfig
from hybridode.config import RocheConfig as JRocheConfig
from hybridode.data import SyntheticCohort as JSyntheticCohort
from hybridode.eval import evaluate as j_evaluate
from hybridode.inference import load_checkpoint as j_load_checkpoint
from hybridode_torch.cli.run_simulation import main, run
from hybridode_torch.config import DataConfig, EvalConfig, OptimConfig
from hybridode_torch.data import SyntheticCohort
from hybridode_torch.eval import evaluate
from hybridode_torch.inference import load_checkpoint

COHORT = os.path.join(os.path.dirname(__file__), os.pardir, "data_s123", "datafile_dose_exp.pkl")
DC = DataConfig(obs_dim=8, latent_dim=6)
CSV = ["rmse_z0", "rmse_x", "cprs_z0", "cprs_x"]


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


def _run(data_path, path, method="hybrid", eval_only=False, **kw):
    return run(seed=1, elbo=True, eval_only=eval_only, init_path=None, data_path=data_path, sample=40,
               data_config=DC, model_method=method, path=path,
               optim_config=OptimConfig(shuffle=False, n_restart=1, batch_size=8, niters=4, test_freq=2,
                                        early_stop=10),
               eval_config=EvalConfig(t0=5), device="cpu", **kw)


def test_run_hybrid_prints_the_contract_and_jax_scores_its_checkpoint(small_data, tmp_path, capsys):
    path = str(tmp_path) + "/"
    params, model, scores = _run(small_data, path, events_path=str(tmp_path / "events.jsonl"))
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "Training with 40 samples"
    iters = [ln for ln in lines if ln.startswith("Iter")]
    assert [ln[:9] for ln in iters] == ["Iter 0002", "Iter 0004"]
    assert all(" | Total Loss " in ln and " | Train Loss " in ln for ln in iters)
    assert lines[-6].startswith("Time: ") and lines[-5].startswith("Overall best loss: ")
    assert [ln.split(",")[0] for ln in lines[-4:]] == CSV and all(len(ln.split(",")) == 3 for ln in lines[-4:])
    assert os.path.exists(path + model.model_name) and model.model_name == "VI_LSTMEncoder_HybridDecoder.pkl"
    assert np.isfinite(scores[0]) and np.isfinite(scores[3])
    events = open(tmp_path / "events.jsonl").read()
    # The fused loop: one `window` record a validation window (the host loop logs a `step` record an iteration).
    assert events.count('"event": "window"') == 2 and events.count('"val"') == 2 and '"evaluate"' in events

    # The checkpoint scored by both packages: point decodes, no noise in rmse_z0 / rmse_x.
    jparams, _, _ = j_load_checkpoint(path, model.model_name)
    jm = j_build_sim_model("hybrid", JDataConfig(obs_dim=8, latent_dim=6))
    want = j_evaluate(jparams, jm, JSyntheticCohort.load(small_data), 8, 5, mc_itr=4, key=jax.random.PRNGKey(0),
                      verbose=False)
    ported, _, _ = load_checkpoint(path, model.model_name, device="cpu")
    got = evaluate(ported, model, SyntheticCohort.load(small_data, device="cpu"), 8, 5, mc_itr=4,
                   generator=torch.Generator().manual_seed(0), verbose=False, device="cpu")
    for i, name in ((0, "rmse_z0"), (3, "rmse_x")):
        assert np.isfinite(got[i]) and np.isfinite(want[i]), name
        np.testing.assert_allclose(got[i], want[i], rtol=2e-3, err_msg=name)

    # --eval y: the checkpoint is loaded, its best loss printed, and evaluated again.
    _, _, again = _run(small_data, path, eval_only=True)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[1].startswith("Overall best loss: ") and [ln.split(",")[0] for ln in lines[-4:]] == CSV
    assert again[0] == scores[0] and again[3] == scores[3]


def test_run_expert_and_neural(small_data, tmp_path, capsys):
    """The two other methods: the expert (4 latents, Roche field) and the neural ODE (lockstep DOPRI5)."""
    for method, name in (("expert", "VI_LSTMEncoder_ExpertDecoder.pkl"), ("neural", "VI_LSTMEncoder_NeuralODEDecoder.pkl")):
        _, model, scores = _run(small_data, str(tmp_path) + f"/{method}_", method=method)
        assert model.model_name == name and os.path.exists(str(tmp_path) + f"/{method}_" + name)
        assert np.isfinite(scores[0]) and np.isfinite(scores[3]), method
    spec = model.decoder_spec
    assert not spec.roche and not spec.per_sample_control and spec.max_steps == 512
    assert [ln.split(",")[0] for ln in capsys.readouterr().out.strip().splitlines()[-4:]] == CSV


def test_main_parses_the_reference_flags(tmp_path, capsys):
    """`python -m hybridode_torch.cli.run_simulation --method hybrid ... --device c` on data_s123."""
    main(["--method", "hybrid", "--arg_itr", "1", "--restart", "1", "--device", "c", "--data_path", COHORT,
          "--path", str(tmp_path) + "/", "--sample", "1000", "--batch_size", "100"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "Training with 1000 samples" and [ln.split(",")[0] for ln in lines[-4:]] == CSV
    assert os.path.exists(str(tmp_path) + "/VI_LSTMEncoder_HybridDecoder.pkl")


# The parallel flags are ported (hybridode_torch/parallel/): what they cannot run raises JAX's ValueError before any
# rank starts; the case ids keep the names these cases had while the flags raised NotImplementedError. The batched
# restarts over the lockstep adjoint ("item 6", error None) are ported too: that case runs them and finds the
# checkpoint and the CSV.
@pytest.mark.parametrize("flags,error,match", [
    pytest.param(["--restart_mode", "vmap", "--step_control", "lockstep", "--restart", "2", "--arg_itr", "1",
                  "--sample", "400", "--batch_size", "100"], None, None, id="flags0-item 6"),
    pytest.param(["--restart_mode", "shard", "--restart_devices", "2"], ValueError,
                 "n_restart 3 not divisible by restart_devices 2", id="flags1-item 3"),
    pytest.param(["--dp", "2", "--restart_mode", "vmap"], ValueError, "--restart_mode=vmap does not compose with --dp",
                 id="flags2-item 3"),
    pytest.param(["--eval_mesh", "4x2", "--batch_size", "50"], ValueError,
                 r"batch_size 50 not divisible by the data mesh axis \(4\)", id="flags3-item 3"),
])
def test_unported_flags_raise(flags, error, match, tmp_path, capsys):
    argv = ["--device", "c", "--data_path", COHORT, "--path", str(tmp_path) + "/"] + flags
    if error is None:
        main(argv)
        lines = capsys.readouterr().out.strip().splitlines()
        assert lines[0] == "Training with 400 samples" and [ln.split(",")[0] for ln in lines[-4:]] == CSV
        assert os.listdir(tmp_path) == ["VI_LSTMEncoder_HybridDecoder.pkl"]
        return
    with pytest.raises(error, match=match):
        main(argv)
    assert not list(tmp_path.iterdir())
