"""The port's real-data CLIs on the CPU: their stdout and eval pickles, and JAX's numbers from JAX's checkpoints.

The CLIs fix t0 = 24 hours, and the ensemble and residual CLIs a val fold of
100 and a test fold of 1,000 patients, so the stand-in cohort here has
1,124 patients (24 train), T 30 (a 7-point decode past t0), obs 6 and 3
statics; latents 6 (4 for the expert). The JAX package trains the `hybrid`,
`expert` and `gruode` checkpoints (2 iterations, its host loop); the port
then evaluates them (`eval_only`), blends the last two (ensemble) and trains
the residual hybrid on the expert. The forecasts must equal JAX's within rtol 1e-5, atol 1e-6
(point decodes, no noise), the horizon RMSEs within rtol 1e-5; the residual
hybrid, after two Adam steps of each package from the same weights, within
rtol 1e-4. The bootstrap `sd` column draws from the global np.random and is
not compared.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from hybridode.cli import run_real as j_run_real
from hybridode.cli import run_real_ensemble as j_run_real_ensemble
from hybridode.cli import run_real_residual as j_run_real_residual
from hybridode.inference import VIModel as JVIModel
from hybridode.inference import init_vi as j_init_vi
from hybridode.models.decoders import RealBenchmarkSpec as JBenchmarkSpec
from hybridode.models.encoders import EncoderLSTMRealSpec as JEncoderSpec
from hybridode.utils.hostrng import host_key, host_split
from hybridode_torch.cli import run_real, run_real_ensemble, run_real_residual
from hybridode_torch.convert import params_from_jax
from hybridode_torch.data import make_real_standin

METHODS = ("neural", "hybrid", "expert", "2nd", "tlstm", "gruode")
LATENT = 6
HORIZONS = [30, 36, 48, 96]


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("real")) + "/"
    make_real_standin(path, n_sample=1124, t_max=30, obs_dim=6, static_dim=3, latent_dim=4)
    return path


@pytest.fixture(scope="module")
def jax_checkpoints(standin, tmp_path_factory):
    """JAX's run_real trains `hybrid`, `expert` and `gruode` (host loop) into one model directory."""
    model_dir = str(tmp_path_factory.mktemp("jax_models")) + "/"
    mp = pytest.MonkeyPatch()
    mp.setenv("HYBRIDODE_FUSED", "0")
    try:
        for method in ("hybrid", "expert", "gruode"):
            j_run_real.run(seed=1, method=method, niters=2, data_path=standin, model_dir=model_dir,
                           encoder_output_dim=4 if method == "expert" else LATENT)
    finally:
        mp.undo()
    return model_dir


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _rmse_lines(out):
    return [ln for ln in out.splitlines() if ln.startswith("rmse_x,")]


def _check_csv(out):
    lines = _rmse_lines(out)
    assert [float(ln.split(",")[1]) for ln in lines] == HORIZONS, out
    for ln in lines:
        assert len(ln.split(",")) == 4 and all(np.isfinite(float(v)) for v in ln.split(",")[2:]), ln


def _same_forecast(got_pkl, want_pkl, rtol=1e-5, atol=1e-6):
    got, want = _load(got_pkl), _load(want_pkl)
    assert got.keys() == want.keys() and got["name"] == want["name"]
    for k in ("x", "x_hat", "mask"):
        assert isinstance(got[k], np.ndarray) and got[k].dtype == np.float32 and got[k].shape == want[k].shape, k
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)
    return got, want


def _rmses(d):
    return [r[1] for r in run_real.horizon_report(d["x"], d["x_hat"], d["mask"], 24)]


@pytest.mark.parametrize("method", METHODS)
def test_main_prints_the_contract_for_every_method(method, standin, tmp_path, monkeypatch, capsys):
    """`python -m hybridode_torch.cli.run_real --method <m> --device c`: training lines, the CSV, the pickle."""
    monkeypatch.chdir(tmp_path)
    eod = "4" if method == "expert" else str(LATENT)
    run_real.main(["--method", method, "--device", "c", "--niters", "2", "--data_path", standin,
                   "--encoder_output_dim", eod])
    out = capsys.readouterr().out
    lines = out.strip().splitlines()
    assert lines[-6].startswith("Time: ") and lines[-5].startswith("Overall best loss: ")
    _check_csv(out)
    name = f"VI_LSTMReal_DecoderReal_{method}.pkl"
    assert os.path.exists(tmp_path / "model" / name)
    d = _load(tmp_path / "model" / (name + "eval.pkl"))
    assert d["name"] == name and d["model_path"] == "model/"
    assert d["x_hat"].shape == (6, 1000, 6) and d["x"].shape == d["mask"].shape == (30, 1000, 6)


@pytest.mark.parametrize("method", ["hybrid", "expert", "gruode"])
def test_eval_only_scores_a_jax_checkpoint_as_jax_does(method, standin, jax_checkpoints, tmp_path, capsys):
    name = f"VI_LSTMReal_DecoderReal_{method}.pkl"
    want_pkl = str(tmp_path / "jax_eval.pkl")
    j_run_real.run(seed=1, method=method, eval_only=True, data_path=standin, model_dir=jax_checkpoints,
                   encoder_output_dim=4 if method == "expert" else LATENT)
    os.replace(jax_checkpoints + name + "eval.pkl", want_pkl)
    capsys.readouterr()
    _, model, report = run_real.run(seed=1, method=method, eval_only=True, data_path=standin,
                                    model_dir=jax_checkpoints, encoder_output_dim=4 if method == "expert" else LATENT,
                                    device="cpu")
    out = capsys.readouterr().out
    assert out.splitlines()[0].startswith("Overall best loss: ")
    _check_csv(out)
    got, want = _same_forecast(jax_checkpoints + name + "eval.pkl", want_pkl)
    np.testing.assert_allclose([r[1] for r in report], _rmses(want), rtol=1e-5)


def test_ensemble_blends_jax_checkpoints_as_jax_does(standin, jax_checkpoints, capsys):
    j_run_real_ensemble.run(seed=1, init_path=jax_checkpoints, data_path=standin, encoder_output_dim=LATENT)
    want_pkl = jax_checkpoints + "ensembleeval.pkl.jax"
    os.replace(jax_checkpoints + "ensembleeval.pkl", want_pkl)
    capsys.readouterr()
    report = run_real_ensemble.run(seed=1, init_path=jax_checkpoints, data_path=standin, encoder_output_dim=LATENT,
                                   device="cpu")
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "Ensemble weights learned."
    _check_csv(out)
    _, want = _same_forecast(jax_checkpoints + "ensembleeval.pkl", want_pkl)
    np.testing.assert_allclose([r[1] for r in report], _rmses(want), rtol=1e-5)


def test_residual_trains_on_jax_checkpoints_as_jax_does(standin, jax_checkpoints, tmp_path, monkeypatch, capsys):
    """The gruode starts from JAX's own initial weights (JAX's key chain, converted); both train 2 steps."""
    monkeypatch.setenv("HYBRIDODE_FUSED", "0")
    j_run_real_residual.run(seed=1, niters=2, init_path=jax_checkpoints, data_path=standin,
                            model_dir=str(tmp_path / "jax") + "/", encoder_output_dim=LATENT)
    want_pkl = str(tmp_path / "residual_jax.pkl")
    os.replace(jax_checkpoints + "residualeval.pkl", want_pkl)

    key, _ = host_split(host_key(1))
    _, k_init, _ = host_split(key, 3)

    def jax_init(generator, model, device):
        jm = JVIModel(model.kind, JEncoderSpec(*model.encoder_spec), JBenchmarkSpec(*model.decoder_spec), *model[3:])
        return params_from_jax(j_init_vi(k_init, jm), device)

    monkeypatch.setattr(run_real_residual, "init_vi", jax_init)
    capsys.readouterr()
    report = run_real_residual.run(seed=1, niters=2, init_path=jax_checkpoints, data_path=standin,
                                   model_dir=str(tmp_path / "port") + "/", encoder_output_dim=LATENT, device="cpu")
    out = capsys.readouterr().out
    _check_csv(out)
    assert os.path.exists(tmp_path / "port" / "resVI_LSTMReal_DecoderReal_gruode.pkl")
    _, want = _same_forecast(jax_checkpoints + "residualeval.pkl", want_pkl, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose([r[1] for r in report], _rmses(want), rtol=1e-4)


def test_clis_refuse_to_start_without_a_card_unless_asked_for_the_cpu(standin, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (run_real.main, run_real_ensemble.main, run_real_residual.main):
        for device in ([], ["--device", "0"], ["--device", "1"]):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                main(["--data_path", standin, "--init_path", "m/"][: 2 if main is run_real.main else 4] + device)
    assert not list(tmp_path.iterdir())  # refused before any work
