"""Port vs JAX: synthetic cohort generation, the cohort file in both directions, and `create_data`.

One seed, the same `numpy.random.RandomState` draws in the same order: every
array drawn only from it (the observation head `output_coef`, the ml mixing
`ml_coef`, `dose_time`, `dose_amount`, the `actions` built from them and the
`masks`) is byte for byte JAX's. The latents are a float64 DOPRI5 solve in
each package, stored as float32: within rtol 1e-5, atol 1e-6 (about one
float32 ulp); the measurements, which z-normalise the latents plus noise,
within atol 1e-5. The ground truth is also held against per-patient LSODA,
as tests/test_data.py holds JAX's.
"""

import os
import pickle

import numpy as np
import pytest
import scipy.integrate

from hybridode.config import RocheConfig as JRocheConfig
from hybridode.data import SyntheticCohort as JSyntheticCohort
from hybridode.data import add_noise as j_add_noise
from hybridode.data import make_dim_cohort as j_make_dim_cohort
from hybridode_torch.cli import create_data
from hybridode_torch.config import RocheConfig
from hybridode_torch.data import SyntheticCohort, add_noise, make_dim_cohort
from hybridode_torch.utils.pickling import load_pickle

COHORT = os.path.join(os.path.dirname(__file__), os.pardir, "data_s123", "datafile_dose_exp.pkl")
DRAWN = ("output_coef", "ml_coef", "dose_time", "dose_amount", "actions", "masks")
SMALL = dict(n_sample=40, obs_dim=10, t_max=14, step_size=1, output_sigma=0.2, dose_max=10, latent_dim=6,
             sparsity=0.5, output_sparsity=0.5, p_remove=0.5, val_size=8, test_size=8)


def assert_same_cohort(got, want):
    """`got` and `want`: dicts of the cohort's arrays."""
    for k in DRAWN:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    for k in ("latents", "measurements"):
        assert got[k].dtype == want[k].dtype == np.float32 and got[k].shape == want[k].shape, k
    np.testing.assert_allclose(got["latents"], want["latents"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["measurements"], want["measurements"], rtol=0, atol=1e-5)


def _arrays(cohort):
    return {k: getattr(cohort, k) for k in DRAWN + ("latents", "measurements")}


def small_cohort(seed=666, n=40):
    dg = SyntheticCohort(rng=np.random.RandomState(seed), roche_config=RocheConfig(kel=1), device="cpu",
                         **dict(SMALL, n_sample=n))
    dg.generate_data()
    dg.split_sample()
    return dg, dg.solve_stats


def j_small_cohort(seed=666, n=40):
    dg = JSyntheticCohort(rng=np.random.RandomState(seed), roche_config=JRocheConfig(kel=1), **dict(SMALL, n_sample=n))
    dg.generate_data()
    dg.split_sample()
    return dg


@pytest.fixture(scope="module")
def pair():
    return small_cohort()[0], j_small_cohort()


def test_small_cohort_matches_jax(pair):
    port, jax_cohort = pair
    assert_same_cohort(_arrays(port), _arrays(jax_cohort))
    for k in ("train_size", "val_size", "test_size", "time_dim", "ml_dim", "expert_dim", "action_dim"):
        assert getattr(port, k) == getattr(jax_cohort, k), k
    assert port.data_train["measurements"].shape == (15, 24, 10) and port.data_test["masks"].shape == (15, 8, 10)


def test_ground_truth_solve_reports_its_steps():
    _, stats = small_cohort(n=8)
    assert bool(stats.success) and int(stats.n_accepted) <= int(stats.n_steps) <= 4096


def test_add_noise_matches_jax(pair):
    port, jax_cohort = pair
    base, j_base = port.measurements.copy(), jax_cohort.measurements.copy()
    add_noise(port, 0.4, seed=123)
    j_add_noise(jax_cohort, 0.4, seed=123)
    np.testing.assert_allclose(port.measurements - base, jax_cohort.measurements - j_base, rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.measurements, jax_cohort.measurements, rtol=0, atol=1e-5)
    assert np.asarray(port.data_val["measurements"].numpy()).tobytes() == port.measurements[:, 24:32].tobytes()


def test_dim8_cohort_matches_jax():
    kw = dict(n_sample=40, val_size=8, test_size=8)
    port = make_dim_cohort(8, device="cpu", **kw)
    jax_cohort = j_make_dim_cohort(8, **kw)
    assert port.latents.shape == (15, 40, 8) and port.measurements.shape == (15, 40, 40)
    assert_same_cohort(_arrays(port), _arrays(jax_cohort))


def test_ground_truth_matches_lsoda():
    """Per-patient LSODA of the reference's generator against the port's batched float64 DOPRI5."""
    dg, _ = small_cohort(n=20)
    cfg, ml_coef = dg.roche_config, dg.ml_coef

    def rhs(t, y, dose_times, dose_amount):
        Disease, ImmuneReact, Immunity, Dose2 = y[0], y[1], y[2], y[3]
        active = t >= dose_times
        Dose = dose_amount * np.sum(np.exp(cfg.kel * (dose_times - t) * active) * active)
        d1 = (Disease * cfg.k_disprog - Disease * Immunity**cfg.HillCure * cfg.k_discure_immunity
              - Disease * ImmuneReact * cfg.k_discure_immunereact)
        d2 = (Disease * cfg.k_immune_disease - ImmuneReact * cfg.k_immune_off
              + Disease * ImmuneReact * cfg.k_immune_feedback
              + (ImmuneReact**cfg.HillPatho * cfg.emax_patho)
              / (cfg.ec50_patho**cfg.HillPatho + ImmuneReact**cfg.HillPatho)
              - Dose2 * ImmuneReact * cfg.k_dexa)
        d3 = ImmuneReact * cfg.k_immunity
        d4 = cfg.kel * Dose - cfg.kel * Dose2
        return np.concatenate([[d1, d2, d3, d4], np.tanh(y @ ml_coef)])

    ts = np.arange(0.0, 15.0)
    for b in [0, 7, 13]:
        sol = scipy.integrate.solve_ivp(rhs, (0, 14), dg.latents[0, b].astype(np.float64), t_eval=ts,
                                        method="LSODA", rtol=1e-9, atol=1e-11,
                                        args=(dg.dose_time[b].astype(np.float64), float(dg.dose_amount[b])))
        np.testing.assert_allclose(dg.latents[:, b, :], sol.y.T, rtol=2e-3, atol=2e-4)


def test_port_file_loads_in_jax_and_back(pair, tmp_path):
    port, _ = pair
    path = str(tmp_path / "port.pkl")
    port.save(path)
    jax_cohort = JSyntheticCohort.load(path)  # a plain pickle.load in the JAX package
    assert jax_cohort.roche_config == JRocheConfig(kel=1)
    for k, v in _arrays(port).items():
        assert np.array_equal(getattr(jax_cohort, k), v), k
    assert {k: v for k, v in vars(jax_cohort).items() if np.isscalar(v)} == \
        {k: v for k, v in vars(port).items() if np.isscalar(v)}

    again = SyntheticCohort.load(path, device="cpu")
    assert again.roche_config == RocheConfig(kel=1) and again.dtype is np.float32
    for k, v in _arrays(port).items():
        assert np.array_equal(getattr(again, k), v), k
    assert again.data_train["latents"].shape == port.data_train["latents"].shape

    # The port writes JAX's names and nothing of its own.
    with open(path, "rb") as f:
        blob = f.read()
    assert b"hybridode.config" in blob and b"jax.numpy" in blob and b"hybridode_torch" not in blob


def test_jax_file_loads_in_the_port_and_saves_alike(tmp_path):
    jax_cohort = j_small_cohort(n=24)
    path, back = str(tmp_path / "jax.pkl"), str(tmp_path / "back.pkl")
    jax_cohort.save(path)
    port = SyntheticCohort.load(path, device="cpu")
    port.save(back)
    with open(path, "rb") as f:
        want = pickle.load(f)
    assert sorted(load_pickle(back)["state"]) == sorted(want["state"])
    assert_same_cohort(_arrays(SyntheticCohort.load(back, device="cpu")), want["state"])


def test_create_data_reproduces_data_s123(tmp_path, capsys):
    """`create_data --which train --seed 123 --device c`: the committed cohort file, to the stated tolerances."""
    create_data.main(["--which", "train", "--seed", "123", "--device", "c", "--out", str(tmp_path)])
    path = os.path.join(str(tmp_path), "datafile_dose_exp.pkl")
    assert capsys.readouterr().out.strip() == f"wrote {path}"
    got, want = load_pickle(path)["state"], load_pickle(COHORT)["state"]
    assert sorted(got) == sorted(want)
    assert_same_cohort(got, want)
    assert JSyntheticCohort.load(path).n_sample == 1300
