"""The port's native C++ library (hybridode_torch/native) against the JAX package's, scipy and the port's own
float64 generator, on the CPU.

The port builds its own copy of native.cpp with g++ at first use into
.torch_ext_build/. The cases skip only where that build is not available
(`native.available()` False). What must hold:

* `nnls` against JAX's `native.nnls` and `scipy.optimize.nnls`: the solution
  and the residual within rtol 1e-10 (atol 1e-12 for the zeros of x);
* `roche_dopri5_batch` against JAX's on the same inputs: rtol 1e-12 (the
  same source and flags);
* `generate_data(backend="native")` against the port's float64 lockstep
  solve (backend "torch") of the same draws: the latents within rtol 1e-6
  (two DOPRI5s at rtol 1e-8, one a patient against one for the cohort,
  rounded to float32; atol 1e-6, the atol the port's cohort is held to
  against JAX's: the lockstep norm over the whole cohort leaves a latent
  near 0 up to ~1.3e-7 off), the
  drawn arrays byte for byte; the seed-123 training cohort against the
  committed data_s123 to tests/test_torch_synthetic_gen.py's tolerances;
* a build that fails raises with g++'s output, and `generate_data` goes
  over to no other backend.
"""

import os

import numpy as np
import pytest
import scipy.optimize

from hybridode import native as j_native
from hybridode_torch import native
from hybridode_torch.config import ROCHE_PARAM_NAMES, RocheConfig
from hybridode_torch.data import SyntheticCohort
from hybridode_torch.data.synthetic import TRAIN_COHORT
from hybridode_torch.utils.pickling import load_pickle

COHORT = os.path.join(os.path.dirname(__file__), os.pardir, "data_s123", "datafile_dose_exp.pkl")
DRAWN = ("output_coef", "ml_coef", "dose_time", "dose_amount", "actions", "masks")
NNLS_RTOL, NNLS_ATOL, JAX_RTOL, GEN_RTOL, GEN_ATOL = 1e-10, 1e-12, 1e-12, 1e-6, 1e-6


@pytest.fixture
def built():
    if not native.available():
        pytest.skip("the native library does not build here")


def test_nnls_matches_jax_native_and_scipy(built):
    rng = np.random.RandomState(0)
    for m, n in ((30, 2), (30, 3), (30, 5), (200, 4), (12, 8)):
        for _ in range(5):
            A, b = rng.randn(m, n), rng.randn(m)
            x, r = native.nnls(A, b)
            for want_x, want_r in (j_native.nnls(A, b), scipy.optimize.nnls(A, b)):
                np.testing.assert_allclose(x, want_x, rtol=NNLS_RTOL, atol=NNLS_ATOL)
                np.testing.assert_allclose(r, want_r, rtol=NNLS_RTOL)
            assert (x >= 0).all()


def _solve_inputs(seed=7, B=12, D=6):
    rng = np.random.RandomState(seed)
    cfg = RocheConfig(kel=1)
    return (rng.exponential(0.01, (B, D)), rng.randint(0, 14, (B, 1)).astype(np.float64), rng.rand(B) * 10,
            np.array([getattr(cfg, n) for n in ROCHE_PARAM_NAMES], np.float64),
            rng.randn(D, D - 4) * rng.binomial(1, 0.5, (D, D - 4)) / D, np.arange(0.0, 15.0))


@pytest.mark.parametrize("D", [6, 4], ids=["hybrid", "expert"])
def test_cohort_solve_matches_jax_native(built, D):
    y0, times, amounts, params, ml, ts = _solve_inputs(D=D)
    ml = ml if D > 4 else None
    got = native.roche_dopri5_batch(y0, times, amounts, params, ml, ts, rtol=1e-9, atol=1e-11)
    want = j_native.roche_dopri5_batch(y0, times, amounts, params, ml, ts, rtol=1e-9, atol=1e-11)
    assert got.shape == (15, 12, D) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=JAX_RTOL, atol=0)
    with pytest.raises(ValueError, match="do not fit"):
        native.roche_dopri5_batch(y0, times[:3], amounts, params, ml, ts)
    if D > 4:
        with pytest.raises(ValueError, match="ml_coef has shape"):
            native.roche_dopri5_batch(y0, times, amounts, params, np.zeros((D, 3)), ts)


def _small(backend, seed=666):
    dg = SyntheticCohort(rng=np.random.RandomState(seed), roche_config=RocheConfig(kel=1), device="cpu",
                         n_sample=40, obs_dim=10, t_max=14, step_size=1, output_sigma=0.2, dose_max=10, latent_dim=6,
                         sparsity=0.5, output_sparsity=0.5, p_remove=0.5, val_size=8, test_size=8)
    dg.generate_data(backend=backend)
    dg.split_sample()
    return dg


def test_native_generation_matches_the_torch_generator(built):
    got, want = _small("native"), _small("torch")
    assert got.solve_stats is None
    for k in DRAWN:
        assert getattr(got, k).tobytes() == getattr(want, k).tobytes(), k
    assert got.latents.dtype == np.float32
    np.testing.assert_allclose(got.latents, want.latents, rtol=GEN_RTOL, atol=GEN_ATOL)
    np.testing.assert_allclose(got.measurements, want.measurements, rtol=0, atol=1e-5)


def test_native_seed_123_cohort_is_data_s123(built):
    """`make_train_cohort(seed=123)`'s cohort (`create_data --which train --seed 123`) with the native solve."""
    got = SyntheticCohort(rng=np.random.RandomState(123), device="cpu", **TRAIN_COHORT)
    got.generate_data(backend="native")
    want = load_pickle(COHORT)["state"]
    for k in DRAWN:
        assert getattr(got, k).tobytes() == want[k].tobytes(), k
    np.testing.assert_allclose(got.latents, want["latents"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.measurements, want["measurements"], rtol=0, atol=1e-5)


def test_a_failed_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    bad = tmp_path / "native.cpp"
    bad.write_text("extern \"C\" int ho_nnls( { this is not C++\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    native._lib.cache_clear()
    try:
        assert not native.available()
        with pytest.raises(RuntimeError, match=r"(?s)building the native library failed.*error"):
            _small("native")
        with pytest.raises(ValueError, match="backend must be"):
            _small("jax")
    finally:
        native._lib.cache_clear()
