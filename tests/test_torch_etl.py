"""The port's numpy ETL (hybridode_torch/data/etl.py) against the JAX package's pandas ETL, on the CPU.

Synthetic long-format records made from a numpy seed go through JAX's
functions as DataFrames (pandas is on this machine; the cases skip without
it) and through the port's as mappings of the same columns. What must hold:
the patient order equal; the temporal arrays, the masks and the statics
equal exactly (the same medians, the mean of the two middle values for an
even count, NaN values skipped, and the same numpy normalisation); the
treatment array within rtol 1e-7 (a bucket's doses summed in float64 in
another order than pandas' compensated sum, then rounded to float32, which
one float32 ulp, 6e-8, covers); the four pickles `run_etl` writes loaded by
the port's `RealCohort`, equal to JAX's.
"""

import os
import pickle

import numpy as np
import pytest

from hybridode_torch.data import RealCohort
from hybridode_torch.data import etl

pd = pytest.importorskip("pandas")
from hybridode.data import etl as j_etl  # noqa: E402

FEATURES = ["map", "hr", "spo2"]
TREAT_RTOL = 1e-7


def _records(n_patients=30, t_max=120, seed=0):
    """Records of patients with ids in a shuffled order: 0-3 values a bucket for each of 4 features (one not asked
    for), a few NaN values, one bucket whose only values are NaN; statics with a missing patient and NaNs; doses."""
    rng = np.random.RandomState(seed)
    ids = rng.permutation(n_patients) * 7 + 3
    rows = []
    for p in ids:
        span = rng.randint(5, t_max)
        for t in range(span):
            for f in FEATURES + ["temp"]:
                for _ in range(rng.randint(0, 4)):
                    v = np.nan if rng.rand() < 0.03 else rng.randn() * 10 + 50
                    rows.append((int(p), t + rng.rand(), f, v))
    rows += [(int(ids[0]), 2.5, "hr", np.nan), (int(ids[0]), 2.7, "hr", np.nan)]  # (2, ids[0], hr): NaN alone
    temporal = pd.DataFrame(rows, columns=["patient_id", "hour", "feature", "value"])
    temporal = temporal[~((temporal.patient_id == ids[0]) & (temporal.hour.between(2, 3))
                          & (temporal.feature == "hr") & temporal.value.notna())]
    kept = ids[1:]  # the first patient has no static row
    static = pd.DataFrame({"patient_id": kept, "age": rng.randint(20, 90, len(kept)),
                           "bmi": np.where(rng.rand(len(kept)) < 0.3, np.nan, rng.rand(len(kept)) * 10 + 20)})
    treatment = pd.DataFrame({"patient_id": rng.choice(ids, 300), "hour": rng.rand(300) * t_max,
                              "dose": np.where(rng.rand(300) < 0.05, np.nan, rng.rand(300) * 5)})
    return temporal, static, treatment


def _cols(df):
    return {k: df[k].to_numpy() for k in df.columns}


@pytest.fixture(scope="module")
def records():
    return _records()


def test_los_filter_keeps_the_same_rows(records):
    temporal, _, _ = records
    want = j_etl.filter_los_cohort(temporal, min_los=50, max_los=100)
    got = etl.filter_los_cohort(_cols(temporal), min_los=50, max_los=100)
    assert 0 < len(want) < len(temporal)
    for k in temporal.columns:
        np.testing.assert_array_equal(got[k], want[k].to_numpy(), err_msg=k)


@pytest.mark.parametrize("normalize", [True, False])
def test_temporal_arrays_match(records, normalize):
    temporal, _, _ = records
    want_x, want_mask, want_p = j_etl.build_temporal_arrays(temporal, FEATURES, 100, normalize=normalize)
    x, mask, patients = etl.build_temporal_arrays(_cols(temporal), FEATURES, 100, normalize=normalize)
    assert patients == list(want_p) == sorted(patients)
    assert x.dtype == mask.dtype == np.float32 and x.shape == (100, 30, 3)
    np.testing.assert_array_equal(mask, want_mask)
    np.testing.assert_array_equal(x, want_x)  # NaN where JAX has NaN (the NaN-only bucket's feature)
    # A patient subset, in another order than sorted.
    sub = [patients[5], patients[2], patients[9]]
    want_x, want_mask, want_p = j_etl.build_temporal_arrays(temporal, FEATURES, 100, patients=sub)
    x, mask, patients = etl.build_temporal_arrays(_cols(temporal), FEATURES, 100, patients=sub)
    assert patients == list(want_p) == sorted(sub)
    np.testing.assert_array_equal(mask, want_mask)
    np.testing.assert_array_equal(x, want_x)


def test_median_of_an_even_count_is_the_mean_of_the_middle_two():
    cols = {"patient_id": np.zeros(4, int), "hour": np.array([1.1, 1.7, 1.9, 1.2]), "feature": np.array(["hr"] * 4),
            "value": np.array([1.0, 5.0, 100.0, 7.0])}
    x, mask, _ = etl.build_temporal_arrays(cols, ["hr"], t_max=3, normalize=False)
    want, _, _ = j_etl.build_temporal_arrays(pd.DataFrame(cols), ["hr"], t_max=3, normalize=False)
    assert x[1, 0, 0] == want[1, 0, 0] == 6.0 and mask[:, 0, 0].tolist() == [0, 1, 0]


def test_static_and_treatment_arrays_match(records):
    temporal, static, treatment = records
    _, _, patients = etl.build_temporal_arrays(_cols(temporal), FEATURES, 100)
    for normalize in (True, False):
        want = j_etl.build_static_array(static, ["age", "bmi"], patients, normalize=normalize)
        got = etl.build_static_array(_cols(static), ["age", "bmi"], patients, normalize=normalize)
        assert got.dtype == np.float32 and np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)
    want = j_etl.build_treatment_array(treatment, 100, patients)
    got = etl.build_treatment_array(_cols(treatment), 100, patients)
    assert got.shape == (100, 30, 1) and got.dtype == np.float32 and (got > 0).any()
    np.testing.assert_allclose(got, want, rtol=TREAT_RTOL, atol=0)
    with pytest.raises(ValueError, match="more than one row"):
        etl.build_static_array({"patient_id": np.array([1, 1]), "age": np.array([3.0, 4.0])}, ["age"], [1])


def test_run_etl_writes_what_jax_writes_and_the_port_loads_it(records, tmp_path):
    temporal, static, treatment = records
    args = dict(features=FEATURES, covariates=["age", "bmi"], t_max=100, data_type="5", min_los=10, max_los=110)
    want = j_etl.run_etl(temporal, static, treatment, out_dir=str(tmp_path / "jax"), **args)
    got = etl.run_etl(_cols(temporal), _cols(static), _cols(treatment), out_dir=str(tmp_path / "port"), **args)
    assert got[4] == list(want[4])
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g, w, rtol=TREAT_RTOL, atol=0)
    for name in ("array_xt5.pkl", "array_xt_mask5.pkl", "array_at5.pkl", "array_x_constant.pkl"):
        with open(tmp_path / "port" / name, "rb") as f, open(tmp_path / "jax" / name, "rb") as g:
            np.testing.assert_allclose(pickle.load(f), pickle.load(g), rtol=TREAT_RTOL, atol=0, err_msg=name)
    dg = RealCohort(data_path=str(tmp_path / "port"), data_type="5", latent_dim=10, val_size=4, test_size=4,
                    device="cpu")
    dg.split_sample()
    n = len(got[4])
    assert (dg.obs_dim, dg.static_dim, dg.t_max, dg.n_sample, dg.train_size) == (3, 2, 100, n, n - 8)
    assert dg.get_split("train", 2, 0)["statics"].shape == (100, 2, 2)
    assert os.path.exists(tmp_path / "port" / "array_xt5.pkl")
