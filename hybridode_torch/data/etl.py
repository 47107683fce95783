"""Real-data ETL: long-format clinical records -> the model arrays `RealCohort` loads (counterpart of
hybridode/data/etl.py).

The JAX package's functions and names, on numpy alone (the GPU machine has
no pandas): a table is a mapping of column name -> 1-D numpy array of one
length, where JAX takes a DataFrame. The semantics are JAX's:

* `filter_los_cohort` keeps the patients whose length of stay (their
  largest recorded hour) lies in [min_los, max_los);
* `build_temporal_arrays` buckets each record to floor(hour), keeps buckets
  in [0, t_max), and takes each (bucket, patient, feature)'s median of its
  values (NaN values skipped; the mean of the two middle values for an even
  count), as pandas' groupby median does; the mask marks the buckets
  observed; each feature is z-scored over its observed entries (numpy's
  float32 mean and standard deviation, as JAX's function takes them) and is
  zero where unobserved;
* `build_static_array` takes each patient's row of the static table (NaN
  where a patient has none), imputes each covariate's median over the
  patients, and z-scores it;
* `build_treatment_array` sums the doses in each (hour bucket, patient);
* patients are sorted, in every array;
* `run_etl` chains them and writes the same four pickles as JAX's
  (array_xt{type}.pkl, array_xt_mask{type}.pkl, array_at{type}.pkl,
  array_x_constant.pkl), which the port's `RealCohort` loads.

A dose bucket's sum runs in another order than pandas' (compensated) group
sum; in float64, then rounded to the arrays' float32.
"""

from __future__ import annotations

import os
import pickle
from typing import Iterable, Mapping, Sequence

import numpy as np


def _rows(cols: Mapping[str, np.ndarray], keep: np.ndarray) -> dict:
    return {k: np.asarray(v)[keep] for k, v in cols.items()}


def filter_los_cohort(cols: Mapping[str, np.ndarray], min_los: float = 72, max_los: float = 744) -> dict:
    """The rows of the patients whose length of stay (largest recorded hour, NaN hours skipped) lies in
    [min_los, max_los). Defaults: the reference's 3 <= LOS < 31 days, in hours."""
    pid, hour = np.asarray(cols["patient_id"]), np.asarray(cols["hour"], np.float64)
    patients, inv = np.unique(pid, return_inverse=True)
    los = np.full(len(patients), -np.inf)
    seen = ~np.isnan(hour)
    np.maximum.at(los, inv[seen], hour[seen])
    keep = (los >= min_los) & (los < max_los)
    return _rows(cols, keep[inv])


def _positions(pid: np.ndarray, patients: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """-> (whether each row's patient is in the sorted `patients`, its index there)."""
    i = np.clip(np.searchsorted(patients, pid), 0, max(len(patients) - 1, 0))
    inside = (patients[i] == pid) if len(patients) else np.zeros(len(pid), bool)
    return inside, i


def _buckets(cols, patients, t_max):
    """The rows of `patients` whose hour falls in a bucket of [0, t_max) -> (rows, bucket, patient index)."""
    pid, hour = np.asarray(cols["patient_id"]), np.asarray(cols["hour"], np.float64)
    inside, p = _positions(pid, patients)
    with np.errstate(invalid="ignore"):
        bucket = np.floor(hour)
    keep = inside & (bucket >= 0) & (bucket < t_max)
    return keep, bucket[keep].astype(np.intp), p[keep]


def build_temporal_arrays(
    cols: Mapping[str, np.ndarray],
    features: Sequence[str],
    t_max: int,
    patients: Iterable | None = None,
    normalize: bool = True,
) -> tuple[np.ndarray, np.ndarray, list]:
    """(x, mask, patients): hourly-bucketed, median-aggregated features.

    `cols` has `patient_id`, `hour`, `feature` and `value`. x[t, p, f] is
    the median of feature f's values recorded by patient p in hour bucket t
    (floor(hour)); mask marks observed buckets; x is z-scored per feature
    over observed entries and zero where unobserved.
    """
    patients = np.unique(np.asarray(cols["patient_id"] if patients is None else list(patients)))
    n, k = len(patients), len(features)
    x = np.zeros((t_max, n, k), np.float32)
    mask = np.zeros((t_max, n, k), np.float32)

    keep, bucket, p = _buckets(cols, patients, t_max)
    feature = np.asarray(cols["feature"])[keep]
    value = np.asarray(cols["value"], np.float64)[keep]
    names = np.asarray(list(features))
    known, f = _positions(feature, np.sort(names)) if k else (np.zeros(len(feature), bool), feature)
    f = np.argsort(names, kind="stable")[f] if k else f  # index in `features`' own order
    bucket, p, f, value = bucket[known], p[known], f[known], value[known]
    if len(value):
        # Groups of (bucket, patient, feature), each sorted by value with NaN last.
        order = np.lexsort((value, f, p, bucket))
        key = np.stack([bucket, p, f])[:, order]
        value = value[order]
        first = np.flatnonzero(np.r_[True, (key[:, 1:] != key[:, :-1]).any(axis=0)])
        valid = np.add.reduceat(~np.isnan(value), first)  # non-NaN values a group, sorted first
        lo = first + np.maximum(valid - 1, 0) // 2
        hi = first + np.maximum(valid, 1) // 2
        median = np.where(valid > 0, (value[lo] + value[hi]) / 2, np.nan)
        ti, pi, fi = key[:, first]
        x[ti, pi, fi] = median.astype(np.float32)
        mask[ti, pi, fi] = 1.0

    if normalize:
        for j in range(k):
            obs = mask[:, :, j] > 0
            if obs.any():
                v = x[:, :, j][obs]
                x[:, :, j][obs] = (v - v.mean()) / max(float(v.std()), 1e-8)
    x[mask == 0] = 0.0
    return x, mask, patients.tolist()


def build_static_array(
    cols: Mapping[str, np.ndarray],
    covariates: Sequence[str],
    patients: Sequence,
    normalize: bool = True,
) -> np.ndarray:
    """(n_patients, n_covariates) statics: each patient's row (one at most; NaN where it has none), median-imputed,
    optionally z-scored."""
    pid = np.asarray(cols["patient_id"])
    if len(np.unique(pid)) != len(pid):
        raise ValueError("the static table has more than one row for a patient")
    order = np.argsort(pid, kind="stable")
    inside, i = _positions(np.asarray(list(patients)), pid[order])
    s = np.full((len(inside), len(covariates)), np.nan)
    for j, c in enumerate(covariates):
        s[inside, j] = np.asarray(cols[c], np.float64)[order][i[inside]]
    with np.errstate(all="ignore"):
        med = np.nanmedian(s, axis=0) if len(s) else np.full(len(covariates), np.nan)
    med = np.where(np.isfinite(med), med, 0.0)
    idx = np.where(np.isnan(s))
    s[idx] = np.take(med, idx[1])
    if normalize:
        s = (s - s.mean(0)) / np.maximum(s.std(0), 1e-8)
    return s.astype(np.float32)


def build_treatment_array(
    cols: Mapping[str, np.ndarray],
    t_max: int,
    patients: Sequence,
) -> np.ndarray:
    """(t_max, n_patients, 1) dose array from `patient_id`, `hour` and `dose`: doses summed within each hour
    bucket (NaN doses skipped)."""
    patients = np.unique(np.asarray(list(patients)))
    total = np.zeros((t_max, len(patients)), np.float64)
    keep, bucket, p = _buckets(cols, patients, t_max)
    dose = np.asarray(cols["dose"], np.float64)[keep]
    np.add.at(total, (bucket, p), np.where(np.isnan(dose), 0.0, dose))
    return total.astype(np.float32)[..., None]


def run_etl(
    temporal: Mapping[str, np.ndarray],
    static: Mapping[str, np.ndarray],
    treatment: Mapping[str, np.ndarray],
    features: Sequence[str],
    covariates: Sequence[str],
    t_max: int,
    out_dir: str,
    data_type: str = "5",
    min_los: float = 72,
    max_los: float = 744,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, list]:
    """Full pipeline: LOS filter -> arrays -> the four RealCohort pickles; -> (x, a, mask, s, patients)."""
    kept = filter_los_cohort(temporal, min_los=min_los, max_los=max_los)
    x, mask, patients = build_temporal_arrays(kept, features, t_max)
    s = build_static_array(static, covariates, patients)
    a = build_treatment_array(treatment, t_max, patients)

    os.makedirs(out_dir, exist_ok=True)
    out = {
        f"array_xt{data_type}.pkl": x,
        f"array_xt_mask{data_type}.pkl": mask,
        f"array_at{data_type}.pkl": a,
        "array_x_constant.pkl": s,
    }
    for name, arr in out.items():
        with open(os.path.join(out_dir, name), "wb") as f:
            pickle.dump(arr, f)
    return x, a, mask, s, patients
