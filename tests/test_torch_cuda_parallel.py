"""Data parallelism on the card: a world of one NCCL rank, the fused DP restart captured with its all-reduces.

The cases skip without a GPU. This file imports no JAX, so that the GPU
machine, which has none, runs it:
`python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_parallel.py`.

The hybrid on data_s123 at full width (obs 20, latent 6, per-patient
DOPRI5) at batch 8 with 16 validation patients, 6 iterations, validation
every 2, through `variational_training_loop` with a one-rank "data" mesh
against the same call without one. A one-rank all-reduce and a division by 1
are exact, so the curves agree within rtol 1e-6 (chip_smoke.py's DP_RTOL);
the best parameters within tests/test_torch_cuda_fused.py's rtol 1e-4 /
atol 1e-6.
"""

import json
import os

import numpy as np
import pytest
import torch

from hybridode_torch.cli.common import build_sim_model
from hybridode_torch.config import DataConfig
from hybridode_torch.data import SyntheticCohort
from hybridode_torch.inference import init_vi, variational_training_loop
from hybridode_torch.parallel import close_world, init_world, make_mesh
from hybridode_torch.parallel.mesh import all_reduce_sum

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
COHORT = os.path.join(ROOT, "data_s123", "datafile_dose_exp.pkl")
CURVE_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-6, 1e-4, 1e-6


@pytest.fixture
def nccl_mesh(tmp_path):
    """A world of one NCCL rank (FileStore under tmp_path) and its one-rank "data" mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    init_world(0, 1, str(tmp_path / "store"), "cuda")
    try:
        yield make_mesh(1)
    finally:
        close_world()


def _train(tmp_path, name, crit, **kw):
    cohort = SyntheticCohort.load(COHORT, device="cuda")
    cohort.set_val_size(16)
    cohort.set_train_size(16 + cohort.test_size + 64)  # a sample of 64 training patients
    model = build_sim_model("hybrid", DataConfig(), mc_size=10)
    params = init_vi(torch.Generator().manual_seed(0), model, device="cuda")
    events = str(tmp_path / f"{name}.jsonl")
    best, best_on_disk, _ = variational_training_loop(
        niters=6, data_generator=cohort, model=model, params=params, batch_size=8, lr=0.01, test_freq=2,
        generator=torch.Generator().manual_seed(1), path=str(tmp_path / name) + "_", early_stop=10, shuffle=False,
        val_criterion=crit, verbose=False, events_path=events, fused=True, **kw)
    torch.cuda.synchronize()
    recs = [json.loads(ln) for ln in open(events)]
    return best, best_on_disk, [(r["itr"], r["val_loss"], r["train_loss"]) for r in recs if r["event"] == "val"], recs


@pytest.mark.cuda
@pytest.mark.parametrize("crit", ["forecast", "elbo"])
def test_one_rank_nccl_dp_restart_is_captured_and_matches_the_restart_without_a_mesh(nccl_mesh, tmp_path, crit):
    calls = all_reduce_sum.calls
    got, got_best, curve, recs = _train(tmp_path, "dp", crit, mesh=nccl_mesh)
    # The eager warm-up and the capture of the step and of the validation: their all-reduces run as Python calls;
    # every later step and validation is a replay.
    assert all_reduce_sum.calls - calls == 4
    want, want_best, want_curve, _ = _train(tmp_path, "one", crit)
    assert sorted(r["graph"] for r in recs if r["event"] == "capture") == ["step", "validation"]
    assert [c[0] for c in curve] == [2, 4, 6] and np.isfinite(np.asarray(curve)).all()
    np.testing.assert_allclose(curve, want_curve, rtol=CURVE_RTOL)
    np.testing.assert_allclose(got_best, want_best, rtol=CURVE_RTOL)
    for (k, x), (_, y) in zip(got.named_parameters(), want.named_parameters()):
        torch.testing.assert_close(x, y, rtol=PARAM_RTOL, atol=PARAM_ATOL, msg=k)
