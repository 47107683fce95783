"""Worlds of several GPUs: two 2-rank NCCL worlds one after the other, and the lockstep restarts sharded over GPUs.

The cases skip under 2 GPUs. This file imports no JAX, so that a GPU machine,
which has none, runs it:
`python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_multigpu.py`.

Every world has a wall-clock timeout (`parallel.launch`), so a world that
hangs fails its test with each rank's last traceback instead of holding the
run. The two-world check is `multigpu_study.two_worlds`: `run_simulation.run`
of the hybrid on data_s123 with `--dp 2`, fused and captured, twice, then in
a world of one rank: each `--dp 2` run's first validation within 1e-6 of the
one-rank run's and the two worlds' equal. The lockstep restarts: two
restarts of the lockstep hybrid (the adjoint solver; batch 25, 2
iterations, one validation) sharded one a GPU against the same two in one
batched program on one GPU: the same best loss within rtol 1e-5 (the
shard-against-seq tolerance of tests/test_torch_parallel.py).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
import multigpu_study  # noqa: E402

TIMEOUT = 300.0  # seconds a world may take
BEST_RTOL = 1e-5


@pytest.fixture
def two_gpus():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 NVIDIA GPUs")


@pytest.mark.cuda
def test_two_nccl_worlds_in_turn_end_and_match_one_rank(two_gpus, tmp_path):
    out = multigpu_study.two_worlds(str(tmp_path), "cuda", TIMEOUT)
    assert out["first_val_rel_diff"] <= multigpu_study.CHECK_RTOL, out
    assert out["worlds_rel_diff"] == 0, out
    assert out["ok"], out


@pytest.mark.cuda
def test_lockstep_restarts_sharded_over_two_gpus_match_vmap(two_gpus, tmp_path):
    common = dict(batch=25, iters=2, test_freq=2, device="cuda", n_restart=2, lockstep=True)
    runs = {}
    for name, world, flags in (("shard", 2, dict(restart_mode="shard", restart_devices=2)),
                               ("vmap", 1, dict(restart_mode="vmap"))):
        kw = multigpu_study._kwargs(str(tmp_path / f"{name}_"), str(tmp_path / f"{name}.jsonl"), **common, **flags)
        runs[name], _ = multigpu_study.in_world(kw, world, "cuda", TIMEOUT)
    assert np.isfinite(runs["shard"]["best_on_disk"])
    np.testing.assert_allclose(runs["shard"]["best_on_disk"], runs["vmap"]["best_on_disk"], rtol=BEST_RTOL)
    assert [v[0] for v in runs["shard"]["val"]] == [v[0] for v in runs["vmap"]["val"]]
