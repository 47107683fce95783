"""The FLOP and byte counts, against counts reckoned by hand."""

import json
import os

from benchmark import costs
from benchmark.harness.spec import BENCH_DIR

SIM = json.load(open(os.path.join(BENCH_DIR, "configs", "lhm_sim_hybrid.json")))


def test_roche_rk4_launch_of_a_forecast_request():
    # 2,550 rows (50 patients, the mean and 50 draws), D = 6, 15 grid points, 8 RK4 steps a day:
    # a field evaluation 4 + 26 + 2*6*2 + 2*2 = 58, a step 4*58 + 17*6 = 334 -> 2550 * 14 * 8 * 334.
    flops, nbytes = costs.roche_rk4_kernel(2550, 6, 15, 8)
    assert flops == 95_390_400
    # y0 15,300 + times and amounts 5,100 + 13 constants + w 12 + b 2 + grid 15 + out 229,500 floats.
    assert nbytes == 4 * 249_942 == 999_768


def test_one_dopri5_trial_step_of_the_simulation_model():
    # six new stages of the 58-FLOP field, 111 FLOPs per state for the step's arithmetic, 10 for the controller
    assert costs.dopri5_trial(6, costs.roche_field(6)) == 6 * 58 + 111 * 6 + 10 == 1024


def test_training_counts_the_trials_needed_not_the_budget():
    mix = {"batch_size": 50, "val_t0": 5}
    few, many = (costs.train_window(SIM, mix, 1, 0, trials) for trials in (100.0, 200.0))
    # 100 more trial steps for each of 50 patients, forward and backward
    assert many - few == 3 * 50 * 100 * 1024
