"""The control of the dim12 forecast cell: the reference in float32 with TF32 matrix products is not correct by the
cell's limit (the check `test_bench_control.py` makes of the other forecast cell). TF32 exists only on the card."""

import pytest

from benchmark.tests.test_bench_control import test_tf32_reference_fails_a_forecast_cells_limit as control


@pytest.mark.cuda
def test_tf32_reference_fails_the_dim12_forecast_cells_limit():
    control("sim_dim12.forecast_dopri5")
