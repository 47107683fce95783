"""Parameters and checkpoints between the JAX package and the port, and the port's isolation.

Round trips are bit-equal: no array is transposed, reordered or recast.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from hybridode.cli.common import build_sim_model as j_build_sim_model
from hybridode.config import DataConfig as JDataConfig
from hybridode.inference import init_vi as j_init_vi
from hybridode.inference import load_checkpoint as j_load_checkpoint
from hybridode.inference import save_checkpoint as j_save_checkpoint
from hybridode_torch.convert import params_from_jax, params_to_jax
from hybridode_torch.inference import load_checkpoint, save_checkpoint

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _assert_same_tree(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_params(method="hybrid", ablate=False, seed=0):
    model = j_build_sim_model(method, JDataConfig(), ode_method="rk4", ablate=ablate)
    return model, j_init_vi(jax.random.PRNGKey(seed), model)


@pytest.mark.parametrize("method,ablate", [("hybrid", False), ("expert", False), ("hybrid", True)])
def test_round_trip_is_bit_equal(method, ablate):
    _, jparams = _jax_params(method, ablate)
    params = params_from_jax(jparams, device="cpu")
    _assert_same_tree(params_to_jax(params), jparams)
    names = dict(params.named_parameters())
    assert names.keys() == {k for k, _ in _leaves(jparams)}  # the JAX tree's paths, name for name
    frozen = {k for k, p in names.items() if not p.requires_grad}
    want_frozen = {k for k in names if k.startswith("decoder.ode.expert.") or k.startswith("decoder.ode.theta_")}
    assert frozen == want_frozen and len([k for k in frozen if ".expert." in k]) == 13


def test_jax_checkpoint_loads_into_port_and_back(tmp_path):
    model, jparams = _jax_params(seed=1)
    j_save_checkpoint(str(tmp_path / "jax_"), model.model_name, jparams, itr=40, best_loss=12.5)
    params, itr, best = load_checkpoint(str(tmp_path / "jax_"), model.model_name, device="cpu")
    assert (itr, best) == (40, 12.5)
    _assert_same_tree(params_to_jax(params), jparams)

    save_checkpoint(str(tmp_path / "port_"), model.model_name, params, itr=41, best_loss=11.0)
    back, itr, best = j_load_checkpoint(str(tmp_path / "port_"), model.model_name)
    assert (itr, best) == (41, 11.0)
    _assert_same_tree(back, jparams)


def test_params_land_on_the_requested_device():
    _, jparams = _jax_params()
    params = params_from_jax(jparams, device="cpu")
    assert {p.device.type for p in params.parameters()} == {"cpu"}
    assert {p.dtype for p in params.parameters()} == {torch.float32}


def test_port_imports_no_jax_and_nothing_of_hybridode():
    script = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import hybridode_torch
        mods = [m.name for m in pkgutil.walk_packages(hybridode_torch.__path__, "hybridode_torch.")]
        for name in mods:
            importlib.import_module(name)
        for name in ("solvers.adjoint", "solvers.calibrate", "utils.profiling", "data.synthetic", "cli.create_data",
                     "parallel.mesh", "parallel.eval", "parallel.dryrun", "parallel.launch", "native", "data.etl"):
            assert "hybridode_torch." + name in mods, name
        from hybridode_torch.data import SyntheticCohort
        c = SyntheticCohort.load("data_s123/datafile_dose_exp.pkl", device="cpu")
        assert c.test_size == 200
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "hybridode", "pandas"))
        assert not leaked, leaked
        print(len(mods))
        """
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 50  # every module of the package was imported
