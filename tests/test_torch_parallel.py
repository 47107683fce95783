"""The port's data and evaluation parallelism (hybridode_torch/parallel/) on gloo CPU ranks.

One world of 4 ranks (spawned once for the module, `_rank_checks`) runs every
multi-rank case; this process computes the references: the single-process
port and the JAX package's functions (on the 8 virtual CPU devices of
tests/conftest.py). The ranks import only `hybridode_torch`: this module
imports the JAX package inside the fixtures and tests that use it.

Models are small: the tiny hybrid of tests/test_parallel.py (obs 6, latent
4, RK4) for the DP step, and the hybrid at obs 8, latent 6, RK4 at a quarter
step on a 48-patient cohort that the JAX package generates (16 train, 8 val,
16 test) for the loops, the batched restarts and the evaluation.

Tolerances, each JAX's own for the same check (tests/test_parallel.py,
tests/test_inference.py) unless it says otherwise:
* one DP step on 2 and 4 ranks against the single-process step: the loss
  rtol 1e-5, the parameters after one Adam step atol 2e-6, with and without
  the ELBO's noise (every rank takes its rows of the global draw, so DP
  equals single-process training up to the order of float32 sums);
* the port's DP step against JAX's `make_dp_train_step` on 8 devices: rtol
  1e-3 / atol 1e-4 (the port against JAX elsewhere, test_torch_train.py);
* loops: DP against single-process and fused DP against host DP, the best
  loss rtol 1e-5, curves rtol 2e-5 / atol 1e-6;
* `--restart_mode shard` against `seq`: the same checkpoint iteration, the
  best loss within chip_smoke.py's FUSED_BEST_RTOL 1e-5;
* the (data, mc) sharded chunk against `_eval_chunk`: rtol 2e-4 / atol 2e-6.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from hybridode_torch.cli import common, run_simulation, run_simulation_flow
from hybridode_torch.cli.common import build_sim_model, restart_generators
from hybridode_torch.config import DataConfig, EvalConfig, OptimConfig
from hybridode_torch.convert import params_from_jax
from hybridode_torch.data import SyntheticCohort
from hybridode_torch.eval.metrics import _eval_chunk, draw_chunk_noise, evaluate
from hybridode_torch.inference import VIModel, fused, load_checkpoint, make_optimizer, train_step
from hybridode_torch.inference import init_vi, variational_training_loop
from hybridode_torch.inference.train import check_dp_divisibility
from hybridode_torch.models.decoders import SimDecoderSpec
from hybridode_torch.models.encoders import EncoderLSTMSpec
from hybridode_torch.parallel import evaluate_sharded, launch, make_mesh, make_mesh_2d, make_sharded_eval_chunk
from hybridode_torch.parallel.eval import check_sharded_eval
from hybridode_torch.parallel.mesh import make_dp_train_step, member

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
DC = DataConfig(obs_dim=8, latent_dim=6)
LOSS_RTOL, STEP_ATOL, JAX_RTOL, JAX_ATOL = 1e-5, 2e-6, 1e-3, 1e-4
BEST_RTOL, CURVE_RTOL, CURVE_ATOL, EVAL_RTOL, EVAL_ATOL = 1e-5, 2e-5, 1e-6, 2e-4, 2e-6
COLLECTIVE_TIMEOUT = 1.0  # seconds: a world's collectives time out after this (test_eval_mesh_csv..., wait_idle)
LOOPS = [(crit, fused_) for crit in ("elbo", "forecast") for fused_ in (False, True)]
CSV = ("rmse_z0", "rmse_x", "cprs_z0", "cprs_x")


# --- models and data, shared by the ranks and this process -------------------------------------------------------


def _tiny(elbo):
    """The port's twin of tests/test_parallel.py's tiny_model."""
    enc = EncoderLSTMSpec(7, 8, 4, normalize=True)
    dec = SimDecoderSpec(6, 4, 1, t_max=4, step_size=1, roche=True, method="rk4", ode_step_size=0.5)
    return VIModel(kind="sim", encoder_spec=enc, decoder_spec=dec, elbo=elbo, prior="exponential", mc_size=4)


def _sim(flow=False):
    m = build_sim_model("hybrid", DC, flow=flow, mc_size=5, num_flows=2)
    return m._replace(decoder_spec=m.decoder_spec._replace(method="rk4", ode_step_size=0.25))


def _cohort(path):
    c = SyntheticCohort.load(path, device="cpu")
    c.set_train_size(40)  # 16 training patients; 8 validate, 16 test
    return c


def _state(params):
    return {k: v.detach().numpy().copy() for k, v in params.named_parameters()}


def _loop(cohort_path, workdir, name, crit, fused_, **kw):
    """One restart of the loop from seeded weights; -> (best, best params, curve rows)."""
    model = _sim()
    params = init_vi(torch.Generator().manual_seed(0), model, device="cpu")
    events = os.path.join(workdir, f"{name}.jsonl")
    best_params, best, _ = variational_training_loop(
        niters=2, data_generator=_cohort(cohort_path), model=model, params=params, batch_size=8, lr=0.01,
        test_freq=1, generator=torch.Generator().manual_seed(1), path=os.path.join(workdir, name + "_"),
        early_stop=10, shuffle=True, val_criterion=crit, verbose=False, events_path=events, fused=fused_, **kw)
    curve = [(r["itr"], r["val_loss"], r["train_loss"]) for r in map(json.loads, open(events))
             if r["event"] == "val"] if os.path.exists(events) else None
    return best, _state(best_params), curve


def _shard_pairs():
    main = torch.Generator().manual_seed(5)
    return [restart_generators(main) for _ in range(2)]


# --- the ranks ---------------------------------------------------------------------------------------------------


def _rank_checks(tree, batch, cohort_path, workdir):
    """Every multi-rank case, on each rank of a world of 4; -> rank 0's results."""
    out = {"dp": {}}
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    for n in (4, 2):  # the 2-rank mesh takes ranks 0 and 1; ranks 2 and 3 wait
        mesh = make_mesh(n)
        if not member(mesh):
            continue
        for elbo in (False, True):
            params = params_from_jax(tree, device="cpu")
            step = make_dp_train_step(_tiny(elbo), make_optimizer(0.01, params), mesh)
            loss = float(step(params, batch, torch.Generator().manual_seed(1)))
            out["dp"][n, elbo] = (loss, _state(params))

    mesh = make_mesh(4)
    for crit, fused_ in LOOPS:
        out[crit, fused_] = _loop(cohort_path, workdir, f"dp_{crit}_{fused_}", crit, fused_, mesh=mesh)

    model = _sim()
    _, best, _ = fused.fused_experiment_loop(
        niters=2, data_generator=_cohort(cohort_path), model=model, restart_generators=_shard_pairs(), batch_size=8,
        lr=0.01, test_freq=1, early_stop=10, path=os.path.join(workdir, "shard_"), shuffle=True,
        val_criterion="forecast", device="cpu", restart_devices=2, dp_devices=2, verbose=False)
    out["shard"] = (best, load_checkpoint(os.path.join(workdir, "shard_"), model.model_name, "cpu")[1])

    mesh = make_mesh_2d(2, 2)
    c = _cohort(cohort_path)
    for flow in (False, True):
        model = _sim(flow)
        params = init_vi(torch.Generator().manual_seed(3), model, device="cpu")
        noise = draw_chunk_noise(model, 8, 16, torch.Generator().manual_seed(4), "cpu")
        chunk = make_sharded_eval_chunk(model, mesh, 5, 8, c.expert_dim)
        out["chunk", flow] = [t.numpy() for t in chunk(params, c.get_split("test", 16, 0), *noise)]
        out["evaluate", flow] = evaluate_sharded(params, model, c, 8, 5, mesh, mc_itr=8,
                                                 generator=torch.Generator().manual_seed(6), verbose=False, device="cpu")
    return out


# --- fixtures ----------------------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cohort_path(tmp_path_factory):
    """48 patients (24 train, 8 val, 16 test), obs 8, latent 6, written by the JAX package."""
    from hybridode.config import RocheConfig
    from hybridode.data import SyntheticCohort as JSyntheticCohort

    dg = JSyntheticCohort(n_sample=48, obs_dim=8, t_max=14, step_size=1, roche_config=RocheConfig(kel=1),
                          output_sigma=0.2, dose_max=10, latent_dim=6, sparsity=0.5, output_sparsity=0.5, p_remove=0.5,
                          val_size=8, test_size=16, rng=np.random.RandomState(666))
    dg.generate_data()
    dg.split_sample()
    path = str(tmp_path_factory.mktemp("cohort") / "cohort.pkl")
    dg.save(path)
    return path


@pytest.fixture(scope="module")
def jax_tiny():
    """JAX's tiny model (tests/test_parallel.py) from PRNGKey(0) and its batch of 16, as numpy, and the model."""
    import jax
    import jax.numpy as jnp

    from hybridode.inference import VIModel as JVIModel
    from hybridode.inference import init_vi as j_init_vi
    from hybridode.models.decoders import SimDecoderSpec as JSimDecoderSpec
    from hybridode.models.encoders import EncoderLSTMSpec as JEncoderLSTMSpec

    def model(elbo):
        enc = JEncoderLSTMSpec(7, 8, 4, normalize=True)
        dec = JSimDecoderSpec(6, 4, 1, t_max=4, step_size=1, roche=True, method="rk4", ode_step_size=0.5)
        return JVIModel(kind="sim", encoder_spec=enc, decoder_spec=dec, elbo=elbo, prior="exponential", mc_size=4)

    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    batch = {"measurements": jax.random.normal(k1, (5, 16, 6)), "actions": jnp.zeros((5, 16, 1)).at[2, :, 0].set(0.3),
             "masks": (jax.random.uniform(k2, (5, 16, 6)) > 0.3).astype(jnp.float32),
             "latents": jnp.abs(jax.random.normal(k1, (5, 16, 4))) * 0.01}
    jparams = j_init_vi(jax.random.PRNGKey(0), model(False))
    return dict(tree=jax.tree_util.tree_map(np.asarray, jparams), jparams=jparams, model=model,
                batch={k: np.array(v) for k, v in batch.items()}, jbatch=batch)


@pytest.fixture(scope="module")
def world(cohort_path, jax_tiny, tmp_path_factory):
    """Rank 0's results of `_rank_checks` on a world of 4 gloo ranks, and its working directory."""
    workdir = str(tmp_path_factory.mktemp("world"))
    return launch(_rank_checks, 4, jax_tiny["tree"], jax_tiny["batch"], cohort_path, workdir, device="cpu",
                  timeout=600), workdir


@pytest.fixture(scope="module")
def single(cohort_path, tmp_path_factory):
    """The loops of the world, one process, one rank."""
    workdir = str(tmp_path_factory.mktemp("single"))
    return {(crit, fused_): _loop(cohort_path, workdir, f"sp_{crit}_{fused_}", crit, fused_) for crit, fused_ in LOOPS}


def _assert_states(a, b, **tol):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **tol)


# --- one DP step ---------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("elbo", [False, True])
def test_dp_step_matches_the_single_process_step(world, jax_tiny, n, elbo):
    """The mean of the ranks' sum/B_local losses is the global sum/B; with the ELBO every rank takes its rows of
    the global noise, so the step after Adam is the single-process step's (atol 2e-6)."""
    params = params_from_jax(jax_tiny["tree"], device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in jax_tiny["batch"].items()}
    loss = float(train_step(params, make_optimizer(0.01, params), _tiny(elbo), batch, torch.Generator().manual_seed(1)))
    got_loss, got = world[0]["dp"][n, elbo]
    np.testing.assert_allclose(got_loss, loss, rtol=LOSS_RTOL)
    _assert_states(got, _state(params), atol=STEP_ATOL, rtol=0)
    assert any(not np.allclose(got[k], v) for k, v in jax_tiny["tree"]["encoder"]["lin"].items() for k in
               ("encoder.lin." + k,))  # the step moved the weights


def test_dp_step_matches_jax_dp_step_on_eight_devices(world, jax_tiny):
    """The port's 4-rank step against JAX's shard_map step on its 8 virtual devices (elbo=False, no noise)."""
    import jax

    from hybridode.inference import make_optimizer as j_make_optimizer
    from hybridode.parallel import make_dp_train_step as j_make_dp_train_step
    from hybridode.parallel import make_mesh as j_make_mesh
    from hybridode.parallel import replicate as j_replicate
    from hybridode.parallel import shard_batch as j_shard_batch

    jparams, model = jax_tiny["jparams"], jax_tiny["model"](False)
    mesh = j_make_mesh(8)
    opt = j_make_optimizer(0.01, jparams)
    step = j_make_dp_train_step(model, opt, mesh)
    p, _, loss = step(j_replicate(jparams, mesh), j_replicate(opt.init(jparams), mesh),
                      j_shard_batch(jax_tiny["jbatch"], mesh), jax.random.PRNGKey(1))
    got_loss, got = world[0]["dp"][4, False]
    np.testing.assert_allclose(got_loss, float(loss), rtol=JAX_RTOL)
    want = _state(params_from_jax(jax.tree_util.tree_map(np.asarray, p), device="cpu"))
    _assert_states(got, want, rtol=JAX_RTOL, atol=JAX_ATOL)


# --- the loops -----------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("crit,fused_", LOOPS)
def test_dp_loop_matches_its_single_process_self(world, single, crit, fused_):
    """4 ranks against one process, the host loop and the fused loop each: curves, best loss, best params."""
    best, state, curve = world[0][crit, fused_]
    want_best, want_state, want_curve = single[crit, fused_]
    assert len(curve) == 2 and np.isfinite(np.asarray(curve)).all()
    np.testing.assert_allclose(curve, want_curve, rtol=CURVE_RTOL, atol=CURVE_ATOL)
    np.testing.assert_allclose(best, want_best, rtol=BEST_RTOL)
    _assert_states(state, want_state, rtol=1e-4, atol=1e-6)  # tests/test_torch_fused.py's parameter tolerance


@pytest.mark.parametrize("crit", ["elbo", "forecast"])
def test_fused_dp_matches_host_dp(world, cohort_path, crit):
    """The fused DP restart against the host DP loop. The forecast criterion sums the masked error and the mask
    count over the ranks and divides once; the ranks' blocks of the validation fold hold unequal mask counts, so
    a mean of per-rank ratios would not match."""
    host, got = world[0][crit, False], world[0][crit, True]
    np.testing.assert_allclose(got[0], host[0], rtol=BEST_RTOL)
    np.testing.assert_allclose(got[2], host[2], rtol=CURVE_RTOL, atol=CURVE_ATOL)
    if crit == "forecast":
        masks = _cohort(cohort_path)._fold("val")["masks"][5:]
        counts = [float(masks[:, 2 * r:2 * r + 2].sum()) for r in range(4)]
        assert len(set(counts)) > 1, counts


def test_shard_selects_the_checkpoint_of_seq(world, cohort_path, tmp_path):
    """Two restarts on a 2 x 2 (restart, data) world against the sequential chain of fused restarts."""
    model, best_on_disk = _sim(), 1e9
    for gen_init, gen_train in _shard_pairs():
        _, best_on_disk, _ = variational_training_loop(
            niters=2, data_generator=_cohort(cohort_path), model=model,
            params=init_vi(gen_init, model, device="cpu"), batch_size=8, lr=0.01, test_freq=1, generator=gen_train,
            path=str(tmp_path / "seq_"), best_on_disk=best_on_disk, early_stop=10, shuffle=True,
            val_criterion="forecast", verbose=False)
    best, itr = world[0]["shard"]
    assert itr == load_checkpoint(str(tmp_path / "seq_"), model.model_name, "cpu")[1]
    np.testing.assert_allclose(best, best_on_disk, rtol=BEST_RTOL)


# --- the (data, mc) evaluation ---------------------------------------------------------------------------------------


@pytest.mark.parametrize("flow", [False, True])
def test_sharded_chunk_matches_eval_chunk(world, cohort_path, flow):
    """2 x 2 (data, mc): every rank's patient and MC block of the same draws, the MC decodes all-gathered."""
    model = _sim(flow)
    params = init_vi(torch.Generator().manual_seed(3), model, device="cpu")
    noise = draw_chunk_noise(model, 8, 16, torch.Generator().manual_seed(4), "cpu")
    c = _cohort(cohort_path)
    want = _eval_chunk(params, model, c.get_split("test", 16, 0), 5, c.expert_dim, *noise)
    for g, w in zip(world[0]["chunk", flow], want):
        np.testing.assert_allclose(g, w.numpy(), rtol=EVAL_RTOL, atol=EVAL_ATOL)


@pytest.mark.parametrize("flow", [False, True])
def test_evaluate_sharded_matches_evaluate(world, cohort_path, flow):
    """The deterministic metrics of the whole test fold (the bootstrap SEs resample afresh)."""
    model = _sim(flow)
    params = init_vi(torch.Generator().manual_seed(3), model, device="cpu")
    want = evaluate(params, model, _cohort(cohort_path), 8, 5, mc_itr=8, generator=torch.Generator().manual_seed(6),
                    verbose=False, device="cpu")
    got = world[0]["evaluate", flow]
    for i in (0, 2, 3, 5):
        np.testing.assert_allclose(got[i], want[i], rtol=EVAL_RTOL, atol=EVAL_ATOL)


# --- errors --------------------------------------------------------------------------------------------------------


def test_a_mesh_larger_than_the_world_raises_the_jax_error():
    with pytest.raises(ValueError, match="requested a 2-device 'data' mesh but only 1 devices are available"):
        make_mesh(2)
    with pytest.raises(ValueError, match=r"requested a 2x2 \('data', 'mc'\) mesh but only 1 devices are available"):
        make_mesh_2d(2, 2)


def test_divisibility_errors():
    with pytest.raises(ValueError, match="train mini-batch width 6 not divisible by dp_devices 4"):
        check_dp_divisibility(4, 6, 8)
    with pytest.raises(ValueError, match="validation chunk width 6 not divisible by dp_devices 4"):
        check_dp_divisibility(4, 8, 6)
    with pytest.raises(ValueError, match="mc_itr=50 not divisible by mc shards=4"):
        check_sharded_eval(50, 8, 2, 4)
    with pytest.raises(ValueError, match=r"batch_size 50 not divisible by the data mesh axis \(3\)"):
        check_sharded_eval(50, 50, 3, 2)


@pytest.mark.parametrize("flags,message,on_gpus_only", [
    (dict(dp_devices=2), "requested a 2-device 'data' mesh but only 1 devices are available", True),
    (dict(eval_mesh=(2, 1)), r"requested a 2x1 \('data', 'mc'\) mesh but only 1 devices are available", True),
    (dict(restart_mode="shard", dp_devices=2), r"requested a 3x2 \('restart', 'data'\) mesh", True),
    (dict(restart_mode="shard", restart_devices=2), "n_restart 3 not divisible by restart_devices 2", False),
    (dict(restart_mode="vmap", dp_devices=2), "--restart_mode=vmap does not compose with --dp", False),
    (dict(dp_devices=4, batch_size=50), "batch_size 50 not divisible by dp_devices 4", False),
])
def test_cli_checks_refuse_before_any_rank_starts(monkeypatch, flags, message, on_gpus_only):
    """On a one-GPU machine (device_count patched to 1) a mesh of more than one rank raises JAX's mesh error;
    nothing ever puts two ranks on one card or moves to the CPU. On the CPU the same mesh is a world of gloo
    ranks, and with as many GPUs visible (patched) a world of as many GPU ranks; the other refusals hold on either
    device."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    args = dict(restart_mode="seq", n_restart=3, dp_devices=None, restart_devices=None, eval_mesh=None,
                batch_size=8, init_path=None, eval_only=False, device="cuda") | flags
    with pytest.raises(ValueError, match=message):
        common.check_parallel_flags(**args)
    if on_gpus_only:  # a mesh the GPUs hold is a world of GPU ranks, as the CPU's is of gloo ranks
        world = common.check_parallel_flags(**(args | dict(device="cpu")))
        assert world > 1
        monkeypatch.setattr(torch.cuda, "device_count", lambda: world)
        assert common.check_parallel_flags(**args) == world
    else:
        with pytest.raises(ValueError, match=message):
            common.check_parallel_flags(**(args | dict(device="cpu")))


@pytest.mark.parametrize("cli", [run_simulation, run_simulation_flow])
def test_cli_parses_the_parallel_flags(monkeypatch, cli):
    """`--dp`, `--restart_mode shard`, `--restart_devices` and `--eval_mesh DPxMC` reach `run` as JAX's do."""
    seen = {}
    monkeypatch.setattr(cli, "run", lambda *a, **kw: seen.update(kw))
    cli.main(["--device", "c", "--dp", "2", "--restart_mode", "shard", "--restart_devices", "3", "--eval_mesh",
              "4x2"])
    assert (seen["dp_devices"], seen["restart_mode"], seen["restart_devices"], seen["eval_mesh"]) == \
        (2, "shard", 3, (4, 2))
    cli.main(["--device", "c", "--dp", "1"])
    assert (seen["dp_devices"], seen["restart_devices"], seen["eval_mesh"]) == (None, None, None)


def test_a_failing_rank_fails_the_launch(capfd):
    """Rank 1 raises while rank 0 waits in a barrier: the launch raises a rank's exception at once (rank 1's own,
    or rank 0's, whose peer went away: whichever is found first) instead of hanging, and prints each rank's
    logged steps first."""
    t = time.monotonic()
    with pytest.raises(torch.multiprocessing.ProcessRaisedException):
        launch(_fail_on_rank_1, 2, device="cpu", timeout=120)
    assert time.monotonic() - t < 60
    err = capfd.readouterr().err
    assert "--- rank 0: " in err and "--- rank 1: " in err and "joined the world" in err


def _fail_on_rank_1():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    dist.barrier()


def test_a_world_past_its_timeout_shows_where_each_rank_is(capfd):
    """Rank 1 hangs in `_hang_on_rank_1` while rank 0 has returned: after the world's 9 s the launch has each rank
    still alive dump its threads' tracebacks (faulthandler, on a signal), prints each rank's logged steps and
    traceback, and raises TimeoutError, every rank ended."""
    t = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish within 9"):
        launch(_hang_on_rank_1, 2, device="cpu", timeout=9)
    assert time.monotonic() - t < 60
    err = capfd.readouterr().err
    rank0, rank1 = err[err.index("--- rank 0:"):err.index("--- rank 1:")], err[err.index("--- rank 1:"):]
    assert "joined the world" in rank0 and "returned" in rank0
    assert "joined the world" in rank1 and "returned" not in rank1
    assert "_hang_on_rank_1" in rank1 and "most recent call first" in rank1


def _hang_on_rank_1():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        time.sleep(600)


# --- the CLIs and the dryrun ---------------------------------------------------------------------------------------


def _csv(text):
    return [ln.split(",") for ln in text.strip().splitlines() if ln.split(",")[0] in CSV]


def _cli_kw(cohort_path, path, n_restart, **kw):
    optim = OptimConfig(shuffle=False, n_restart=n_restart, batch_size=8, niters=2, test_freq=2, early_stop=10)
    return dict(seed=1, elbo=True, eval_only=False, init_path=None, data_path=cohort_path, sample=40, data_config=DC,
                model_method="hybrid", path=path, optim_config=optim, eval_config=EvalConfig(t0=5), device="cpu") | kw


def _cli_runs(cohort_path, workdir):
    """On each rank of a world of 4, two runs of `run_simulation.run` (as the CLI runs them in the world it
    starts): restart_mode="shard", dp_devices=2 and eval_mesh=(2, 2) (a 2 x 2 restart x data training mesh,
    then a 2 x 2 evaluation mesh); then one restart with eval_mesh=(2, 2) alone (rank 0 trains, ranks 1-3
    wait); -> rank 0's scores and standard output of each."""
    import contextlib
    import io

    from hybridode_torch.parallel.launch import wait_idle

    out = {}
    for name, kw in (("shard", _cli_kw(cohort_path, os.path.join(workdir, "shard_"), 2, restart_mode="shard",
                                       dp_devices=2, eval_mesh=(2, 2))),
                     ("eval_mesh", _cli_kw(cohort_path, os.path.join(workdir, "mesh_"), 1, eval_mesh=(2, 2),
                                           events_path=os.path.join(workdir, "mesh.jsonl")))):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            out[name] = run_simulation.run(**kw)[2], text.getvalue()
        wait_idle("run")  # the ranks outside the evaluation mesh wait for those in it
    return out


@pytest.fixture(scope="module")
def cli_world(cohort_path, tmp_path_factory):
    """Rank 0's results of `_cli_runs` on 4 gloo ranks whose collectives time out after COLLECTIVE_TIMEOUT
    seconds, and its working directory."""
    workdir = str(tmp_path_factory.mktemp("cli"))
    return launch(_cli_runs, 4, cohort_path, workdir, device="cpu", timeout=300,
                  collective_timeout=COLLECTIVE_TIMEOUT), workdir


def test_run_simulation_shard_dp_and_eval_mesh_against_seq(cli_world, cohort_path, tmp_path, capfd):
    """`run_simulation.run` with restart_mode="shard", dp_devices=2 and eval_mesh=(2, 2) on 4 gloo ranks: its
    checkpoint is seq's, its metrics those of seq's run (rtol 1e-3: float32 sums in another order, as the port
    holds GPU against CPU)."""
    (got, got_out), workdir = cli_world[0]["shard"], cli_world[1]
    _, model, want = run_simulation.run(**_cli_kw(cohort_path, str(tmp_path / "seq_"), 2))
    want_out = capfd.readouterr().out
    _, seq_itr, seq_best = load_checkpoint(str(tmp_path / "seq_"), model.model_name, "cpu")
    _, itr, best = load_checkpoint(os.path.join(workdir, "shard_"), model.model_name, "cpu")
    assert itr == seq_itr and seq_itr > 0
    np.testing.assert_allclose(best, seq_best, rtol=BEST_RTOL)
    np.testing.assert_allclose([got[i] for i in (0, 2, 3, 5)], [want[i] for i in (0, 2, 3, 5)], rtol=1e-3)
    assert got_out.count("Iter ") == want_out.count("Iter ") == 2  # rank 0 prints every lane's row, once
    assert got_out.count("Training with 40 samples") == 1 and [r[0] for r in _csv(got_out)] == list(CSV)


def test_eval_mesh_csv_matches_the_unsharded_csv(cli_world, cohort_path, capfd):
    """A training run with a 2 x 2 evaluation mesh (rank 0 trains alone; ranks 1-3 wait, then read its checkpoint
    and take its generator) prints the point metrics of the unsharded `--eval y` run of its checkpoint (the CSV's
    second column; the third is a bootstrap SE, resampled afresh), as tests/test_cli.py holds JAX's. The
    training took longer than the world's collective timeout: the waiting ranks held no collective."""
    (_, out), workdir = cli_world[0]["eval_mesh"], cli_world[1]
    sharded = _csv(out)
    run_simulation.run(**_cli_kw(cohort_path, os.path.join(workdir, "mesh_"), 1, eval_only=True))
    single = _csv(capfd.readouterr().out)
    assert len(sharded) == 4 and [s[:2] for s in sharded] == [s[:2] for s in single]
    done = [r for r in map(json.loads, open(os.path.join(workdir, "mesh.jsonl"))) if r["event"] == "done"]
    assert done[0]["wall"] > COLLECTIVE_TIMEOUT


def test_run_simulation_flow_dp_and_eval_mesh(cohort_path, tmp_path, capfd):
    """The flow CLI's `run` with dp_devices=2 and eval_mesh=(1, 2) (2 gloo ranks) against one process: the same
    checkpoint name, its best loss rtol 1e-5, its metrics rtol 1e-3."""
    optim = OptimConfig(shuffle=False, n_restart=1, batch_size=8, niters=2, test_freq=2, early_stop=10)
    kw = dict(seed=1, eval_only=False, data_path=cohort_path, sample=40, data_config=DC, optim_config=optim,
              eval_config=EvalConfig(t0=5), mc_size=5, device="cpu")
    _, model, want = run_simulation_flow.run(path=str(tmp_path / "one_"), **kw)
    _, _, got = run_simulation_flow.run(path=str(tmp_path / "dp_"), dp_devices=2, eval_mesh=(1, 2), **kw)
    assert model.model_name == "VI_FLOW_PlanarLSTMEncoder_HybridDecoder.pkl"
    want_best = load_checkpoint(str(tmp_path / "one_"), model.model_name, "cpu")[2]
    np.testing.assert_allclose(load_checkpoint(str(tmp_path / "dp_"), model.model_name, "cpu")[2], want_best,
                               rtol=BEST_RTOL)
    np.testing.assert_allclose([got[i] for i in (0, 2, 3, 5)], [want[i] for i in (0, 2, 3, 5)], rtol=1e-3)
    assert capfd.readouterr().out.count("Training with 40 samples") == 2


def _sleep_on_rank_0_then_reduce():
    import torch.distributed as dist

    if dist.get_rank() == 0:
        time.sleep(3 * COLLECTIVE_TIMEOUT)
    dist.all_reduce(torch.ones(1))


def test_a_collective_held_past_the_collective_timeout_fails():
    """The control of the waiting ranks above: rank 1 waits for rank 0 three collective timeouts long in a
    collective, and times out, so the timeout a world is given is the one its collectives keep."""
    with pytest.raises(torch.multiprocessing.ProcessRaisedException, match="[Tt]imed out"):
        launch(_sleep_on_rank_0_then_reduce, 2, device="cpu", timeout=120, collective_timeout=COLLECTIVE_TIMEOUT)


def test_a_world_of_several_gpus_is_refused(monkeypatch):
    """The name is the one this test had while worlds of 2+ GPUs were refused (they hung after their first world);
    they run now (`launch.close_world` resets every CUDA graph first). With 4 GPUs visible (patched), `--dp 2`, a
    2 x 1 evaluation mesh and a 2 x 2 shard of the lockstep restarts are worlds of 2, 2 and 4 ranks; with 1, each
    raises JAX's mesh error before any rank starts. Without a GPU the dryrun's default device raises."""
    from hybridode_torch.parallel import dryrun

    args = dict(restart_mode="seq", n_restart=3, dp_devices=None, restart_devices=None, eval_mesh=None,
                batch_size=8, init_path=None, eval_only=False, device="cuda")
    cases = [(dict(dp_devices=2), 2, "requested a 2-device 'data' mesh but only 1 devices are available"),
             (dict(eval_mesh=(2, 1)), 2, r"requested a 2x1 \('data', 'mc'\) mesh but only 1 devices are available"),
             (dict(restart_mode="shard", n_restart=2, dp_devices=2), 4,
              r"requested a 2x2 \('restart', 'data'\) mesh but only 1 devices are available")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for flags, world, _ in cases:
        assert common.check_parallel_flags(**(args | flags)) == world
    assert common.check_parallel_flags(**args) == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for flags, _, message in cases:
        with pytest.raises(ValueError, match=message):
            common.check_parallel_flags(**(args | flags))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            dryrun.main(["2"])


def test_dryrun_on_four_ranks():
    """`python -m hybridode_torch.parallel.dryrun 4 --device c`: every OK line of JAX's dryrun (MULTICHIP_r05.json's
    tail)."""
    out = subprocess.run([sys.executable, "-m", "hybridode_torch.parallel.dryrun", "4", "--device", "c"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    for want in ("dryrun 2D mesh (2x2 data x mc) eval parity OK", "dryrun real-track DP step: loss=",
                 "dryrun flow DP step: loss=", "dryrun 2D mesh flow eval parity OK",
                 "dryrun fused-DP whole-restart parity: best=", "dryrun 2x2 restart-x-data batched experiment: best=",
                 "dryrun_multichip(4): loss="):
        assert any(ln.startswith(want) and ln.endswith("OK") for ln in lines), (want, out.stdout)
    assert lines[-1].startswith("dryrun_multichip(4): loss=")
