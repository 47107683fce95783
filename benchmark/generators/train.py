"""Training cells: one restart of the program's fused loop, driven for `--seconds` on its own window schedule.

Set-up builds the restart once: the program's cohort and model, the
weights drawn from the seed, and one call of `fused_training_loop` of one
step and one validation, which runs both eagerly once and captures them as
CUDA graphs (on a GPU). The run object that the loop keeps
(`inference.fused._LAST_RUN`) is then driven by the benchmark:

* its parameters go back to the seed's weights and its Adam state to zero;
* one validation runs through its own validation graph, then the first
  `compared_steps` iterations through its own step, fed the benchmark's
  batches and noise through its static buffers exactly as its windows feed
  them: the validation, the losses, the first gradients (read from Adam's
  first moment) and the parameters' change are what the reference is
  compared with;
* set-up ends in windows of the run's own `run()`, each `test_freq` steps
  and one validation ended by its one host read, on inputs drawn from the
  seed, until a window's time settles (the mix's `settle`);
* the measured window then calls `run()` window after window until
  `--seconds` have passed.

The loop has no public way to run a restart for a time or to resume one, so
the benchmark drives the run object; `PERF.md` lists that for a later change.
"""

from __future__ import annotations

import gc
import json
import math
import os
import time

import torch

from ..harness import compare, port, settle, weights
from ..reference import cohort as ref_cohort
from ..reference import model as ref

NEVER = 1 << 40  # an early-stop count no restart reaches
ADAM_BETA1 = 0.9


def _ring(mix: dict, n_train: int, run, gen, device):
    """The inputs of `ring` iterations (a multiple of test_freq): batch indices, the ELBO's noise, and each
    validation's noise, all drawn on the device from `gen`."""
    tf, B = mix["test_freq"], mix["batch_size"]
    size = tf * max(1, math.ceil(mix["ring"] / tf))
    per_epoch = n_train // B
    if mix["shuffle"]:  # every epoch a permutation of the fold, cut into batches
        perms = [torch.randperm(n_train, generator=gen, device=device)[:per_epoch * B].view(per_epoch, B)
                 for _ in range(math.ceil(size / per_epoch))]
        idx = torch.cat(perms)[:size]
    else:  # the fold's batches in order, iteration i taking batch i % (batches a fold), as the loop does
        order = torch.arange(1, size + 1, device=device) % per_epoch
        idx = (order[:, None] * B + torch.arange(B, device=device)).to(torch.int64)
    noise = tuple(None if s is None else torch.randn((size,) + tuple(s.shape), generator=gen, device=device)
                  for s in run.s_noise)
    windows = size // tf
    val_noise = tuple(None if s is None else torch.randn((windows,) + tuple(s.shape), generator=gen, device=device)
                      for s in run.s_val_noise)
    return size, idx, noise, val_noise


def _point(run, ring, window: int, first: int, count: int):
    """Make the run's buffers the ring's `window`-th slice of test_freq iterations, numbered first + 1 ..."""
    size, idx, noise, val_noise, itrs = ring
    w = window % (size // run.test_freq)
    lo = w * run.test_freq
    run.idx = idx[lo:lo + count]
    run.noise = tuple(None if n is None else n[lo:lo + count] for n in noise)
    run.val_noise = tuple(None if n is None else n[w:w + 1] for n in val_noise)
    run.itrs = itrs[first:first + count]
    run.niters = count


@torch.no_grad()
def _reset(run, params, w0, names):
    """The seed's weights and a fresh Adam and loop state, in the run's own tensors (the graphs read them)."""
    named = dict(params.named_parameters())
    for n in names:
        named[n].copy_(w0[n])
    for t in (*run.adam.m, *run.adam.v, run.adam.t, run.counter, run.loss, run.n_vals):
        t.zero_()
    for t in (run.best_run, run.best_od):
        t.fill_(1e9)
    for t in (run.alive, run.running):
        t.fill_(True)
    run.nf.fill_(False)


class _Timed:
    """A graph call with CUDA events around it (traced runs only): a replay cannot be profiled."""

    def __init__(self, fn, kind, log):
        self.fn, self.kind, self.log = fn, kind, log

    def __call__(self):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        self.fn()
        end.record()
        self.log.append((self.kind, start, end))


class Restart:
    """The program's restart, built once: its cohort, model and parameters, and the run object of one call of
    `fused_training_loop` (one step and one validation: eager once, then captured on a GPU)."""

    def __init__(self, spec, seed: int, device, root: str, work: str):
        from hybridode_torch.inference import fused

        cfg, mix = spec.config, spec.mix
        self.spec, self.device = spec, device
        self.events_path = os.path.join(work, "events.jsonl")
        if os.path.exists(self.events_path):
            os.remove(self.events_path)
        self.data = port.cohort(cfg, root, device)
        self.vi = port.model(cfg)
        self.params = port.params(self.vi, weights.make(cfg, seed, device), device)
        fused.fused_training_loop(niters=1, data_generator=self.data, model=self.vi, params=self.params,
                                  batch_size=mix["batch_size"], lr=mix["lr"], test_freq=1,
                                  generator=torch.Generator().manual_seed(seed), early_stop=NEVER,
                                  path=os.path.join(work, "ckpt_"), shuffle=mix["shuffle"],
                                  train_expert=mix["train_expert"], verbose=False, events_path=self.events_path,
                                  val_criterion=mix["val_criterion"], val_t0=mix["val_t0"])
        self.run = fused._LAST_RUN
        self.run.test_freq = mix["test_freq"]
        self.names = [n for n, p in self.params.named_parameters() if p.requires_grad]
        if set(self.names) != set(ref.trainable(cfg)):
            raise ValueError(f"the program trains {sorted(self.names)}, the configuration "
                             f"{sorted(ref.trainable(cfg))}")

    def start(self, seed: int):
        """The seed's weights in the run, a fresh Adam, the seed's ring of inputs, one validation through the run's
        own validation graph, and the compared steps through its own step and feed -> (the program's readings, the
        reference's inputs, the weights)."""
        mix, run, device = self.spec.mix, self.run, self.device
        w0 = weights.make(self.spec.config, seed, device)
        gen = torch.Generator(device=device).manual_seed(seed)
        size, idx, noise, val_noise = _ring(mix, self.data.train_size, run, gen, device)
        self.ring = (size, idx, noise, val_noise, torch.arange(1, 1 << 22, device=device))
        _reset(run, self.params, w0, self.names)
        run.s_w.zero_()
        run.validate()  # the validation at the seed's weights
        val = float(run.cval[..., 0])
        _reset(run, self.params, w0, self.names)
        steps = mix["compared_steps"]
        _point(run, self.ring, 0, 0, steps)
        losses, first_grads = [], None
        for i in range(steps):
            run._load_step(i)
            run.step()
            losses.append(float(run.loss))
            if i == 0:
                first_grads = {n: (m / (1 - ADAM_BETA1)).double().cpu() for n, m in zip(self.names, run.adam.m)}
        self.itr, self.position = steps, 0  # the ring's windows go on from its first slice, numbered from steps + 1
        program = dict(losses=losses, first_grads=first_grads, val=val,
                       params={n: p.detach().double().cpu() for n, p in self.params.named_parameters()})
        inputs = dict(idx=idx[:steps].cpu(), noise=[tuple(None if n is None else n[i].cpu() for n in noise)
                                                    for i in range(steps)])
        return program, inputs, w0

    def _next_window(self):
        """The run's own `run()` on the ring's next slice: test_freq steps and one validation, ended by the window's
        one host read."""
        tf = self.spec.mix["test_freq"]
        _point(self.run, self.ring, self.position, self.itr, tf)
        self.run.run()
        self.itr += tf
        self.position += 1

    def settle(self) -> list[float]:
        """Windows until a window's time settles (the mix's `settle`), the last part of set-up -> their seconds."""
        return settle.settle(self._next_window, self.spec.mix["settle"])

    def window(self, seconds: float, trace: bool) -> dict:
        """Whole windows of the run's own `run()` until `seconds` have passed -> the window's record."""
        cfg, mix, run, device = self.spec.config, self.spec.mix, self.run, self.device
        step_log = []
        if trace and device.type == "cuda":
            run.step, run.validate = _Timed(run.step, "step", step_log), _Timed(run.validate, "validation", step_log)
        tf, windows = mix["test_freq"], 0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_window = time.perf_counter()
        ends = []
        while True:
            self._next_window()
            windows += 1
            ends.append(time.perf_counter() - t_window)
            if ends[-1] >= seconds:
                break
        window_s = ends[-1]
        attempted = windows * tf
        failed = max(0, self.itr - int(run.last_itr) + 1) if bool(run.nf) else 0
        rec = dict(window_s=window_s, windows_s=[b - a for a, b in zip([0.0] + ends, ends)], attempted=attempted,
                   failed=min(failed, attempted), iterations=attempted,
                   validations=windows, patients=attempted * mix["batch_size"] + windows * cfg["cohort"]["val"],
                   memory_peak_bytes=torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
        rec["train_patients_per_s"] = rec["patients"] / window_s
        if trace:
            rec["replays"] = _replays(step_log)
            rec["captures"] = _captures(self.events_path)
            probe = getattr(port.family(cfg), "window_probe", None)
            if probe is not None:
                size, idx, noise = self.ring[:3]
                last = ((self.position - 1) % (size // tf)) * tf + tf - 1  # the ring position of the last step
                rec.update(probe(self.params, self.vi, self.data, idx[last], noise[0][last]))
        return rec

    def close(self):
        from hybridode_torch.inference import fused

        del self.run, self.params, self.data, self.ring
        fused.release_graphs()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run(spec, seed: int, seconds: float, trace: bool, device, root: str, work: str, t_process: float) -> dict:
    restart = Restart(spec, seed, device, root, work)
    program, inputs, w0 = restart.start(seed)
    settled = restart.settle()
    setup_s = time.time() - t_process
    rec = restart.window(seconds, trace)
    rec.update(setup_s=setup_s, settle_s=settled)
    restart.close()
    want = reference(spec.config, spec.mix, inputs, w0, root, device)
    rec["values"] = gaps(program, want, w0)
    rec["reference_trials"] = None if want["trials"] is None else float(want["trials"].double().mean())
    return rec


def reference(cfg, mix, inputs, w0, root, device, dtype=torch.float64, rows=None) -> dict:
    """The reference's steps from the same weights, batches and noise (`ref.train_steps`); `rows` keeps only the
    first rows of each batch (a fault: half of the batch left out)."""
    folds = ref_cohort.load(cfg, root)
    B = mix["batch_size"]

    def tensors(fold, sel):
        return {k: torch.as_tensor(v[:, sel], device=device, dtype=dtype) for k, v in folds[fold].items()}

    keep = slice(0, rows or B)
    batches = [tensors("train", inputs["idx"][i].numpy()[keep]) for i in range(len(inputs["idx"]))]
    noises = []
    for noise in inputs["noise"]:
        eps = [None if n is None else n.to(device=device, dtype=dtype) for n in noise]
        noises.append(tuple(None if n is None else (n[keep] if j == 0 else n[:, keep]) for j, n in enumerate(eps)))
    val_n = cfg["cohort"]["val"]
    width = min(B, val_n)
    val_chunks = [tensors("val", slice(c * B, c * B + width)) for c in range(max(1, val_n // B))]
    return ref.train_steps(cfg, mix, {n: t.to(dtype) for n, t in w0.items()}, batches, noises, val_chunks)


def gaps(program: dict, want: dict, w0: dict) -> dict:
    """The compared numbers, each the program's against the reference's: the worst step's loss and the first step's
    (which no Adam step has moved yet), the worst leaf's first gradient and change over the compared steps, and the
    validation at the seed's weights."""
    want_grads = {n: g.double().cpu() for n, g in want["first_grads"].items()}
    moved = compare.moved_leaves(want_grads)
    start = {n: t.double().cpu() for n, t in w0.items()}
    got_change = {n: program["params"][n].double().cpu() - start[n] for n in moved}
    want_change = {n: want["params"][n].double().cpu() - start[n] for n in moved}
    return {
        "loss": max(compare.rel_gap(g, w) for g, w in zip(program["losses"], want["losses"])),
        "loss1": compare.rel_gap(program["losses"][0], want["losses"][0]),
        "grad": compare.worst_leaf_gap(program["first_grads"], want_grads, list(want_grads)),
        "change": compare.worst_leaf_gap(got_change, want_change, moved),
        "val": compare.rel_gap(program["val"], want["val"]),
    }


def _replays(log) -> dict:
    """Each graph call's device milliseconds, by kind, and the idle gaps between consecutive calls."""
    if not log:
        return {}
    log[-1][2].synchronize()
    out = {"step": [], "validation": [], "gaps": []}
    for i, (kind, start, end) in enumerate(log):
        out[kind].append(start.elapsed_time(end))
        if i + 1 < len(log):
            out["gaps"].append((f"after {kind} replay", end.elapsed_time(log[i + 1][1])))
    return out


def _captures(events_path: str) -> list:
    if not os.path.exists(events_path):
        return []
    with open(events_path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    return [(r["graph"], r["seconds"]) for r in records if r.get("event") == "capture"]


def as_program(want: dict) -> dict:
    return dict(losses=want["losses"], first_grads=want["first_grads"], val=want["val"], params=want["params"])


def calibrate(spec, seeds, n_control, device, root, work, seconds) -> dict:
    """The readings of `benchmark/calibrate.py` (its docstring): the program, the witness, the TF32 control and
    half of each batch left out, a seed each."""
    cfg, mix = spec.config, spec.mix
    out = {"program": [], "control": [], "half_batch": [], "witness": []}
    restart = Restart(spec, seeds[0], device, root, work)
    for i, seed in enumerate(seeds):
        t = time.time()
        program, inputs, w0 = restart.start(seed)
        want = reference(cfg, mix, inputs, w0, root, device)
        out["program"].append(dict(seed=seed, **gaps(program, want, w0), seconds=time.time() - t))
        plain = reference(cfg, mix, inputs, w0, root, device, dtype=torch.float32)
        out["witness"].append(dict(seed=seed, **gaps(as_program(plain), want, w0)))
        if i < n_control:
            with compare.tf32():
                low = reference(cfg, mix, inputs, w0, root, device, dtype=torch.float32)
            out["control"].append(dict(seed=seed, **gaps(as_program(low), want, w0)))
            half = reference(cfg, mix, inputs, w0, root, device, rows=mix["batch_size"] // 2)
            out["half_batch"].append(dict(seed=seed, **gaps(as_program(half), want, w0)))
        print(json.dumps({k: v[-1] for k, v in out.items() if v and v[-1]["seed"] == seed}), flush=True)
    return out
