"""Whole-restart training with the loop's state on the device (counterpart of hybridode/inference/fused.py).

The JAX package runs a restart as one XLA program, a `lax.while_loop` over
validation windows. Here a restart is a `_Run` whose every piece of the host
loop's state (`inference/train.py`) lives in device tensors. The host reads
one flag per validation window, whether any restart still runs: the
counterpart of the while_loop's predicate. Nothing is read inside a window.

* Batch indices are pre-drawn with the host loop's numpy stream
  (`_predraw_train_idx`, the parity contract) and gathered on the device;
  the validation chunks are fixed (`_predraw_val_idx`).
* The ELBO's noise, and with `val_criterion="elbo"` each validation chunk's,
  is pre-drawn from the caller's CPU generator call by call, in the host
  loop's order and shapes (`_predraw_noise`), and kept in device buffers. One
  large draw would give other numbers: the CPU `randn` fills blocks of 16
  with another algorithm.
* Validation totals (in float64, as the host loop sums them), the early-stop
  counter, the best parameters against the incoming `best_on_disk`, the
  alive flags and the curve rows are device tensors, updated by
  `torch.where`.
* The step that sees a non-finite loss still applies its update; every later
  step is masked out, parameters and Adam's moments alike (JAX's
  fused.py:205-226, and the host loop, which breaks after the update).
* Windows as in JAX: `niters // test_freq` windows of `test_freq` steps and
  one validation, then the trailing `niters % test_freq` steps, which move
  the final parameters but never the best.
* The logging contract (the `Iter` lines, the CSV curve, the `val` and `done`
  events) is replayed from the buffers at the end. Each call is a `restart`
  span (`utils/logging.py`), the root of every span of its run: a `window`
  span a window, ended by its read, with the trial steps its graphs' DOPRI5
  solves counted (below), a `tail` span, and each graph's `warmup` and
  `capture`. The window spans of a run driven after its call returned are
  recorded too, under its restart. The checkpoint is written once,
  at the end, if validation beat `best_on_disk`, and every `flush_every`-th
  window by `_FlushSink` (env HYBRIDODE_FLUSH_EVERY), which acts at the
  window's read and changes no device math.
* The caller's generator is left where the host loop leaves it.

On CUDA (`captures`) the training step and the validation are each captured
into a CUDA graph right after one eager warm-up call on a side stream,
PyTorch's whole-network recipe (`_Graphed`), and replayed from then on, so
every window after the first is all replays. The iteration's batch indices
and noise reach the graph through static buffers filled by device-to-device
copies, and Adam (`_Adam`) keeps its step count on the device. A captured
decode reads nothing: the per-patient DOPRI5 runs its whole trial budget
(`dopri5.full_budget`), which gives the early-exit result, and adds its live
and run trial steps to its graph's tally on the device, which the window's
one read brings back with the flag (not under `torch.func.vmap`, where
nothing is counted). The lockstep adjoint solver reads the host
inside its solve, so its restarts run this loop uncaptured. A capture that
fails raises; nothing falls back to eager code or to the host loop.

`fused_experiment_loop` runs all restarts as one program (`--restart_mode
vmap`): their parameters stacked along a leading lane axis
(`torch.func.stack_module_state`), gradients by
`torch.func.vmap(torch.func.grad_and_value(...))` over `functional_call` of
the loss, and one Adam over the stacked leaves, which is R independent Adams
since Adam is elementwise. Adam's step count is shared; a lane that stopped
never steps again, so its own count is never read. On the lockstep adjoint
solver (`--step_control lockstep`) the lanes' losses come out of the vmap and
the gradient of their sum is taken outside it, each lane's own since the
lanes are independent: the solver's `vmap` rule solves the lanes one after
the other, each as its own plain solve outside the vmap, where it may read
the host (`solvers/adjoint.py`).

`_Run` is the counterpart of JAX's windowed runner `_make_run`, shared by
both loops as JAX shares it between jit and vmap.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import os
import time
import weakref

import numpy as np
import torch

from ..solvers import dopri5
from ..utils.logging import CSVCurveLogger, JSONLLogger, Span
from . import checkpoint as ckpt
from .elbo import VIModel, draw_loss_noise, init_vi, loss_fn
from .train import check_dp_divisibility, reload_best, unfreeze_expert

_LAST_FLUSH_SINK = None  # the last restart's sink, kept for tests and observability
_LAST_RUN = None  # the last `_Run`, kept for measurement: its graphs can be replayed and traced
_GRAPHED = weakref.WeakSet()  # every `_Graphed` alive in the process, for `release_graphs`


def release_graphs() -> None:
    """Reset every CUDA graph the fused loops captured in this process, whoever still holds it.

    A graph that captured an NCCL collective keeps its communicator from
    being destroyed, so a world frees them all before it ends
    (`parallel.launch.close_world`). A `_Graphed` whose graph was reset
    captures anew at its next call.
    """
    global _LAST_RUN
    _LAST_RUN = None
    for g in list(_GRAPHED):
        g.release()
    gc.collect()


class _FlushSink:
    """Writes the best-so-far checkpoint at every `every`-th window's read when it beats what is on disk."""

    def __init__(self, path, model_name, every, incoming_best):
        self.path = path
        self.model_name = model_name
        self.every = max(1, int(every))
        self.written_od = float(incoming_best)
        self.calls = 0
        self.writes = 0

    def __call__(self, run: "_Run"):
        self.calls += 1
        if self.calls % self.every or not bool(run.improved):
            return
        od = float(run.best_od)
        if od >= self.written_od:
            return
        ckpt.save_checkpoint(self.path, self.model_name, run.best_params(), int(run.best_itr), od)
        self.written_od = od
        self.writes += 1


def _fold_geometry(data_generator, batch_size, train_fold):
    """Fold tensors and chunk counts shared by both fused loops."""
    fold = data_generator._fold(train_fold)
    fold_n = fold["measurements"].shape[1]
    fold_size = data_generator.train_size if train_fold == "train" else data_generator.val_size
    train_chunk = max(1, fold_size // batch_size)
    val_chunks = max(1, data_generator.val_size // batch_size)
    val_n = data_generator._fold("val")["measurements"].shape[1]
    return fold, fold_n, train_chunk, val_chunks, val_n


def _predraw_train_idx(rng, fold_n, train_chunk, niters, batch_size, shuffle):
    """The host loop's batch-index stream, pre-drawn (identical draws): the parity contract between the host,
    fused and batched loops."""
    if shuffle:
        return np.stack([rng.choice(fold_n, batch_size, replace=False) for _ in range(niters)]).astype(np.int64)
    row = min(batch_size, fold_n)
    chunks = np.stack([np.arange(c * batch_size, c * batch_size + row) for c in range(train_chunk)])
    return chunks[(np.arange(1, niters + 1)) % train_chunk].astype(np.int64)


def _predraw_val_idx(val_n, batch_size, val_chunks):
    vrow = min(batch_size, val_n)
    return np.stack([np.arange(c * batch_size, c * batch_size + vrow) for c in range(val_chunks)]).astype(np.int64)


def _predraw_noise(model: VIModel, generator, niters, test_freq, width, val_chunks, val_width, val_criterion):
    """The host loop's draws from `generator`, call by call in its order and shapes.

    -> (eps, eps_kl) over iterations, (eps, eps_kl) over windows then chunks
    (each None where nothing is drawn), and the generator's states after each
    iteration's training draws and after all its draws.
    """
    train, val, after_train, after_all = [], [], [], []
    state = generator.get_state()
    for itr in range(1, niters + 1):
        train.append(draw_loss_noise(model, width, generator, "cpu"))
        state = generator.get_state() if train[-1][0] is not None else state
        after_train.append(state)
        if itr % test_freq == 0 and val_criterion == "elbo":
            val.append([draw_loss_noise(model, val_width, generator, "cpu") for _ in range(val_chunks)])
            state = generator.get_state() if val[-1][0][0] is not None else state
        after_all.append(state)

    def stack(parts):
        return None if not parts or parts[0] is None else torch.stack(parts)

    noise = tuple(stack([d[i] for d in train]) for i in range(2))
    val_noise = tuple(stack([stack([c[i] for c in win]) for win in val]) for i in range(2))
    return noise, val_noise, after_train, after_all


def _restore_generator(generator, after_train, after_all, last_itr: int, died: bool):
    """Leave `generator` where the host loop leaves it: after the last iteration that ran (only its
    training draws if its loss was non-finite)."""
    if last_itr:
        generator.set_state((after_train if died else after_all)[last_itr - 1])


def captures(model: VIModel, device) -> bool:
    """Whether the fused loop runs its step and validation as CUDA graphs: on CUDA, for every decoder that
    reads nothing on the host inside a decode (all but the lockstep adjoint's)."""
    return torch.device(device).type == "cuda" and not getattr(model.decoder_spec, "use_adjoint", False)


class _Graphed:
    """`fn()` run eagerly once on a side stream, captured on that stream into a CUDA graph, then replayed.

    The eager call is a real call of the run: it warms the allocator, the
    library handles and the graph's inputs before the capture, as PyTorch's
    whole-network capture recipe does. The capture follows it at once, so
    that every later call is a replay. The graph reads its inputs from static
    buffers that the caller fills before each call. A capture that fails
    raises. Both run under `dopri5.full_budget(self.tally)`: the warm-up and
    every replay add the trial steps of their DOPRI5 solves to `tally`.
    """

    def __init__(self, fn, name: str, events: JSONLLogger):
        self.fn, self.name, self.events = fn, name, events
        self.stream = torch.cuda.Stream()  # the warm-up's and the capture's
        self.tally = torch.zeros(2, dtype=torch.int64, device="cuda")  # [live, run] trial steps
        self.graph = None
        _GRAPHED.add(self)

    def release(self):
        if self.graph is not None:
            self.graph.reset()
            self.graph = None

    def __call__(self):
        if self.graph is not None:
            self.graph.replay()
            return
        self.stream.wait_stream(torch.cuda.current_stream())
        with self.events.span("warmup", graph=self.name), torch.cuda.stream(self.stream), \
                dopri5.full_budget(self.tally):
            self.fn()
        torch.cuda.current_stream().wait_stream(self.stream)
        self._capture()

    def _capture(self):
        # A graph that Python's cycle collector destroys during another capture ends that capture (its reset
        # is a CUDA call a capturing stream does not allow): dead graphs go now, and none goes during it.
        gc.collect()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with self.events.span("capture", graph=self.name), torch.cuda.graph(graph, stream=self.stream), \
                    dopri5.full_budget(self.tally):
                self.fn()
        except Exception as e:
            raise RuntimeError(f"capturing the fused loop's {self.name} into a CUDA graph failed: {e}") from e
        finally:
            if collecting:
                gc.enable()
        self.graph = graph


class _Adam:
    """Adam on device tensors with a flag per lane: lanes that are not alive keep their parameters and moments.

    torch.optim.Adam's arithmetic (lr, betas 0.9 and 0.999, eps 1e-8, the
    order of its single-tensor update), with its bias corrections in float64
    as torch.optim.Adam forms them on the host, here from a float64 step
    count on the device, so that a CUDA graph holds the whole update. Its
    `capturable=True` forms them in float32 instead (1 - float32(0.999) is
    1.3e-5 off), which moved the first validation of a 10-iteration window on
    an H100 by 2e-3 against the CPU, where the host loop moved 2.4e-5.
    """

    def __init__(self, leaves, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.leaves, self.lr, self.betas, self.eps = leaves, lr, betas, eps
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.t = torch.zeros((), dtype=torch.float64, device=leaves[0].device)

    @torch.no_grad()
    def step(self, grads, keep):
        """One update from `grads`; `keep(t)` is the alive flag shaped to broadcast against `t`."""
        beta1, beta2 = self.betas
        self.t.add_(1)
        step_size = self.lr / (1 - beta1**self.t)
        bias_correction2_sqrt = (1 - beta2**self.t).sqrt()
        for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
            if g is None:
                continue
            alive = keep(p)
            m_new = m.lerp(g, 1 - beta1)
            v_new = (v * beta2).addcmul_(g, g, value=1 - beta2)
            denom = (v_new.sqrt() / bias_correction2_sqrt).add_(self.eps)
            p.copy_(torch.where(alive, p + -step_size * m_new / denom, p))
            m.copy_(torch.where(alive, m_new, m))
            v.copy_(torch.where(alive, v_new, v))


class _Run:
    """One restart, or R of them along a leading lane axis, with every piece of loop state on the device.

    `grad_fn(batch, eps, eps_kl) -> (loss of shape lanes, grads of leaves)`;
    `eval_fn(vbatch, eps, eps_kl) -> terms of shape lanes + (k,)`: the loss
    (k = 1), or with `forecast` the masked squared-error sum and mask count
    (k = 2); `gather(idx)` the training batch of indices `idx`. `idx`
    (niters, *lanes, B) and the noise (leading axis: iteration, or window then
    chunk) live on the device. `mean`, under data parallelism, a `_DataMean`:
    `grad_fn` already averages; a validation sums its chunks' terms over the
    data axis in one all-reduce and divides once (the ELBO by the axis size,
    the forecast's error sum by its mask count). `restart`: the span of the loop's call, the parent of every
    window span, also of windows run after the call returned.
    """

    def __init__(self, *, leaves, lr, grad_fn, eval_fn, gather, lanes, val_batches, idx, noise, val_noise,
                 niters, test_freq, early_stop, best_on_disk, capture, events, to_params, forecast, restart: Span,
                 mean=None):
        device = leaves[0].device
        self.leaves, self.adam, self.gather = leaves, _Adam(leaves, lr), gather
        self.grad_fn, self.eval_fn = grad_fn, eval_fn
        self.lanes, self.val_batches, self.early_stop = tuple(lanes), val_batches, early_stop
        self.niters, self.test_freq, self.to_params, self.events = niters, test_freq, to_params, events
        self.restart = restart
        self.forecast, self.mean = forecast, mean
        self.idx, self.noise, self.val_noise = idx, noise, val_noise
        self.itrs = torch.arange(1, niters + 1, device=device)
        cap = max(1, niters // test_freq)
        self.windows = torch.arange(cap, device=device)

        def full(dtype, value):
            return torch.full(self.lanes, value, dtype=dtype, device=device)

        self.running = full(torch.bool, True)  # lanes that run the current window
        self.alive = full(torch.bool, True)  # ... and have seen no non-finite loss in it
        self.loss = full(torch.float32, 0.0)  # the last step's loss while alive
        self.last_itr = full(torch.int64, 0)
        self.best_run = full(torch.float64, 1e9)
        self.counter = full(torch.int64, 0)
        self.best_od = full(torch.float64, float(best_on_disk))
        self.best_itr = full(torch.int64, 0)
        self.improved = full(torch.bool, False)
        self.n_vals = full(torch.int64, 0)
        self.nf = full(torch.bool, False)
        self.cit = torch.zeros(self.lanes + (cap,), dtype=torch.int64, device=device)
        self.cval = torch.zeros(self.lanes + (cap,), dtype=torch.float64, device=device)
        self.ctr = torch.zeros(self.lanes + (cap,), dtype=torch.float32, device=device)
        self.best = [p.detach().clone() for p in leaves]
        # Static inputs of a step and of a validation, filled before each call.
        self.s_idx = idx[0].clone()
        self.s_noise = tuple(None if n is None else n[0].clone() for n in noise)
        self.s_val_noise = tuple(None if n is None else n[0].clone() for n in val_noise)
        self.s_itr = torch.zeros((), dtype=torch.int64, device=device)
        self.s_w = torch.zeros((), dtype=torch.int64, device=device)
        if capture:
            self.step = _Graphed(self._step, "step", events)
            self.validate = _Graphed(self._validate, "validation", events)
            # The graphs' trial-step tallies, named as a window span's fields, and their values at the last read.
            self.tallies = {"step": self.step.tally, "val": self.validate.tally}
        else:
            self.step, self.validate = self._step, self._validate
            self.tallies = {}
        self.tallied = [0] * (2 * len(self.tallies))

    def _mask(self, flag, t):
        return flag.reshape(flag.shape + (1,) * (t.ndim - flag.ndim))

    def _step(self):
        loss, grads = self.grad_fn(self.gather(self.s_idx), *self.s_noise)
        with torch.no_grad():
            alive = self.alive
            self.adam.step(grads, lambda t: self._mask(alive, t))
            self.loss.copy_(torch.where(alive, loss, self.loss))
            self.last_itr.copy_(torch.where(alive, self.s_itr, self.last_itr))
            alive.logical_and_(torch.isfinite(loss))

    @torch.no_grad()
    def _validate(self):
        terms = torch.stack([self.eval_fn(vbatch, *(None if n is None else n[c] for n in self.s_val_noise))
                             for c, vbatch in enumerate(self.val_batches)])  # (chunks, *lanes, k)
        n = 1
        if self.mean is not None:
            terms, n = self.mean.terms(terms), self.mean.n
        total = torch.zeros(self.lanes, dtype=torch.float64, device=self.alive.device)
        for t in terms:
            cl = t[..., 0] / torch.clamp(t[..., 1], min=1.0) if self.forecast else t[..., 0] / n
            cl = cl.to(torch.float64)
            total = total + torch.where(torch.isfinite(cl), cl, 1e9)
        alive = self.alive
        better_run = alive & (total < self.best_run)
        self.best_run.copy_(torch.where(better_run, total, self.best_run))
        self.counter.copy_(torch.where(alive, torch.where(better_run, 0, self.counter + 1), self.counter))
        better_od = alive & (total < self.best_od)
        self.best_od.copy_(torch.where(better_od, total, self.best_od))
        for b, p in zip(self.best, self.leaves):
            b.copy_(torch.where(self._mask(better_od, p), p, b))
        self.best_itr.copy_(torch.where(better_od, self.s_itr, self.best_itr))
        self.improved.logical_or_(better_od)
        put = (self.windows == self.s_w) & alive[..., None]
        self.cit.copy_(torch.where(put, self.s_itr, self.cit))
        self.cval.copy_(torch.where(put, total[..., None], self.cval))
        self.ctr.copy_(torch.where(put, self.loss[..., None], self.ctr))
        self.n_vals.add_(alive.to(torch.int64))
        self._settle()

    def _settle(self):
        """A lane that ran and lost `alive` stopped on a non-finite loss; the lanes that run on are those
        neither early-stopped nor dead."""
        self.nf.logical_or_(self.running & ~self.alive)
        self.running.copy_((self.counter < self.early_stop) & ~self.nf)
        self.alive.copy_(self.running)

    def _load_step(self, i):
        self.s_idx.copy_(self.idx[i])
        self.s_itr.copy_(self.itrs[i])
        for s, n in zip(self.s_noise, self.noise):
            if s is not None:
                s.copy_(n[i])

    def _read(self) -> tuple[bool, dict]:
        """The window's one read: whether any lane runs on, and each graph's trial steps since the last read
        (`<graph>_trials_live`, `<graph>_trials_run`), in one copy to the host."""
        read = torch.cat([self.running.any().reshape(1).to(torch.int64), *self.tallies.values()]).tolist()
        counts, self.tallied = [a - b for a, b in zip(read[1:], self.tallied)], read[1:]
        names = [f"{g}_trials_{k}" for g in self.tallies for k in ("live", "run")]
        return bool(read[0]), dict(zip(names, counts))

    def run(self, sink=None):
        """The windows, each ended by its one read, then the trailing steps."""
        n_windows, tf = self.niters // self.test_freq, self.test_freq
        for w in range(n_windows):
            with self.events.span("window", self.restart, window=w + 1, itr=(w + 1) * tf) as window:
                for i in range(w * tf, (w + 1) * tf):
                    self._load_step(i)
                    self.step()
                self.s_w.copy_(self.windows[w])
                for s, n in zip(self.s_val_noise, self.val_noise):
                    if s is not None:
                        s.copy_(n[w])
                self.validate()
                running, counts = self._read()
                window.fields.update(counts)
            if sink is not None:
                sink(self)
            if not running:
                return
        if n_windows * tf < self.niters:
            with self.events.span("tail", self.restart, itr=self.niters):
                for i in range(n_windows * tf, self.niters):
                    self._load_step(i)
                    self.step()
                with torch.no_grad():
                    self.nf.logical_or_(self.running & ~self.alive)

    def best_params(self, lane=None):
        return self.to_params(self.best, lane)

    def packed(self) -> torch.Tensor:
        """The buffers the end of a run reads, as one float64 tensor of shape lanes + (6 + 3 cap,) (every value
        exact in float64), which one collective can gather across lanes."""
        return torch.cat([getattr(self, k).to(torch.float64)[..., None] for k in _SCALARS]
                         + [getattr(self, k).to(torch.float64) for k in _CURVES], dim=-1)

    def host(self) -> dict:
        """The buffers, read once at the end."""
        return _unpack(self.packed().cpu())


_SCALARS = {"best_od": torch.float64, "best_itr": torch.int64, "improved": torch.bool, "n_vals": torch.int64,
            "nf": torch.bool, "last_itr": torch.int64}
_CURVES = {"cit": torch.int64, "cval": torch.float64, "ctr": torch.float32}


def _unpack(packed: torch.Tensor) -> dict:
    """`_Run.packed`'s tensor (on the CPU) -> the buffers as numpy arrays in their own dtypes."""
    cap = (packed.shape[-1] - len(_SCALARS)) // len(_CURVES)
    out = {k: packed[..., i].to(dtype).numpy() for i, (k, dtype) in enumerate(_SCALARS.items())}
    for j, (k, dtype) in enumerate(_CURVES.items()):
        lo = len(_SCALARS) + j * cap
        out[k] = packed[..., lo:lo + cap].to(dtype).numpy()
    return out


class _DataMean:
    """Means over the data axis of a mesh: a step's loss and gradients through one `FlatMean` (one all-reduce,
    made at the first step), a validation's chunk terms through one all-reduce of their sums."""

    def __init__(self, mesh):
        from ..parallel.mesh import axis

        self.group, _, self.n = axis(mesh, "data")
        self.flat = None

    def step(self, loss, grads):
        from ..parallel.mesh import FlatMean

        if self.flat is None:
            self.flat = FlatMean([loss] + list(grads), self.group, self.n)
        out = self.flat([loss] + list(grads))
        return out[0], out[1:]

    def terms(self, t):
        from ..parallel.mesh import all_reduce_sum

        return all_reduce_sum(t, self.group)


def _data_block(mesh, idx, val_idx, noise, val_noise):
    """This rank's columns of the index streams and rows of the noise, on the data axis of `mesh`."""
    from ..parallel.mesh import axis, shard_noise

    _, i, n = axis(mesh, "data")
    check_dp_divisibility(n, idx.shape[-1], val_idx.shape[-1])
    b, vb = idx.shape[-1] // n, val_idx.shape[-1] // n
    return (np.ascontiguousarray(idx[..., i * b:(i + 1) * b]), np.ascontiguousarray(val_idx[..., i * vb:(i + 1) * vb]),
            shard_noise(noise, mesh), shard_noise(val_noise, mesh))


def _replay_logs(out, curve, events, verbose, restart=None):
    for i in range(int(out["n_vals"])):
        it, tv, tr = int(out["cit"][i]), float(out["cval"][i]), float(out["ctr"][i])
        if verbose:
            print("Iter {:04d} | Total Loss {:.6f} | Train Loss {:.6f}".format(it, tv, tr))
        if curve is not None:
            curve.log(it, tv, tr)
        events.log("val", itr=it, val_loss=tv, train_loss=tr, **({} if restart is None else dict(restart=restart)))
    if bool(out["nf"]) and verbose:
        print("non-finite training loss; stopping this restart")


def _val_batches(data_generator, val_idx, device):
    val = data_generator._fold("val")
    return [{k: v.index_select(1, torch.as_tensor(idx, device=device)) for k, v in val.items()} for idx in val_idx]


def _flush_every(flush_every) -> int:
    if flush_every is None:
        flush_every = int(os.environ.get("HYBRIDODE_FLUSH_EVERY", "0"))
    return int(flush_every or 0)


def fused_training_loop(
    niters, data_generator, model: VIModel, params, batch_size, lr, test_freq, generator,
    best_on_disk=1e9, early_stop=5, path="model/", shuffle=True, train_fold="train", train_expert=False,
    verbose=True, curve_path=None, events_path=None, val_criterion="elbo", val_t0=5, flush_every=None, mesh=None,
):
    """Drop-in replacement for the host loop of `variational_training_loop`; -> (params, best_on_disk, wall).

    `params` trains in place. Checkpoint-to-disk happens once, at the end, if
    validation beat `best_on_disk`: a process killed mid-restart loses that
    restart's best, unless `flush_every=K` (env HYBRIDODE_FLUSH_EVERY=K)
    writes it at every K-th window's read when it improves on what is on
    disk; that costs a read of the best loss per K windows and changes no
    device math.

    With a 1-D "data" `mesh` (JAX's DP branch, fused.py:142-175, 311-347)
    each rank gathers its columns of the batch-index streams and takes its
    rows of the pre-drawn global noise; a step averages the loss and the
    gradients over the mesh in one all-reduce (captured into the step's
    graph on CUDA), a validation its chunks' terms in another. Every rank
    takes the same decisions; rank 0 alone writes and logs.
    """
    global _LAST_FLUSH_SINK, _LAST_RUN
    from ..parallel.launch import is_writer
    from ..parallel.mesh import forecast_terms

    writer = is_writer()
    verbose = verbose and writer
    device = next(params.parameters()).device
    capture = captures(model, device)
    if train_expert:
        unfreeze_expert(params)
    leaves = [p for p in params.parameters() if p.requires_grad]
    fold, fold_n, train_chunk, val_chunks, val_n = _fold_geometry(data_generator, batch_size, train_fold)

    curve, events = CSVCurveLogger(curve_path if writer else None), JSONLLogger(events_path if writer else None)
    try:
        with events.span("restart", None) as restart:
            rng = np.random.RandomState(int(torch.randint(0, 2**31 - 1, (), generator=generator)))
            start = time.time()
            idx = _predraw_train_idx(rng, fold_n, train_chunk, niters, batch_size, shuffle)
            val_idx = _predraw_val_idx(val_n, batch_size, val_chunks)
            noise, val_noise, after_train, after_all = _predraw_noise(
                model, generator, niters, test_freq, idx.shape[-1], val_chunks, val_idx.shape[-1], val_criterion)
            mean = None
            if mesh is not None:
                idx, val_idx, noise, val_noise = _data_block(mesh, idx, val_idx, noise, val_noise)
                mean = _DataMean(mesh)

            def grad_fn(batch, eps, eps_kl):
                loss = loss_fn(params, model, batch, eps=eps, eps_kl=eps_kl)
                out = loss.detach(), torch.autograd.grad(loss, leaves, allow_unused=True)
                return out if mean is None else mean.step(*out)

            def eval_fn(vbatch, eps, eps_kl):
                if val_criterion == "forecast":
                    return forecast_terms(params, model, vbatch, val_t0, mesh)
                return loss_fn(params, model, vbatch, eps=eps, eps_kl=eps_kl).reshape(1)

            def to_params(best, lane=None):
                out = copy.deepcopy(params)
                with torch.no_grad():
                    for p, b in zip([p for p in out.parameters() if p.requires_grad], best):
                        p.copy_(b)
                return out

            def to_device(n):
                return None if n is None else n.to(device)

            run = _Run(leaves=leaves, lr=lr, grad_fn=grad_fn, eval_fn=eval_fn,
                       gather=lambda i: {k: v.index_select(1, i) for k, v in fold.items()}, lanes=(),
                       val_batches=_val_batches(data_generator, val_idx, device),
                       idx=torch.as_tensor(idx, device=device), noise=tuple(map(to_device, noise)),
                       val_noise=tuple(map(to_device, val_noise)), niters=niters, test_freq=test_freq,
                       early_stop=early_stop, best_on_disk=best_on_disk, capture=capture, events=events,
                       to_params=to_params, forecast=val_criterion == "forecast", restart=restart, mean=mean)
            every = _flush_every(flush_every)
            sink = _FlushSink(path, model.model_name, every, best_on_disk) if every > 0 and writer else None
            _LAST_FLUSH_SINK, _LAST_RUN = sink, run
            run.run(sink)
            out = run.host()
            wall = time.time() - start
            _restore_generator(generator, after_train, after_all, int(out["last_itr"]), bool(out["nf"]))

            _replay_logs(out, curve, events, verbose)
            if bool(out["improved"]):
                best_on_disk = float(out["best_od"])
                if writer:
                    ckpt.save_checkpoint(path, model.model_name, run.best_params(), int(out["best_itr"]), best_on_disk)
            events.log("done", wall=wall, best_on_disk=float(best_on_disk), captured=capture)
    finally:
        curve.close()
        events.close()

    best_params, best_on_disk = reload_best(path, model.model_name, params, best_on_disk, device, mesh)
    if verbose:
        print("Time: {}".format(wall))
        print("Overall best loss: {:.6f}".format(best_on_disk))
    return best_params, best_on_disk, wall


class _Functional(torch.nn.Module):
    """`fn(tree, *args)` as a module's forward, so that `torch.func.functional_call` can swap the tree's leaves."""

    def __init__(self, tree, fn):
        super().__init__()
        self.tree, self.fn = tree, fn

    def forward(self, *args):
        return self.fn(self.tree, *args)


def fused_experiment_loop(
    niters, data_generator, model: VIModel, restart_generators, batch_size, lr, test_freq, best_on_disk=1e9,
    early_stop=5, path="model/", shuffle=True, train_fold="train", train_expert=False, verbose=True,
    curve_path=None, events_path=None, val_criterion="elbo", val_t0=5, device=None, restart_devices=None,
    dp_devices=None, mesh=None,
):
    """Run every restart at once as one batched program (`--restart_mode vmap`); -> (params, best_on_disk, wall).

    `restart_generators`: one `(init, train)` pair of CPU generators per
    restart, drawn as the sequential CLI loop draws them
    (`cli/common.py:restart_generators`), so each lane starts from the
    weights and sees the batches and noise of its sequential restart. Each
    lane tracks its own best; the winner is the argmin of the lanes' bests
    (first occurrence on ties, the host loop's strict-improvement rule),
    checkpointed once at the end, which selects the checkpoint the sequential
    chain's best-on-disk threading selects. The curve CSV keeps the last
    restart's rows, as the sequential CLI's does.

    `restart_devices` and `dp_devices` (`--restart_mode shard`, JAX's
    fused.py:351-445) spread the lanes over a 2-D (restart, data) mesh of the
    first restart_devices x dp_devices ranks (`mesh`, when it is already
    made): each rank trains its block of the lanes with no collective between
    lanes (`restart_devices` must divide the restarts) and, over `dp_devices`
    ranks, its block of every lane's batch: the vmapped gradients of its lanes
    are averaged over the lane's data group in one all-reduce of the stacked
    buffer, then Adam. At the end the mesh's ranks wait for each other
    without a collective (`wait_idle`: lanes may stop early), the lanes' bests
    are gathered, the winner's parameters broadcast, and rank 0 writes the
    one checkpoint. Every rank of the world calls this when it makes the
    mesh; ranks outside the mesh return at once (params None).
    """
    return _experiment_loop(**locals())


def _experiment_loop(niters, data_generator, model, restart_generators, batch_size, lr, test_freq, best_on_disk,
                     early_stop, path, shuffle, train_fold, train_expert, verbose, curve_path, events_path,
                     val_criterion, val_t0, device, restart_devices, dp_devices, mesh, init_params=None):
    """`fused_experiment_loop`; `init_params`, one parameter tree per restart, replaces the lanes' random
    initialisation (the dryrun's pinned parameters)."""
    global _LAST_RUN
    from .. import resolve_device
    from ..parallel.launch import is_writer, wait_idle
    from ..parallel.mesh import all_gather_rows, axis, barrier, forecast_terms, make_mesh_2d, member, replicate

    device = resolve_device(device)
    n_restart = len(restart_generators)
    if mesh is None and (int(restart_devices or 0) > 1 or int(dp_devices or 0) > 1):
        mesh = make_mesh_2d(max(1, int(restart_devices or 0)), max(1, int(dp_devices or 0)), ("restart", "data"))
    if mesh is not None and not member(mesh):
        return None, best_on_disk, 0.0
    r_group, i_r, n_r = axis(mesh, "restart") if mesh is not None else (None, 0, 1)
    dp = axis(mesh, "data")[2] if mesh is not None else 1
    if n_restart % n_r:
        raise ValueError(f"n_restart {n_restart} not divisible by restart_devices {n_r}")
    per = n_restart // n_r
    local = range(i_r * per, (i_r + 1) * per)  # this rank's lanes
    writer = is_writer()
    events = JSONLLogger(events_path if writer else None)
    try:
        with events.span("restart", None) as restart:
            verbose = verbose and writer
            capture = captures(model, device)
            fold, fold_n, train_chunk, val_chunks, val_n = _fold_geometry(data_generator, batch_size, train_fold)

            start = time.time()
            modules, idx, draws = [], [], []
            for r in local:
                gen_init, gen_train = restart_generators[r]
                modules.append(init_vi(gen_init, model, device=device) if init_params is None
                               else copy.deepcopy(init_params[r]).to(device))
                if train_expert:
                    unfreeze_expert(modules[-1])
                rng = np.random.RandomState(int(torch.randint(0, 2**31 - 1, (), generator=gen_train)))
                idx.append(_predraw_train_idx(rng, fold_n, train_chunk, niters, batch_size, shuffle))
            val_idx = _predraw_val_idx(val_n, batch_size, val_chunks)
            for r, lane_idx in zip(local, idx):
                draws.append(_predraw_noise(model, restart_generators[r][1], niters, test_freq, lane_idx.shape[-1],
                                            val_chunks, val_idx.shape[-1], val_criterion))

            stacked, _ = torch.func.stack_module_state(modules)
            train = {n: t for n, t in stacked.items() if t.requires_grad}
            frozen = {n: t for n, t in stacked.items() if not t.requires_grad}
            leaves = list(train.values())
            base = copy.deepcopy(modules[0]).to("meta")

            def call(fn):
                wrapper = _Functional(base, fn)

                def lane(train_p, frozen_p, *args):
                    named = {"tree." + n: t for n, t in {**train_p, **frozen_p}.items()}
                    return torch.func.functional_call(wrapper, named, args)

                return lane

            lane_loss = call(lambda tree, batch, eps, eps_kl: loss_fn(tree, model, batch, eps=eps, eps_kl=eps_kl))
            lane_grad = torch.func.grad_and_value(lane_loss)
            # The adjoint solver reads the host inside a solve (its lanes run outside the vmap,
            # `solvers/adjoint.py`), so its lanes run no whole budget, and their gradient is taken outside the vmap:
            # the lanes are independent, so the gradient of their summed losses is each lane's own.
            adjoint = getattr(model.decoder_spec, "use_adjoint", False)
            budget = contextlib.nullcontext if adjoint else dopri5.full_budget
            data_mesh = mesh if dp > 1 else None
            if val_criterion == "forecast":
                lane_eval = call(lambda tree, vbatch, eps, eps_kl: forecast_terms(tree, model, vbatch, val_t0,
                                                                                  data_mesh))
            else:
                lane_eval = call(lambda tree, vbatch, eps, eps_kl: loss_fn(tree, model, vbatch, eps=eps,
                                                                           eps_kl=eps_kl).reshape(1))

            def noise_dims(*noise):
                return tuple(None if n is None else 0 for n in noise)

            # Collectives are not batched by vmap: the lanes' gradients leave it stacked and are averaged after it.
            mean = _DataMean(mesh) if dp > 1 else None

            def grad_fn(batch, eps, eps_kl):
                in_dims = (0, 0, 0) + noise_dims(eps, eps_kl)
                if adjoint:
                    loss = torch.func.vmap(lane_loss, in_dims=in_dims)(train, frozen, batch, eps, eps_kl)
                    out = loss.detach(), list(torch.autograd.grad(loss.sum(), leaves, allow_unused=True))
                else:
                    with dopri5.full_budget():  # a vmapped solve cannot read `finished` on the host
                        grads, loss = torch.func.vmap(lane_grad, in_dims=in_dims)(train, frozen, batch, eps, eps_kl)
                    out = loss.detach(), [grads[n] for n in train]
                return out if mean is None else mean.step(*out)

            def eval_fn(vbatch, eps, eps_kl):
                with budget():
                    return torch.func.vmap(lane_eval, in_dims=(0, 0, None) + noise_dims(eps, eps_kl))(
                        train, frozen, vbatch, eps, eps_kl)

            def gather(i):
                flat = i.reshape(-1)
                return {k: v.index_select(1, flat).unflatten(1, tuple(i.shape)).movedim(1, 0) for k, v in fold.items()}

            def to_params(best, lane):
                out = copy.deepcopy(modules[lane])
                values = dict(zip(train, best)) | frozen
                with torch.no_grad():
                    for n, p in out.named_parameters():
                        p.copy_(values[n][lane])
                return out

            lane_idx = np.stack(idx, axis=1)
            noise = tuple(None if parts[0] is None else torch.stack(parts, dim=1)
                          for parts in zip(*(d[0] for d in draws)))
            val_noise = tuple(None if parts[0] is None else torch.stack(parts, dim=2)
                              for parts in zip(*(d[1] for d in draws)))
            if mean is not None:
                lane_idx, val_idx, noise, val_noise = _data_block(mesh, lane_idx, val_idx, noise, val_noise)
            run = _Run(leaves=leaves, lr=lr, grad_fn=grad_fn, eval_fn=eval_fn, gather=gather,
                       lanes=(per,), val_batches=_val_batches(data_generator, val_idx, device),
                       idx=torch.as_tensor(lane_idx, device=device),
                       noise=tuple(None if n is None else n.to(device) for n in noise),
                       val_noise=tuple(None if n is None else n.to(device) for n in val_noise),
                       niters=niters, test_freq=test_freq, early_stop=early_stop, best_on_disk=1e9, capture=capture,
                       events=events, to_params=to_params, forecast=val_criterion == "forecast", restart=restart,
                       mean=mean)
            _LAST_RUN = run
            run.run()
            packed = run.packed()
            if n_r > 1:
                wait_idle("lanes", mesh.mesh.flatten().tolist())
            out = _unpack(all_gather_rows(packed, r_group, n_r).cpu())  # every lane's buffers, in lane order
            wall = time.time() - start
            for j, r in enumerate(local):
                _restore_generator(restart_generators[r][1], draws[j][2], draws[j][3], int(out["last_itr"][r]),
                                   bool(out["nf"][r]))

            lane_out = [{k: v[r] for k, v in out.items()} for r in range(n_restart)]
            for r in range(n_restart):
                _replay_logs(lane_out[r], None, events, verbose, restart=r)
            curve = CSVCurveLogger(curve_path if writer else None)
            _replay_logs(lane_out[-1], curve, JSONLLogger(None), False)
            curve.close()

            best_per = out["best_od"]
            r_star = int(np.argmin(best_per))
            if not bool(out["improved"][0]):
                # Lane 0 never validated finitely: the sequential chain's end-of-restart load would have surfaced a
                # checkpoint already at `path` and threaded its loss as the later restarts' threshold.
                try:
                    best_on_disk = min(best_on_disk, float(ckpt.load_checkpoint(path, model.model_name, device)[2]))
                except FileNotFoundError:
                    pass
            if bool(out["improved"][r_star]) and float(best_per[r_star]) < best_on_disk:
                best_on_disk = float(best_per[r_star])
                owner, lane = divmod(r_star, per)
                winner = run.best_params(lane if owner == i_r else 0)
                if n_r > 1:  # from the winner's rank of this rank's column of the mesh
                    replicate(winner, r_group, owner)
                barrier(mesh)  # every rank has read what was on disk before rank 0 writes
                if writer:
                    ckpt.save_checkpoint(path, model.model_name, winner, int(out["best_itr"][r_star]), best_on_disk)
            events.log("done", wall=wall, best_on_disk=float(best_on_disk), captured=capture, restarts=n_restart)
    finally:
        events.close()

    # No restart ever validated finitely: the sequential loop would have saved restart 0's final state.
    best_params, best_on_disk = reload_best(path, model.model_name, to_params(leaves, 0), best_on_disk, device,
                                            mesh)
    if verbose:
        print("Time: {}".format(wall))
        print("Overall best loss: {:.6f}".format(best_on_disk))
    return best_params, best_on_disk, wall
