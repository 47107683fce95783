"""One process per rank: the world a mesh is cut from.

JAX sees every device of the host from one process; `torch.distributed`
runs one process per rank. `launch(fn, world_size, *args, device=...)` starts
them with the `spawn` start method (a fork after `import torch` can hang in
OpenMP), waits for them, and returns rank 0's result:

* the rendezvous is a `FileStore` in a fresh temporary directory, so that
  worlds started side by side (test workers) never contend for a TCP port;
* CUDA ranks take NCCL, one rank a GPU (`cuda:rank`); CPU ranks take gloo
  and one thread each. The backend follows the device and is never swapped
  for the other when one fails;
* a world of N GPUs needs N visible GPUs (the callers raise JAX's mesh
  error first, `mesh.require_devices`);
* only rank 0 prints: the other ranks' standard output goes to `os.devnull`,
  their standard error to their log; the code a rank runs writes files on
  rank 0 only (`is_writer`);
* every rank keeps a log in the world's directory (`rank<i>.log`): the
  steps of its life (joined, returned, closed), `faulthandler`'s traceback
  of a rank that crashes, and of each of a rank's threads when it gets
  `DUMP_SIGNAL`. A world that outlives its `timeout` sends that signal to
  every rank still alive, prints each rank's log (where each hangs), then
  raises `TimeoutError`; a world with a failed rank prints the logs before
  it raises. (No traceback is dumped on a timer: faulthandler's watchdog
  thread reads the frames of a thread that runs on, and ended a rank with
  SIGSEGV on the GPUs);
* a rank that raises makes its process exit non-zero, the other ranks are
  terminated, and the parent raises.

`init_world` joins an existing process to a world, as `launch`'s ranks do
(a world of one rank in-process: `init_world(0, 1, path, device)`), and
`close_world` leaves it. A rank that may wait longer than a collective's
timeout (ranks that only evaluate while others train, lanes that stop
early) waits in `wait_idle`, which polls the world's store and holds no
collective.
"""

from __future__ import annotations

import datetime
import faulthandler
import math
import os
import shutil
import signal
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

STORE_NAME = "store"
RESULT_NAME = "result.pt"
DUMP_SIGNAL = signal.SIGUSR1  # a rank dumps every thread's traceback into its log when it gets it

_STORE = None  # the world's store while this process is in a world
_ARRIVALS: dict = {}  # calls of `wait_idle` per name and set of ranks, in this world


def backend(device) -> str:
    """NCCL for CUDA tensors, gloo for CPU tensors (gloo has no CUDA all_gather)."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_world(rank: int, world_size: int, store_path: str, device="cpu", timeout: float | None = None) -> None:
    """Join rank `rank` of a world of `world_size` through the FileStore at `store_path`.

    A CUDA rank takes GPU `rank` and NCCL, whose communicator is made here
    (`device_id`), before any step could be captured. NCCL's asynchronous
    error handling is switched off, as PyTorch's CUDA-graph notes ask for
    collectives inside a graph. `timeout` (seconds) bounds each collective;
    None keeps the backend's default.
    """
    global _STORE
    device = torch.device(device)
    if device.type == "cuda":
        os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = "0"
        torch.cuda.set_device(rank)
    _STORE = dist.FileStore(store_path, world_size)
    _ARRIVALS.clear()
    wait_idle("joined", range(world_size))  # every rank is here: the backend connects well within `timeout`
    dist.init_process_group(backend(device), store=_STORE, rank=rank, world_size=world_size,
                            device_id=torch.device("cuda", rank) if device.type == "cuda" else None,
                            **({} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}))


def close_world() -> None:
    """Free every CUDA graph of the fused loops (`fused.release_graphs`), then destroy the process group.

    `destroy_process_group` waits forever on NCCL while a CUDA graph that
    captured one of the group's collectives is alive (seen with two ranks on
    H100s, torch 2.11 and NCCL 2.28.9), wherever the last reference to the
    graph is held; with the graphs reset first it returns at once.
    """
    global _STORE
    if dist.get_backend() == "nccl":
        from ..inference import fused

        fused.release_graphs()
        torch.cuda.synchronize()
    dist.destroy_process_group()
    _STORE = None


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_writer() -> bool:
    """Whether this process writes files and prints: rank 0, or a process outside any world."""
    return rank() == 0


def wait_idle(name: str, ranks=None, poll: float = 0.05) -> None:
    """Return once every rank of `ranks` (global ranks; the world when None) has called `wait_idle(name, ranks)`
    as often as this rank has.

    Each call adds one to a count in the world's store and polls it: no
    collective is held, so a rank may wait here for a whole training run,
    however short the process group's timeout. Nothing outside a world.
    """
    if _STORE is None:
        return
    ranks = tuple(range(world_size())) if ranks is None else tuple(ranks)
    key = (name, ranks)
    _ARRIVALS[key] = _ARRIVALS.get(key, 0) + 1
    count = f"wait_idle/{name}/{','.join(map(str, ranks))}/{_ARRIVALS[key]}"
    _STORE.add(count, 1)
    while _STORE.add(count, 0) < len(ranks):
        time.sleep(poll)


def _log_path(tmp: str, index: int) -> str:
    return os.path.join(tmp, f"rank{index}.log")


def _rank_entry(index, fn, world, store_path, device, result_path, args, timeout):
    log = open(_log_path(os.path.dirname(store_path), index), "a", buffering=1)

    def step(what):
        log.write(f"[rank {index} {time.strftime('%H:%M:%S')}] {what}\n")

    faulthandler.enable(file=log, all_threads=True)  # a crash (SIGSEGV, SIGABRT, ...) leaves its traceback
    faulthandler.register(DUMP_SIGNAL, file=log, all_threads=True)
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    if index:
        sys.stdout = open(os.devnull, "w")
        sys.stderr.flush()
        os.dup2(log.fileno(), 2)  # the native libraries' messages too
        sys.stderr = log
    step("started")
    init_world(index, world, store_path, device, timeout)
    step("joined the world")
    try:
        result = fn(*args)
        step("returned")
        if index == 0:
            torch.save(result, result_path)
    finally:
        close_world()
        step("closed the world")


def _last_words(tmp: str, world: int, tail: int = 8000) -> str:
    """Each rank's logged steps, then the rest of its log (its standard error, tracebacks) up to its last `tail`
    characters, for a world that did not finish."""
    parts = []
    for index in range(world):
        try:
            with open(_log_path(tmp, index)) as f:
                lines = f.read().splitlines()
        except FileNotFoundError:
            lines = []
        steps = [ln for ln in lines if ln.startswith(f"[rank {index} ")]
        rest = "\n".join(ln for ln in lines if not ln.startswith(f"[rank {index} "))[-tail:]
        parts.append(f"--- rank {index}: {' | '.join(steps) or 'no step logged'}\n{rest}")
    return "\n".join(parts)


def _joined(ctx, tmp: str, world: int, deadline: float) -> bool:
    """One wait of at most 5 s for the ranks (True once all have ended); a rank that failed raises here, after
    every rank's last steps and traceback are printed to standard error."""
    try:
        return ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic())))
    except (mp.ProcessRaisedException, mp.ProcessExitedException):
        print(_last_words(tmp, world), file=sys.stderr, flush=True)
        raise


def launch(fn, world_size: int, *args, device="cpu", timeout: float | None = None,
           collective_timeout: float | None = None):
    """Run `fn(*args)` on every rank of a new world of `world_size` processes; -> rank 0's result.

    `fn` must be importable by name (a module-level function): the ranks are
    spawned. Raises when a rank raises, or `TimeoutError` once `timeout`
    seconds have passed (None: no limit), with every rank terminated and each
    rank's last steps and traceback printed to standard error.
    `collective_timeout` is `init_world`'s `timeout`.
    """
    tmp = tempfile.mkdtemp(prefix="hybridode_world_")
    try:
        store, result = os.path.join(tmp, STORE_NAME), os.path.join(tmp, RESULT_NAME)
        ctx = mp.start_processes(_rank_entry,
                                 args=(fn, world_size, store, str(device), result, args, collective_timeout),
                                 nprocs=world_size, join=False, start_method="spawn")
        deadline = math.inf if timeout is None else time.monotonic() + timeout
        while not _joined(ctx, tmp, world_size, deadline):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        os.kill(p.pid, DUMP_SIGNAL)
                time.sleep(2.0)  # the dumps are written from the ranks' signal handlers
                print(_last_words(tmp, world_size), file=sys.stderr, flush=True)
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(10)
                    if p.is_alive():
                        p.kill()
                        p.join(10)
                raise TimeoutError(f"a world of {world_size} ranks did not finish within {timeout} s")
        return torch.load(result, weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
