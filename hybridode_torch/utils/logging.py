"""The port's tracer: spans and counts recorded in memory, a JSONL exporter, and the training-curve CSV.

Every span is kept in one process-wide ring (`RECORDER`, the last
`RING_SIZE` spans): a name, a start and an end in integer nanoseconds on the
Unix-epoch clock that PyTorch's profiler stamps its events with, its own id, its
parent's id and the id of its root (the restart or the request it belongs
to), and its fields and counts. Times come from the monotonic clock plus one
offset to the epoch taken when the recorder starts, as the profiler's
approximate clock is converted, so that a step of the wall clock does not
tear a span and the spans line up with a profiler trace of the same process.
A span costs host work only: no device call, no synchronize and no profiler
range (a profiler's user range would put a `gpu_user_annotation` copy of
itself on the device timeline, among the kernels).

A span's fields may be added while it is open, also by code that does not
hold it (`annotate`): the decoder names the route of the `decode` span that
its caller opened.

A `DeviceCounter` holds sums that a kernel adds on the device, in one int64
tensor a device, beside counts that the host keeps; only its `read` copies
them to the host, once.

`JSONLLogger` writes the spans of a loop or a CLI to its file, one record a
span when it ends (`t`, `event`, the fields, `t0`, `t1`, `id`, `parent`,
`root`, and `seconds` for a span that lasts). A span is recorded whether or
not its logger has a file open.

Trace a process with PyTorch's profiler after every timed phase of it, never
before one: a trace with CUDA activity slows every later GPU step of its
process by ~1.3x, even after its events are collected (measured on an H100 by
`flow_step_study.py`).

The training curve keeps the reference's `iter,val_loss,train_loss` CSV
format, one line per validation point.
"""

from __future__ import annotations

import collections
import functools
import itertools
import json
import os
import threading
import time
from typing import Optional

import torch

# Spans the process keeps in memory, the oldest dropped first: ~80 MB of Python objects at most. A forecast request
# records 6, and a 51 s window of the benchmark's forecast cell holds ~13,000 requests on an H100 (PERF.md §5).
RING_SIZE = 1 << 18
_OPEN = object()  # a span's parent by default: the innermost span open in its thread


class Span:
    """One span; a context manager that opens it on entry and records it on exit.

    `fields` are its own numbers and labels; fields may be added until it ends.
    """

    __slots__ = ("name", "t0", "t1", "id", "parent", "root", "fields", "_recorder", "_sink")

    def __init__(self, recorder: "Recorder", name: str, parent, fields: dict, sink=None):
        self._recorder, self._sink = recorder, sink
        self.name, self.fields, self.id = name, fields, next(recorder._ids)
        if parent is _OPEN:
            stack = recorder._open.stack
            parent = stack[-1] if stack else None
        self.parent = None if parent is None else parent.id
        self.root = self.id if parent is None else parent.root
        self.t0 = self.t1 = None

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def __enter__(self) -> "Span":
        self._recorder._open.stack.append(self)
        self.t0 = time.monotonic_ns() + self._recorder._offset
        return self

    def __exit__(self, *exc):
        self.t1 = time.monotonic_ns() + self._recorder._offset
        self._recorder._open.stack.pop()
        self._recorder._end(self)
        return False


class _Open(threading.local):
    """A thread's stack of open spans."""

    def __init__(self):
        self.stack = []


class Recorder:
    """The ring of finished spans and, per thread, the stack of open ones."""

    def __init__(self):
        self.spans = collections.deque(maxlen=RING_SIZE)
        self._ids = itertools.count(1)
        self._open = _Open()
        before = time.monotonic_ns()
        wall = time.time_ns()
        self._offset = wall - (before + time.monotonic_ns()) // 2

    def now(self) -> int:
        """Nanoseconds since the Unix epoch, on the monotonic clock."""
        return time.monotonic_ns() + self._offset

    def span(self, name: str, parent=_OPEN, sink=None, **fields) -> Span:
        """A span to enter with `with`. `parent`: a `Span`, or None for a root; by default the innermost open
        span of this thread. `sink(span)` is called once it is recorded."""
        return Span(self, name, parent, fields, sink)

    def instant(self, name: str, sink=None, **fields) -> Span:
        """A span of no duration, recorded now, under the innermost open span."""
        s = Span(self, name, _OPEN, fields, sink)
        s.t0 = s.t1 = self.now()
        self._end(s)
        return s

    def _end(self, s: Span):
        self.spans.append(s)
        if s._sink is not None:
            s._sink(s)

    def last(self, name: str) -> Optional[Span]:
        """The span of `name` that ended last, or None."""
        return next((s for s in reversed(self.spans) if s.name == name), None)

    def children(self, parent: Span) -> list:
        """The finished spans whose parent is `parent`, oldest first."""
        out = []
        for s in reversed(self.spans):
            if s.t1 < parent.t0:
                break
            if s.parent == parent.id:
                out.append(s)
        return out[::-1]


RECORDER = Recorder()


def span(name: str, parent=_OPEN, **fields) -> Span:
    """A span of the process's recorder, kept in its ring alone."""
    return RECORDER.span(name, parent, **fields)


def annotate(name: str, **fields) -> None:
    """Adds `fields` to the innermost open span of this thread if it is named `name`; does nothing otherwise."""
    stack = RECORDER._open.stack
    if stack and stack[-1].name == name:
        stack[-1].fields.update(fields)


class DeviceCounter:
    """Process-wide sums that kernels add on the device, `names` in an int64 tensor a device, and the host's own
    counts `host_names` beside them. A kernel adds into `tensor(device)` with atomics, so no count costs a host read;
    `read` copies each device's tensor to the host once."""

    def __init__(self, names: tuple, host_names: tuple):
        self.names = names
        self.host = dict.fromkeys(host_names, 0)
        self._device = {}

    def tensor(self, device):
        """The `(len(names),)` int64 tensor that kernels on `device` add to, zeroed at its first use."""
        t = self._device.get(device)
        if t is None:
            t = self._device[device] = torch.zeros(len(self.names), dtype=torch.int64, device=device)
        return t

    def add(self, **counts) -> None:
        """Adds to the host's counts."""
        for k, v in counts.items():
            self.host[k] += v

    def read(self) -> dict:
        """The host's counts and the device sums over every device, by name."""
        out = dict(self.host) | dict.fromkeys(self.names, 0)
        for t in self._device.values():
            for k, v in zip(self.names, t.tolist()):
                out[k] += v
        return out


def root_span(fn):
    """Each call of `fn` is a root span named after it: the id its spans share."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        with RECORDER.span(fn.__name__, None):
            return fn(*args, **kwargs)

    return call


class JSONLLogger:
    """The exporter of a loop's or a CLI's spans: an append-only JSONL file, one record a span as it ends."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def span(self, name: str, parent=_OPEN, **fields) -> Span:
        """A span of the process's recorder, also written here when it ends."""
        return RECORDER.span(name, parent, self._write, **fields)

    def log(self, event: str, **fields) -> Span:
        """A span of no duration, now."""
        return RECORDER.instant(event, self._write, **fields)

    def export(self, event: str, s: Span, **fields):
        """Write the finished span `s` under the name `event`, with `fields` and the seconds of its children by
        name."""
        children = collections.defaultdict(float)
        for c in RECORDER.children(s):
            children[c.name] += c.seconds
        self._write(s, event, fields | {"children": dict(children)})

    def _write(self, s: Span, event: Optional[str] = None, extra: Optional[dict] = None):
        if self._f is None:
            return
        rec = {"t": s.t1 / 1e9, "event": event or s.name, **s.fields, **(extra or {})}
        if s.t1 != s.t0:
            rec["seconds"] = s.seconds
        rec.update(t0=s.t0, t1=s.t1, id=s.id, parent=s.parent, root=s.root)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


class CSVCurveLogger:
    """Training-curve CSV, `iter,val_loss,train_loss`, one line per validation point."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "w")
        else:
            self._f = None

    def log(self, itr: int, val_loss: float, train_loss: float):
        if self._f is None:
            return
        self._f.write(f"{itr},{val_loss:.6f},{train_loss:.6f}\n")
        self._f.flush()

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
