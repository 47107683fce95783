"""Structured event logging (the port's own copy of hybridode/utils/logging.py).

The training curve keeps the reference's `iter,val_loss,train_loss` CSV
format, one line per validation point; the JSONL log appends timestamped
events beside it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class JSONLLogger:
    """Append-only JSONL event log with wall-clock timestamps."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def log(self, event: str, **fields):
        if self._f is None:
            return
        rec = {"t": time.time(), "event": event}
        rec.update(fields)
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
