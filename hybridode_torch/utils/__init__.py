"""Host-side helpers: the tracer and its JSONL exporter, the training-curve CSV, the cohort pickles."""

from .logging import CSVCurveLogger, JSONLLogger

__all__ = ["JSONLLogger", "CSVCurveLogger"]
