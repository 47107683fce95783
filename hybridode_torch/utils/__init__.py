"""Host-side helpers: structured logging, phase timers, a profiler trace, the cohort pickles."""

from .logging import CSVCurveLogger, JSONLLogger
from .profiling import PhaseTimer, trace_to

__all__ = ["JSONLLogger", "CSVCurveLogger", "PhaseTimer", "trace_to"]
