"""Utilities: normalization, metrics logging, profiling, and rollout and
training health."""
from .data_processing import denormalize_data, normalize_data
from .health import GuardedTraining, RolloutReport, check_rollout
from .logging import MetricsLogger
from .profiling import annotate, count, drain, new_call, trace

__all__ = ["normalize_data", "denormalize_data", "MetricsLogger", "annotate",
           "count", "drain", "new_call", "trace", "GuardedTraining",
           "RolloutReport", "check_rollout"]
