"""Utilities: rollout and training health (health.py)."""
from .health import GuardedTraining, RolloutReport, check_rollout

__all__ = ["GuardedTraining", "RolloutReport", "check_rollout"]
