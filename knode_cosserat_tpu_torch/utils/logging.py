"""Structured metrics logging — replaces the reference's print statements +
metrics-pickled-inside-checkpoints observability (SURVEY.md section 5).

JSONL metrics stream (one record per event) + a stdout mirror compatible
with the reference's "Epoch %d" / "Total loss:" format so existing log
scrapers (physics_multitrain.py:111-121 regex parsing) still work.

A copy of the JAX package's module of the same name (it imports no JAX).
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

__all__ = ["MetricsLogger"]


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, stdout: bool = True,
                 run_name: str = ""):
        self.path = path
        self.stdout = stdout
        self.run_name = run_name
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")
        self._t0 = time.time()

    def log(self, step: int, **metrics):
        rec = {"t": round(time.time() - self._t0, 3), "step": step,
               "run": self.run_name, **metrics}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.stdout:
            if "loss" in metrics:
                print(f"Epoch {step}")
                print(f"Total loss: {metrics['loss']:.6e}")
            else:
                print(json.dumps(rec))
            sys.stdout.flush()

    def close(self):
        if self._fh:
            self._fh.close()
