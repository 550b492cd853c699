"""Tendon-tension control schedules.

Parity rewrite of reference physics_controls.py:3-33 (numpy, host-side —
controls are tiny inputs computed once). The reference's ``ramp`` referenced
an undefined ``ramp_speed`` (physics_controls.py:26, a latent NameError); we
fix it by taking ramp_speed = control_arg, documented here.
"""
from __future__ import annotations

import numpy as np

__all__ = ["calc_controls", "CONTROL_TYPES"]

CONTROL_TYPES = ("sine", "step", "random", "ramp")


def calc_controls(control_type: str, control_arg: float, del_t: float,
                  length: int) -> np.ndarray:
    """Generate a (length, 4) tension schedule in newtons.

    sine:   4 tendons, baseline 6 N, amplitude 1 N, phase-shifted 90 degrees;
            period = control_arg seconds (physics_controls.py:7-13).
    step:   baseline 5 N, +control_arg on T1/T4 after 1.5 s (:14-19).
    random: uniform 5-10 N, numpy seeded with int(control_arg) (:20-24).
    ramp:   baseline 5 N, T1/T4 ramp at control_arg N/s (:25-29, fixed).
    """
    rng = np.random.RandomState(int(control_arg))
    controls = []
    for i in range(1, length + 1):
        if control_type == "sine":
            sin_period = control_arg / del_t
            phase = 2 * np.pi / 4
            row = [6 + np.sin(2 * np.pi * i / sin_period + k * phase)
                   for k in range(4)]
        elif control_type == "step":
            s = 0.0 if i * del_t < 1.5 else control_arg
            row = [5 + s, 5.0, 5.0, 5 + s]
        elif control_type == "random":
            row = [5 + 5 * rng.rand() for _ in range(4)]
        elif control_type == "ramp":
            r = i * control_arg * del_t
            row = [5 + r, 5.0, 5.0, 5 + r]
        else:
            raise ValueError(f"Unknown control type {control_type!r}")
        controls.append(row)
    return np.asarray(controls, np.float64)
