"""Python <-> firmware bridge.

PyTorch port's copy of ``knode_cosserat_tpu/hw/bridge.py`` (host code, no
tensor work), over the port's own copy of the firmware sources
(``hw/firmware/``):

- ``FirmwareCore``: ctypes binding to the portable C++ firmware core.
  :func:`build_library` compiles it at first use with the host C++
  compiler (``$CXX``, else ``g++``, else ``c++``) into
  ``build/hw_firmware/<hash of the sources>/libknode_hw.so`` beside the
  package; a failed build raises with the compiler's output.
- ``SimulatedWinchPlant``: a simple tendon/winch/load-cell model so the full
  control loop runs software-in-the-loop (the testable stand-in for the
  physical robot).
- ``ExperimentGenerator``: the teleop experiment patterns from the ROS node
  (reference ros_ws/src/continuum/src/motor_joy_teleop:60-109): step
  responses, polar sine sweeps, seeded random schedules, direct drive,
  emitting the same "T1 T2 T3 T4" gram commands.
- ``SerialBridge``: drives real hardware over pyserial with the same
  protocol ("T1 T2 T3 T4\\n" out, 9-field CSV telemetry in,
  motor_joy_teleop:112-141), if a serial port and pyserial are present.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

FW_DIR = Path(__file__).resolve().parent / "firmware"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hw_firmware"
_SOURCES = ("tension_controller.cpp", "c_api.cpp")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
_BUILD_LOCK = threading.Lock()


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no host C++ compiler ($CXX, g++ or c++) to build "
                           "the firmware core")
    return cxx


def build_library(force: bool = False) -> str:
    """Compile the firmware core to a shared library, once per content of
    its sources and flags; returns the library's path."""
    cxx = _cxx()
    h = hashlib.sha256(repr((cxx, CXX_FLAGS)).encode())
    for name in (*_SOURCES, "tension_controller.h"):
        h.update((FW_DIR / name).read_bytes())
    out = BUILD_DIR / h.hexdigest()[:16] / "libknode_hw.so"
    with _BUILD_LOCK:
        if force or not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [cxx, *CXX_FLAGS, "-shared",
                 *(str(FW_DIR / s) for s in _SOURCES), "-o", str(tmp)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"firmware build failed ({cxx}, exit "
                                   f"{proc.returncode}):\n{proc.stdout}"
                                   f"{proc.stderr}")
            os.replace(tmp, out)
    return str(out)


def check_arduino_shim() -> None:
    """Syntax- and type-check the Arduino Mega sketch against the stubbed
    Arduino API and the same tension_controller.h the host build uses
    (-Wall -Wextra -Werror): the stand-in for an on-target build where no
    AVR toolchain is installed. Raises with the compiler's output."""
    proc = subprocess.run(
        [_cxx(), "-x", "c++", "-std=c++17", "-fsyntax-only", "-Wall",
         "-Wextra", "-Werror", "-include", "arduino/arduino_stub.h", "-I.",
         "arduino/firmware_shim.ino"],
        cwd=FW_DIR, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"firmware_shim.ino check failed:\n{proc.stdout}"
                           f"{proc.stderr}")


def _load():
    lib = ctypes.CDLL(build_library())
    lib.knode_hw_create.restype = ctypes.c_void_p
    lib.knode_hw_create.argtypes = [ctypes.c_float] * 3
    lib.knode_hw_destroy.argtypes = [ctypes.c_void_p]
    lib.knode_hw_parse_line.restype = ctypes.c_int
    lib.knode_hw_parse_line.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    fptr = ctypes.POINTER(ctypes.c_float)
    lib.knode_hw_set_setpoints.argtypes = [ctypes.c_void_p, fptr]
    lib.knode_hw_get_setpoints.argtypes = [ctypes.c_void_p, fptr]
    lib.knode_hw_step.argtypes = [ctypes.c_void_p, fptr, ctypes.c_float, fptr]
    lib.knode_hw_estopped.restype = ctypes.c_int
    lib.knode_hw_estopped.argtypes = [ctypes.c_void_p]
    lib.knode_hw_telemetry.restype = ctypes.c_int
    lib.knode_hw_telemetry.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int]
    lib.knode_hw_tare_create.restype = ctypes.c_void_p
    lib.knode_hw_tare_destroy.argtypes = [ctypes.c_void_p]
    lib.knode_hw_tare_step.restype = ctypes.c_float
    lib.knode_hw_tare_step.argtypes = [ctypes.c_void_p, ctypes.c_float]
    lib.knode_hw_tare_done.restype = ctypes.c_int
    lib.knode_hw_tare_done.argtypes = [ctypes.c_void_p]
    return lib


_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        _lib = _load()
    return _lib


def _arr4(values) -> "ctypes.Array":
    return (ctypes.c_float * 4)(*[float(v) for v in values])


class FirmwareCore:
    """The reference firmware's control loop as a host-callable object."""

    def __init__(self, kp: float = -1, ki: float = -1, kd: float = -1):
        self._lib = _get_lib()
        self._h = self._lib.knode_hw_create(kp, ki, kd)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.knode_hw_destroy(self._h)
            self._h = None

    def parse_line(self, line: str) -> bool:
        return bool(self._lib.knode_hw_parse_line(self._h, line.encode()))

    def set_setpoints(self, sp: Sequence[float]):
        self._lib.knode_hw_set_setpoints(self._h, _arr4(sp))

    def setpoints(self) -> np.ndarray:
        out = _arr4([0] * 4)
        self._lib.knode_hw_get_setpoints(self._h, out)
        return np.array(out[:])

    def step(self, readings: Sequence[float], dt: float) -> np.ndarray:
        out = _arr4([0] * 4)
        self._lib.knode_hw_step(self._h, _arr4(readings), dt, out)
        return np.array(out[:])

    @property
    def estopped(self) -> bool:
        return bool(self._lib.knode_hw_estopped(self._h))

    def telemetry(self) -> Optional[str]:
        buf = ctypes.create_string_buffer(256)
        if self._lib.knode_hw_telemetry(self._h, buf, 256):
            return buf.value.decode()
        return None


class AutoTare:
    def __init__(self):
        self._lib = _get_lib()
        self._h = self._lib.knode_hw_tare_create()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.knode_hw_tare_destroy(self._h)
            self._h = None

    def step(self, reading: float) -> float:
        return float(self._lib.knode_hw_tare_step(self._h, reading))

    @property
    def done(self) -> bool:
        return bool(self._lib.knode_hw_tare_done(self._h))


class SimulatedWinchPlant:
    """First-order winch + tendon tension plant, per channel:
    d(tension)/dt = gain * pwm - leak * tension (+ slack floor at 0)."""

    def __init__(self, gain: float = 4000.0, leak: float = 0.5,
                 noise: float = 0.0, seed: int = 0):
        self.tension = np.zeros(4)
        self.gain, self.leak, self.noise = gain, leak, noise
        self.rng = np.random.RandomState(seed)

    def step(self, pwm: np.ndarray, dt: float) -> np.ndarray:
        self.tension += dt * (self.gain * np.asarray(pwm)
                              - self.leak * self.tension)
        self.tension = np.maximum(self.tension, 0.0)
        r = self.tension.copy()
        if self.noise:
            r += self.noise * self.rng.randn(4)
        return r


def run_control_loop(core: FirmwareCore, plant: SimulatedWinchPlant,
                     duration: float, dt: float = 0.002,
                     command_stream: Optional[Iterator[Tuple[float, str]]]
                     = None):
    """Software-in-the-loop run; returns (t, readings, pwms) histories."""
    cmds = list(command_stream or [])
    ts, readings_h, pwm_h = [], [], []
    readings = plant.step(np.zeros(4), dt)
    t = 0.0
    ci = 0
    while t < duration:
        while ci < len(cmds) and cmds[ci][0] <= t:
            core.parse_line(cmds[ci][1])
            ci += 1
        pwm = core.step(readings, dt)
        readings = plant.step(pwm, dt)
        ts.append(t)
        readings_h.append(readings.copy())
        pwm_h.append(pwm.copy())
        t += dt
    return np.asarray(ts), np.asarray(readings_h), np.asarray(pwm_h)


class ExperimentGenerator:
    """Teleop experiment command generators (motor_joy_teleop:60-109),
    yielding (time, "T1 T2 T3 T4") gram commands."""

    STEP_TENSIONS = (800, 950, 1100, 1250, 1400)   # :68
    SINE_PERIODS = (0.5, 0.75, 1, 2, 3)            # :76

    @classmethod
    def step_x(cls, parameter: int) -> List[Tuple[float, str]]:
        t = cls.STEP_TENSIONS[parameter]
        return [(0.0, f"500 500 {t} {t}")]

    @classmethod
    def step_y(cls, parameter: int) -> List[Tuple[float, str]]:
        t = cls.STEP_TENSIONS[parameter]
        return [(0.0, f"500 {t} {t} 500")]

    @staticmethod
    def _polar(angle: float, amplitude: float = 1.0) -> str:
        tensions = np.array([np.cos(angle), np.sin(angle),
                             -np.cos(angle), -np.sin(angle)])
        tensions = np.round(500 + 300 * tensions * amplitude).astype(int)
        return "{} {} {} {}".format(*tensions)

    @classmethod
    def sine(cls, parameter: int) -> List[Tuple[float, str]]:
        period = cls.SINE_PERIODS[parameter]
        cmds = [(0.0, cls._polar(0))]
        t = 0.3
        for tau in np.arange(0, 3 * period, 0.1):
            cmds.append((t, cls._polar(tau / period * 2 * np.pi)))
            t += 0.1
        cmds.append((t + 0.3, cls._polar(0, 0)))
        return cmds

    @staticmethod
    def random(seed: int, duration: float = 60.0,
               interval: float = 0.4) -> List[Tuple[float, str]]:
        rng = np.random.RandomState(seed)
        cmds = []
        t = 0.0
        for _ in np.arange(0, duration, interval):
            tensions = np.round(500 + 700 * rng.random(4)).astype(int)
            cmds.append((t, "{} {} {} {}".format(*tensions)))
            t += interval
        cmds.append((t, "0 0 0 0"))
        return cmds

    @staticmethod
    def direct(x: float, y: float) -> str:
        tensions = np.array([x, y, -x, -y])
        tensions = np.round(500 + 400 * tensions).astype(int)
        return "{} {} {} {}".format(*tensions)


class SerialBridge:
    """Real-hardware driver over the firmware serial protocol."""

    def __init__(self, port: str = "/dev/ttyACM1", baud: int = 115200):
        import serial  # optional dependency
        self.ser = serial.Serial(port, baud, timeout=None)
        self.send("")  # clear noise, motor_joy_teleop:30

    def send(self, line: str):
        self.ser.write((line + "\n").encode())

    def read_telemetry(self) -> Optional[dict]:
        line = self.ser.readline().decode(errors="replace").strip()
        values = line.split(",")
        if len(values) == 9:
            vals = [float(v) for v in values]
            return {"tension": vals[0:4], "pwm": vals[4:8], "dt_ms": vals[8]}
        return None

    def run_experiment(self, commands: List[Tuple[float, str]]):
        t0 = time.time()
        for at, cmd in commands:
            while time.time() - t0 < at:
                time.sleep(0.005)
            self.send(cmd)
