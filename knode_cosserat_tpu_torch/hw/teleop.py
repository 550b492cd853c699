"""Teleop node: behavioral twin of the reference ROS joystick node
(ros_ws/src/continuum/src/motor_joy_teleop) without a ROS dependency.

Replicated structure, cited to the reference:
  * joystick dispatch — A/B step responses, X sine sweep, Y seeded random,
    default analog direct drive, with the trigger/bumper-encoded parameter
    (motor_joy_teleop:60-109);
  * a daemon serial-reader thread that parses 9-field CSV telemetry into
    tension/pwm "topics" and tolerates garbage lines
    (process_serial/serial_read, :112-141);
  * the main loop sends commands ONLY on change, then paces 0.1 s
    (run, :143-149).

"Topics" are injected callbacks (publish_tension/publish_pwm), so the same
node drives rospy publishers, a log file, or a test list. The transport is
anything with write(bytes)/readline(): pyserial for real hardware
(hw.bridge.SerialBridge.ser) or ``VirtualFirmwareSerial`` — the portable
C++ firmware core + simulated winch plant behind a serial-style interface —
for full software-in-the-loop runs.

PyTorch port's copy of ``knode_cosserat_tpu/hw/teleop.py`` (host
code, no tensor work).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .bridge import ExperimentGenerator, FirmwareCore, SimulatedWinchPlant

__all__ = ["JoyState", "TeleopNode", "VirtualFirmwareSerial"]


@dataclasses.dataclass
class JoyState:
    """sensor_msgs/Joy payload (Xbox layout used by the reference):
    axes[0:2] left stick, axes[2]/axes[5] triggers (1.0 = released);
    buttons[0..3] = A, B, X, Y; buttons[4:6] = bumpers."""
    axes: Sequence[float] = (0.0, 0.0, 1.0, 0.0, 0.0, 1.0)
    buttons: Sequence[int] = (0, 0, 0, 0, 0, 0)


class VirtualFirmwareSerial:
    """The Arduino behind a serial port, in software: incoming command
    lines feed the C++ firmware core (same parser as firmware.ino:76-92),
    ``pump()`` advances the control loop against the winch plant, and the
    core's CSV telemetry (every 10th loop, firmware.ino:100,130-137) becomes
    readline()-able output."""

    def __init__(self, plant: Optional[SimulatedWinchPlant] = None,
                 dt: float = 0.002):
        self.core = FirmwareCore()
        self.plant = plant or SimulatedWinchPlant()
        self.dt = dt
        self.t = 0.0
        self._rx: "queue.Queue[bytes]" = queue.Queue()
        self._readings = self.plant.step(np.zeros(4), dt)
        self.telemetry_log: List[Tuple[float, np.ndarray, np.ndarray]] = []
        self.command_log: List[Tuple[float, str]] = []
        self._open = True

    # --- serial-port surface -------------------------------------------
    def write(self, data: bytes):
        for line in data.decode(errors="replace").split("\n"):
            line = line.strip()
            if line:
                self.command_log.append((self.t, line))
                self.core.parse_line(line)

    def readline(self, timeout: float = 1.0) -> bytes:
        try:
            return self._rx.get(timeout=timeout)
        except queue.Empty:
            return b""

    def close(self):
        self._open = False

    # --- plant/loop surface --------------------------------------------
    def pump(self, n_steps: int = 1):
        """Advance the firmware loop n_steps x dt."""
        for _ in range(n_steps):
            pwm = self.core.step(self._readings, self.dt)
            self._readings = self.plant.step(pwm, self.dt)
            self.t += self.dt
            line = self.core.telemetry()
            if line is not None:
                self.telemetry_log.append(
                    (self.t, self._readings.copy(), np.asarray(pwm)))
                self._rx.put((line + "\n").encode())

    def pump_for(self, duration: float):
        self.pump(int(round(duration / self.dt)))


class TeleopNode:
    """motor_joy_teleop:13-156 without rospy.

    publish_tension/publish_pwm receive (timestamp, [4] floats) — the
    /tension and /pwm QuaternionStamped republishing (:115-129).
    sleep_fn is injectable so SIL runs can advance a virtual clock
    (pumping the firmware) instead of real-sleeping.
    """

    STEP_TENSIONS = ExperimentGenerator.STEP_TENSIONS      # :68
    SINE_PERIODS = ExperimentGenerator.SINE_PERIODS        # :76
    RANDOM_SEEDS = (0, 1, 2, 3, 4)                         # :93

    def __init__(self, transport,
                 publish_tension: Optional[Callable] = None,
                 publish_pwm: Optional[Callable] = None,
                 log: Callable[[str], None] = print,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 start_reader: bool = True):
        self.transport = transport
        self.publish_tension = publish_tension or (lambda *_: None)
        self.publish_pwm = publish_pwm or (lambda *_: None)
        self.log = log
        self.sleep = sleep_fn
        # initial command state (:22-23)
        self.serial_cmd = "300 300 300 300"
        self.prev_serial_cmd = "300 300 300 300"
        self.send_serial("")          # clear serial noise (:30)
        self._alive = True
        if start_reader:
            self.reader = threading.Thread(target=self.serial_read,
                                           daemon=True)   # :39-41
            self.reader.start()

    # --- serial ---------------------------------------------------------
    def send_serial(self, send: str):
        self.transport.write((send + "\n").encode())

    def process_serial(self, line: str):
        """9-field CSV -> tension + pwm topics (:112-129)."""
        values = line.split(",")
        if len(values) == 9:
            now = time.time()
            self.publish_tension(now, [float(v) for v in values[0:4]])
            self.publish_pwm(now, [float(v) for v in values[4:8]])

    def serial_read(self):
        """Garbage-tolerant reader loop (:131-141)."""
        while self._alive:
            line = self.transport.readline()
            if line == b"" and not getattr(self.transport, "_open", True):
                return
            try:
                line = line.decode().strip()
                self.process_serial(line)
                if line and "," not in line:
                    self.log(f"Serial read {line}")
            except Exception as e:          # noqa: BLE001 — parity: :140-141
                self.log(f"rubbish {line!r} {e}")

    def stop(self):
        self._alive = False

    # --- joystick dispatch (:60-109) -------------------------------------
    @staticmethod
    def parameter_of(joy: JoyState) -> int:
        trigger_left = 1 if joy.axes[2] != 1 else 0
        trigger_right = 1 if joy.axes[5] != 1 else 0
        b = list(joy.buttons) + [0] * (6 - len(joy.buttons))
        return (trigger_left + (trigger_right << 1)
                + (b[4] << 2) + (b[5] << 3))

    def get_joy(self, joy: JoyState):
        parameter = self.parameter_of(joy)
        if joy.buttons[0]:                                  # A: step X
            t = self.STEP_TENSIONS[parameter]
            self.log(f"STEP RESPONSE X #{parameter}: {t}")
            self.serial_cmd = f"500 500 {t} {t}"
        elif joy.buttons[1]:                                # B: step Y
            t = self.STEP_TENSIONS[parameter]
            self.log(f"STEP RESPONSE Y #{parameter}: {t}")
            self.serial_cmd = f"500 {t} {t} 500"
        elif joy.buttons[2]:                                # X: sine sweep
            period = self.SINE_PERIODS[parameter]
            self.log(f"SINE RESPONSE #{parameter}: {period}")
            # the reference sends these immediately from the callback,
            # sleeping between sends (:84-91)
            self._send_now(ExperimentGenerator._polar(0))
            self.sleep(0.3)
            for tau in np.arange(0, 3 * period, 0.1):
                self._send_now(
                    ExperimentGenerator._polar(tau / period * 2 * np.pi))
                self.sleep(0.1)
            self.sleep(0.3)
            self._send_now(ExperimentGenerator._polar(0, 0))
        elif joy.buttons[3]:                                # Y: random 60 s
            seed = self.RANDOM_SEEDS[parameter]
            rng = np.random.RandomState(seed)               # np.random.seed :94
            for _ in np.arange(0, 60, 0.4):
                t4 = np.round(500 + 700 * rng.random(4)).astype(int)
                self._send_now("{} {} {} {}".format(*t4))
                self.sleep(0.4)
            self._send_now("0 0 0 0")
        else:                                               # direct drive
            self.serial_cmd = ExperimentGenerator.direct(joy.axes[0],
                                                         joy.axes[1])

    def _send_now(self, cmd: str):
        self.serial_cmd = cmd
        self.send_serial(cmd)
        self.prev_serial_cmd = cmd

    # --- main loop (:143-156) --------------------------------------------
    def run_once(self):
        if self.serial_cmd != self.prev_serial_cmd:
            # commands only get sent on changes, not continually (:145)
            self.log(f"Serial Command: {self.serial_cmd}")
            self.send_serial(self.serial_cmd)
            self.prev_serial_cmd = self.serial_cmd
            self.sleep(0.1)                                 # :149

    def spin(self, iterations: int, rate_hz: float = 1000.0):
        for _ in range(iterations):
            self.run_once()
            self.sleep(1.0 / rate_hz)
