"""The JAX package's firmware-core tests (tests/test_hw.py) on the port's
hw/bridge.py, ros_adapter.py and teleop.py, over the port's own copy of the
firmware, built into build/hw_firmware/; plus the build's contract (the
library is built from the port's sources into build/, a failed build raises
with the compiler's output) and the teleop reader thread under a time
limit."""
import os
import shutil
import sys
import time

import numpy as np
import pytest

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")

from knode_cosserat_tpu_torch.hw import bridge
from knode_cosserat_tpu_torch.hw.bridge import (AutoTare, ExperimentGenerator,
                                                FirmwareCore,
                                                SimulatedWinchPlant,
                                                run_control_loop)


def test_pid_reaches_setpoint():
    core = FirmwareCore()
    core.set_setpoints([300, 500, 800, 400])
    # low-leak plant: the reference KI=0.005 integrates slowly, so a leaky
    # plant would need ~100 s to close the last few percent
    plant = SimulatedWinchPlant(leak=0.05)
    t, readings, pwm = run_control_loop(core, plant, duration=3.0)
    final = readings[-1]
    np.testing.assert_allclose(final, [300, 500, 800, 400], rtol=0.05)
    assert not core.estopped


def test_serial_protocol_parse():
    core = FirmwareCore()
    assert core.parse_line("100 200 300 400")
    np.testing.assert_array_equal(core.setpoints(), [100, 200, 300, 400])
    assert not core.parse_line("garbage")
    # unchanged after a bad line
    np.testing.assert_array_equal(core.setpoints(), [100, 200, 300, 400])


def test_estop_triggers_and_latches():
    core = FirmwareCore()
    pwm = core.step([100, 100, 2400, 100], dt=0.001)
    # reverse pulse on ALL motors (firmware.ino:105)
    np.testing.assert_allclose(pwm, [-0.4] * 4)
    assert core.estopped
    # after the 0.5 s reverse window: halted at zero forever
    for _ in range(600):
        pwm = core.step([0, 0, 0, 0], dt=0.001)
    np.testing.assert_allclose(pwm, [0.0] * 4)
    assert core.estopped
    # new setpoints don't resurrect it
    core.parse_line("100 100 100 100")
    pwm = core.step([0, 0, 0, 0], dt=0.001)
    np.testing.assert_allclose(pwm, [0.0] * 4)


def test_anti_windup_bounds_integral():
    core = FirmwareCore()
    core.set_setpoints([2000, 2000, 2000, 2000])
    # long stall at zero tension: integral must clamp, not diverge
    for _ in range(20000):
        pwm = core.step([0, 0, 0, 0], dt=0.01)
    assert np.all(np.abs(pwm) <= 1.0)


def test_telemetry_format():
    core = FirmwareCore()
    core.step([1, 2, 3, 4], dt=0.001)
    line = core.telemetry()
    assert line is not None
    parts = line.split(",")
    assert len(parts) == 9
    assert float(parts[0]) == pytest.approx(1.0)
    # next 9 iterations are silent (telemetry every 10th, firmware.ino:74)
    silent = [core.telemetry() is None
              for _ in range(9)
              if core.step([1, 2, 3, 4], dt=0.001) is not None]
    assert all(silent)


def test_autotare_sequence():
    tare = AutoTare()
    reading = 0.0
    pwms = []
    # phase 1: tension climbs slowly, then jumps (cable engages)
    for r in [0, 2, 4, 6, 50, 55]:
        pwms.append(tare.step(r))
        if tare.done:
            break
    assert any(p == pytest.approx(0.2) for p in pwms)  # tension-up drive
    # after the +30 jump it backs off at -0.1 until stable
    p = tare.step(40.0)
    assert p == pytest.approx(-0.1)
    p = tare.step(39.0)  # change < 5 -> done
    assert p == 0.0
    assert tare.done


def test_experiment_generators():
    cmds = ExperimentGenerator.step_x(1)
    assert cmds == [(0.0, "500 500 950 950")]
    sine = ExperimentGenerator.sine(0)
    assert sine[0][1] == ExperimentGenerator._polar(0)
    assert sine[-1][1] == "500 500 500 500"  # return to center
    rnd1 = ExperimentGenerator.random(3, duration=2.0)
    rnd2 = ExperimentGenerator.random(3, duration=2.0)
    assert rnd1 == rnd2  # seeded determinism
    assert ExperimentGenerator.direct(0, 0) == "500 500 500 500"


def test_loop_with_command_stream():
    core = FirmwareCore()
    plant = SimulatedWinchPlant(leak=0.05)
    cmds = ExperimentGenerator.step_x(0)  # 500 500 800 800
    t, readings, _ = run_control_loop(core, plant, duration=2.5,
                                      command_stream=iter(cmds))
    np.testing.assert_allclose(readings[-1], [500, 500, 800, 800], rtol=0.05)


def test_arduino_shim_syntax_checks():
    """The Mega sketch stays compilable C++ against the same
    tension_controller.h the host build uses (the JAX package's
    `make check-ino`)."""
    bridge.check_arduino_shim()


def test_library_builds_from_the_ports_sources_into_build():
    path = bridge.build_library()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path.startswith(os.path.join(root, "build", "hw_firmware") + os.sep)
    assert os.path.exists(path)
    assert str(bridge.FW_DIR).startswith(os.path.join(
        root, "knode_cosserat_tpu_torch") + os.sep)


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    fw = tmp_path / "firmware"
    fw.mkdir()
    for name in ("tension_controller.cpp", "c_api.cpp",
                 "tension_controller.h"):
        (fw / name).write_text((bridge.FW_DIR / name).read_text())
    (fw / "c_api.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(bridge, "FW_DIR", fw)
    monkeypatch.setattr(bridge, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="firmware build failed") as e:
        bridge.build_library()
    assert "c_api.cpp" in str(e.value)
    assert not list((tmp_path / "build").rglob("*.so"))


class _FakeTime:
    @staticmethod
    def from_sec(t):
        return ("stamp", float(t))


class _FakeRospy:
    """The exact rospy surface motor_joy_teleop uses (:17-41,112-127)."""
    Time = _FakeTime

    def __init__(self):
        self.publishers = {}
        self.subscribers = {}
        self.logs = []

    def Publisher(self, topic, data_class, queue_size=None):
        fake = self

        class _Pub:
            def __init__(self):
                self.topic, self.data_class = topic, data_class
                self.queue_size = queue_size
                self.published = []

            def publish(self, msg):
                self.published.append(msg)

        pub = _Pub()
        fake.publishers[topic] = pub
        return pub

    def Subscriber(self, topic, data_class, callback, queue_size=None):
        self.subscribers[topic] = (data_class, callback)
        return (topic, callback)

    def loginfo(self, msg):
        self.logs.append(str(msg))


class _FakeQuaternionStamped:
    """geometry_msgs/QuaternionStamped field surface."""

    class _H:
        stamp = None

    class _Q:
        x = y = z = w = 0.0

    def __init__(self):
        self.header = self._H()
        self.quaternion = self._Q()


class _FakeJoy:
    def __init__(self, axes, buttons):
        self.axes, self.buttons = axes, buttons


def test_ros_adapter_wiring():
    """wire_node reproduces the reference node's ROS surface: topic names,
    message type, telemetry field order x..w = values[0:4]/[4:8]
    (motor_joy_teleop:112-127), and /joy -> get_joy dispatch (:34,:60)."""
    from knode_cosserat_tpu_torch.hw.ros_adapter import wire_node
    from knode_cosserat_tpu_torch.hw.teleop import VirtualFirmwareSerial

    rospy = _FakeRospy()
    vs = VirtualFirmwareSerial()
    node = wire_node(rospy, vs, _FakeQuaternionStamped, _FakeJoy,
                     start_reader=False)
    try:
        assert set(rospy.publishers) == {"tension", "pwm"}
        assert all(p.data_class is _FakeQuaternionStamped
                   and p.queue_size == 10
                   for p in rospy.publishers.values())
        assert "/joy" in rospy.subscribers
        assert rospy.subscribers["/joy"][0] is _FakeJoy

        # a firmware telemetry line lands on both topics with the
        # reference field wiring
        node.process_serial("11,22,33,44,0.1,0.2,0.3,0.4,2.0")
        t = rospy.publishers["tension"].published[-1]
        assert (t.quaternion.x, t.quaternion.y,
                t.quaternion.z, t.quaternion.w) == (11.0, 22.0, 33.0, 44.0)
        assert t.header.stamp[0] == "stamp"
        p = rospy.publishers["pwm"].published[-1]
        assert (p.quaternion.x, p.quaternion.y,
                p.quaternion.z, p.quaternion.w) == (0.1, 0.2, 0.3, 0.4)

        # /joy messages drive the experiment dispatch
        _, joy_cb = rospy.subscribers["/joy"]
        joy_cb(_FakeJoy(axes=(0.0, 0.0, 1.0, 0.0, 0.0, 1.0),
                        buttons=(1, 0, 0, 0, 0, 0)))     # A: step X #0
        assert node.serial_cmd == "500 500 800 800"
        assert any("STEP RESPONSE X" in m for m in rospy.logs)
    finally:
        node.stop()
        vs.close()


def test_reader_thread_publishes_telemetry_and_stops():
    """The node's daemon reader thread (start_reader=True) against the
    virtual firmware: telemetry lands on the tension topic, and stop()
    ends the thread. Every wait has its own limit, so a hang fails."""
    from knode_cosserat_tpu_torch.hw.teleop import (TeleopNode,
                                                    VirtualFirmwareSerial)

    vs = VirtualFirmwareSerial()
    got = []
    node = TeleopNode(vs, publish_tension=lambda t, v: got.append(v),
                      log=lambda *_: None, sleep_fn=vs.pump_for)
    try:
        node.serial_cmd = "500 500 800 800"
        node.run_once()                 # sends, then pumps 0.1 s
        deadline = time.monotonic() + 10.0
        while len(got) < 5 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(got) >= 5, len(got)
        assert all(len(v) == 4 for v in got)
    finally:
        node.stop()
        vs.close()
        node.reader.join(timeout=5.0)
    assert not node.reader.is_alive()


def test_ros_adapter_imports_no_rospy():
    import importlib

    sys.modules.pop("knode_cosserat_tpu_torch.hw.ros_adapter", None)
    importlib.import_module("knode_cosserat_tpu_torch.hw.ros_adapter")
    assert "rospy" not in sys.modules
