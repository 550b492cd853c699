"""Optional rospy transport for the teleop node.

``hw.teleop.TeleopNode`` is the behavioral twin of the reference ROS
joystick node with the transport and the "topics" injected. This module is
the remaining literal glue the reference carries inline
(ros_ws/src/continuum/src/motor_joy_teleop:17-41 — node init, /joy
subscriber, /tension and /pwm ``QuaternionStamped`` publishers, pyserial on
/dev/ttyACM1 — and :112-127, the telemetry field wiring x,y,z,w =
values[0:4] / values[4:8]).

The package never imports rospy at module load: :func:`make_ros_teleop` is
the only entry that needs a live ROS, and :func:`wire_node` takes the rospy
surface as arguments so the wiring — topic names, message type, field
order, stamp, the /joy -> JoyState conversion — is testable against a fake
(tests/test_torch_hw.py) on hosts without ROS.

PyTorch port's copy of ``knode_cosserat_tpu/hw/ros_adapter.py`` (host
code, no tensor work).
"""
from __future__ import annotations

from typing import Callable

from .teleop import JoyState, TeleopNode

__all__ = ["wire_node", "make_ros_teleop"]

SERIAL_PORT = "/dev/ttyACM1"          # motor_joy_teleop:14
BAUD = 115200                         # motor_joy_teleop:29


def wire_node(rospy_api, transport, quaternion_stamped, joy_type,
              start_reader: bool = True) -> TeleopNode:
    """Build a TeleopNode publishing on real (or fake) rospy publishers.

    rospy_api must provide ``Publisher(topic, data_class, queue_size=)``,
    ``Subscriber(topic, data_class, callback, queue_size=)``,
    ``Time.from_sec(t)`` and ``loginfo(str)`` — the exact subset the
    reference node uses. ``quaternion_stamped`` is the message factory
    (geometry_msgs/QuaternionStamped: ``.header.stamp`` +
    ``.quaternion.{x,y,z,w}``); ``joy_type`` the sensor_msgs/Joy class
    (``.axes`` / ``.buttons``).
    """
    tension_pub = rospy_api.Publisher("tension", quaternion_stamped,
                                      queue_size=10)   # :36
    pwm_pub = rospy_api.Publisher("pwm", quaternion_stamped,
                                  queue_size=10)       # :37

    def publisher_cb(pub) -> Callable:
        # process_serial field wiring (:113-127): quaternion.x..w carry the
        # four channel values in order
        def cb(ts: float, vals):
            msg = quaternion_stamped()
            msg.header.stamp = rospy_api.Time.from_sec(ts)
            msg.quaternion.x = float(vals[0])
            msg.quaternion.y = float(vals[1])
            msg.quaternion.z = float(vals[2])
            msg.quaternion.w = float(vals[3])
            pub.publish(msg)
        return cb

    node = TeleopNode(transport,
                      publish_tension=publisher_cb(tension_pub),
                      publish_pwm=publisher_cb(pwm_pub),
                      log=rospy_api.loginfo,
                      start_reader=start_reader)

    def joy_cb(msg):                                   # :34 + :60
        node.get_joy(JoyState(axes=tuple(msg.axes),
                              buttons=tuple(msg.buttons)))

    node.joy_subscriber = rospy_api.Subscriber("/joy", joy_type, joy_cb,
                                               queue_size=10)
    return node


def make_ros_teleop(port: str = SERIAL_PORT, baud: int = BAUD,
                    transport=None):
    """Start the teleop node on a live ROS host.

    Returns ``(node, spin)``; call ``spin()`` to enter the reference's
    1 kHz send-on-change main loop (motor_joy_teleop:143-156). ``transport``
    defaults to ``serial.Serial(port, baud)``; pass a
    ``VirtualFirmwareSerial`` to run the ROS surface against the simulated
    firmware.
    """
    try:
        import rospy
        from geometry_msgs.msg import QuaternionStamped
        from sensor_msgs.msg import Joy
    except ImportError as e:                   # pragma: no cover - no ROS here
        raise ImportError(
            "make_ros_teleop needs a ROS 1 python environment (rospy + "
            "geometry_msgs + sensor_msgs); on ROS-less hosts drive "
            "hw.teleop.TeleopNode directly or via hw.sil") from e
    if transport is None:                      # pragma: no cover - hardware
        import os

        import serial
        if not os.path.exists(port):           # motor_joy_teleop:26-28
            rospy.logerr(f"Serial Port not found: {port} "
                         "motor_joy_teleop not started")
            rospy.signal_shutdown("Serial Port not found")
        transport = serial.Serial(port, baud, timeout=None)
    rospy.init_node("motor_joy_teleop", anonymous=True)   # :17
    node = wire_node(rospy, transport, QuaternionStamped, Joy)
    rospy.loginfo("motor_joy_teleop has started")          # :38

    def spin(rate_hz: float = 1000.0):                     # :151-155
        rate = rospy.Rate(rate_hz)
        while not rospy.is_shutdown():
            node.run_once()
            rate.sleep()

    return node, spin
