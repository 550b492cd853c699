"""The hardware side: the firmware bridge (ctypes over the C++ core in
``firmware/``, built at first use), the teleop node, the optional ROS
adapter and the software-in-the-loop pipeline. Importing this package
builds nothing and imports no ROS."""
from .bridge import (AutoTare, ExperimentGenerator, FirmwareCore,
                     SimulatedWinchPlant, build_library, run_control_loop)
from .teleop import JoyState, TeleopNode, VirtualFirmwareSerial
from .sil import (export_bag, export_csv_bundle, run_sil_experiment,
                  sil_pipeline)
