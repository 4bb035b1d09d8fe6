"""Native (C++) rigid-body dynamics: the robot-specialized host library.

Port of trajoptmpcreference_tpu/native.  codegen.py generates
robot-specialized C++ from the port's RobotModel (the analogue of the
reference's GRiD CUDA code generator); lib.py binds the compiled library
through ctypes.  Numpy in, numpy out; no torch on this path.
"""

from trajoptmpcreference_tpu_torch.native.lib import NativeDynamics

__all__ = ["NativeDynamics"]
