"""The port's native C++ dynamics against the port's PyTorch dynamics and
kinematics, f64 on the CPU: the reference's cross-implementation pattern
(ref: GRiD/test/testGRiDRefactorings.py:20-101) across the language
boundary, as tests/test_native.py holds the JAX package's.

Every algorithm tests/test_native.py covers, on the 2-, 3- and 6-link
arms at seed 1337, at 1e-10 (ref: GRiD/util/util.py:59-69) of
ops/rbd.py and ops/kinematics.Kinematics; the end-effector Jacobian at
tests/test_native.py's 1e-5, since the native one is a central
difference (h = 1e-7, dynamics.hpp ``ee_jacobian``) whose rounding alone
is ~1e-9.  Also the CLI on arm3, and the generated C++ against the JAX
package's ``generate_cpp``: equal text, but for the include line, which
names each package's own copy of dynamics.hpp, and the two copies equal.
"""

import shutil

import numpy as np
import pytest
import torch

from trajoptmpcreference_tpu.models.urdf import serial_arm as jserial_arm
from trajoptmpcreference_tpu.native import codegen as jcodegen
from trajoptmpcreference_tpu_torch.models.urdf import serial_arm
from trajoptmpcreference_tpu_torch.ops.kinematics import Kinematics
from trajoptmpcreference_tpu_torch.ops.rbd import make_rbd

ARMS = [2, 3, 6]
TOL = 1e-10
f64 = torch.float64


@pytest.fixture(scope="module")
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")


@pytest.fixture(scope="module", params=ARMS)
def setup(request, gxx, tmp_path_factory):
    from trajoptmpcreference_tpu_torch.native import NativeDynamics
    n = request.param
    robot = serial_arm(n)
    native = NativeDynamics(robot, cache_dir=str(tmp_path_factory.mktemp("native")))
    rng = np.random.default_rng(1337)   # (ref: printGRiD.cu:10 fixed seed)
    q, qd, u = (rng.standard_normal(n) for _ in range(3))
    return native, make_rbd(robot), Kinematics(robot), q, qd, u


def _t(*arrays):
    return [torch.tensor(a, dtype=f64) for a in arrays]


def _close(a, ref, tol=TOL):
    np.testing.assert_allclose(a, ref.numpy() if torch.is_tensor(ref) else ref,
                               rtol=0, atol=tol)


def test_rnea(setup):
    native, rbd, kin, q, qd, u = setup
    _close(native.rnea(q, qd), rbd.rnea(*_t(q, qd))[0])
    qdd = np.sin(q)
    _close(native.rnea(q, qd, qdd), rbd.rnea(*_t(q, qd, qdd))[0])


def test_crba_and_minv(setup):
    native, rbd, kin, q, qd, u = setup
    _close(native.crba(q), rbd.crba(*_t(q)))
    _close(native.minv(q), rbd.minv(*_t(q)))


def test_fd(setup):
    native, rbd, kin, q, qd, u = setup
    _close(native.fd(q, qd, u), rbd.fd(*_t(q, qd, u)))


def test_rnea_grad(setup):
    native, rbd, kin, q, qd, u = setup
    qdd = np.cos(q)
    _close(native.rnea_grad(q, qd, qdd), rbd.rnea_grad(*_t(q, qd, qdd)))


def test_fd_grad(setup):
    native, rbd, kin, q, qd, u = setup
    _close(native.fd_grad(q, qd, u), rbd.fd_grad(*_t(q, qd, u)))


def test_aba(setup):
    """Native ABA against the port's ABA and against Minv (u - c), the
    forward-dynamics identity (ref: RBDReference_generalized.py:913-998)."""
    native, rbd, kin, q, qd, u = setup
    qdd = native.aba(q, qd, u)
    _close(qdd, rbd.aba(*_t(q, qd, u)))
    _close(qdd, native.fd(q, qd, u))


def test_idsva(setup):
    """Native IDSVA against the port's IDSVA and its own 4-pass RNEA
    gradient (ref: RBDReference_generalized.py:717-826)."""
    native, rbd, kin, q, qd, u = setup
    qdd = np.sin(q)
    dq, dqd = native.idsva(q, qd, qdd)
    ref_dq, ref_dqd = rbd.idsva(*_t(q, qd, qdd))
    _close(dq, ref_dq)
    _close(dqd, ref_dqd)
    g4 = native.rnea_grad(q, qd, qdd)
    _close(dq, g4[:, :native.n])
    _close(dqd, g4[:, native.n:])


def test_kinematics(setup):
    native, rbd, kin, q, qd, u = setup
    _close(native.ee_pos(q), kin.ee_pos_xyz(*_t(q)))
    J = native.ee_jacobian(q)
    _close(J, kin.jacobian(*_t(q))[:J.shape[0]], 1e-5)


def test_cli(gxx, tmp_path, capsys):
    """The printGRiD analogue: emit, then the full print and cross-check
    against the port (ref: GRiD/printGRiD.py:27-47)."""
    from trajoptmpcreference_tpu_torch.native.__main__ import main
    out = tmp_path / "arm3.cpp"
    assert main(["arm3", "--emit", str(out)]) == 0
    assert "tmr::rnea" in out.read_text()
    assert main(["arm3"]) == 0
    text = capsys.readouterr().out
    assert "ALL CHECKS PASSED" in text
    assert text.count(" OK") == 13


@pytest.mark.parametrize("n", ARMS)
def test_generated_source_matches_jax(n):
    from trajoptmpcreference_tpu_torch.native import codegen
    port = codegen.generate_cpp(serial_arm(n)).splitlines()
    ref = jcodegen.generate_cpp(jserial_arm(n)).splitlines()
    assert port[0] == f'#include "{codegen._HEADER}"'
    assert ref[0].startswith("#include") and ref[0].endswith('dynamics.hpp"')
    assert port[1:] == ref[1:]
    assert codegen._HEADER.read_text() == jcodegen._HEADER.read_text()
