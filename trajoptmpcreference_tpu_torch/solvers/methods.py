"""Solver-method enums mirroring the reference API
(ref: TrajoptMPCReference.py:13-27); the factories accept either the enum
or its string value."""

from __future__ import annotations

import enum


class SQPSolverMethods(enum.Enum):
    """(ref: TrajoptMPCReference.py:13-18)."""

    N = "N"
    S = "S"
    PCG_J = "PCG-J"
    PCG_BJ = "PCG-BJ"
    PCG_SS = "PCG-SS"


class MPCSolverMethods(enum.Enum):
    """(ref: TrajoptMPCReference.py:21-27)."""

    iLQR = "iLQR"
    QP_N = "QP-N"
    QP_S = "QP-S"
    QP_PCG_J = "QP-PCG-J"
    QP_PCG_BJ = "QP-PCG-BJ"
    QP_PCG_SS = "QP-PCG-SS"


def method_str(method) -> str:
    """Accept an enum member or its string value."""
    if isinstance(method, (SQPSolverMethods, MPCSolverMethods)):
        return method.value
    return str(method)
