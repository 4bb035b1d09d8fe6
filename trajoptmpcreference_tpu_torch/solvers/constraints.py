"""Constraint interface the solver queries — an empty set in this slice.

Port of the parts of trajoptmpcreference_tpu/solvers/constraints.py that
the unconstrained flagship touches.  A ``ConstraintSet`` here holds no
limits: adding a joint, velocity or torque limit raises, because box
constraints (active-set, full-set, quadratic penalty, augmented
Lagrangian) and their condensed Schur path are still to be ported
(ROADMAP queue 1).  The query functions return the empty results the JAX
package returns for a set without limits, batched over a leading axis.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


def _not_ported(kind: str):
    raise NotImplementedError(
        f"{kind} limits are not ported yet (the slice solves the "
        "unconstrained flagship); see ROADMAP.md queue 1")


@dataclasses.dataclass(frozen=True)
class ConstraintSet:
    """(ref: TrajoptConstraint.py:178-208), without limits."""

    nq: int
    nv: int
    nu: int
    N: int

    def with_joint_limits(self, *args, **kwargs) -> "ConstraintSet":
        _not_ported("joint")

    def with_velocity_limits(self, *args, **kwargs) -> "ConstraintSet":
        _not_ported("velocity")

    def with_torque_limits(self, *args, **kwargs) -> "ConstraintSet":
        _not_ported("torque")

    @property
    def hard_rows_stage(self) -> int:
        return 0

    def has_soft(self) -> bool:
        return False

    def has_hard(self) -> bool:
        return False

    def soft_xu_separable(self) -> bool:
        return True

    def init_state(self, dtype=torch.float64, device=None) -> Tuple:
        return ()


def stage_hard_rows(cs: ConstraintSet, xk, uk, terminal: bool):
    """Masked hard rows at the knots xk (..., nx): (vals (..., 0),
    jac (..., 0, width), active (..., 0))."""
    width = cs.nq + cs.nv + (0 if terminal else cs.nu)
    lead = xk.shape[:-1]
    return (xk.new_zeros(lead + (0,)), xk.new_zeros(lead + (0, width)),
            torch.zeros(lead + (0,), dtype=torch.bool, device=xk.device))


def max_soft_violation(cs: ConstraintSet, state, X, U):
    """(B,) max soft violation of X (B, nx, N), U (B, nu, N-1)."""
    return X.new_zeros(X.shape[:-2])


def update_all_soft(cs: ConstraintSet, state, X, U):
    """(state', all_mu_at_limit (B,))."""
    return (), torch.ones(X.shape[:-2], dtype=torch.bool, device=X.device)


def shift_all_soft(cs: ConstraintSet, state, shift_steps: int):
    return ()
