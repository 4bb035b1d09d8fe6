"""Box constraints on joint position / velocity / torque per timestep.

Port of trajoptmpcreference_tpu/solvers/constraints.py (ref:
TrajoptConstraint.py:5-387) with every function batched: the JAX module is
written per sample and vmapped, these take the scenario batch (and the
knots, where a function works on several) as leading dimensions and
reduce only over the rows and timesteps of one scenario, never over the
batch.

Hard constraints (ACTIVE_SET, FULL_SET) contribute their full 2*size rows
per knot with a boolean activity mask; inactive rows are zeroed and the
KKT system pins their multipliers to zero (solvers/kkt.py).  Soft
constraints (QUADRATIC_PENALTY, AUGMENTED_LAGRANGIAN) carry their
hyperparameters (mu, lambda, phi) in a ``SoftLimitState`` per limit, with
the reference's AL/penalty update schedule (ref: :138-166) and the MPC
warm shift (ref: :168-176, shifting correctly where the reference wipes
every column but the first).

The JAX package's deliberate departures from the reference are kept:

* the soft penalty acts on VIOLATED rows only (the reference's value
  squares every row's margin while its jacobian is masked to violated
  rows, ref: :76-86 vs :114-125);
* the violation is |min(margin, 0)|, not abs(min(margin)) (ref: :131-136);
* joint and velocity limits get N columns, not N-1, so the terminal knot
  has its own soft state (ref: :195).

Shapes: a soft state's arrays are (*batch, 2*size, num_timesteps); a
knot function takes z (..., K, d) with the knot indices k (K,); X is
(B, nx, N) and U (B, nu, N-1).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

HARD_MODES = ("ACTIVE_SET", "FULL_SET")
SOFT_MODES = ("QUADRATIC_PENALTY", "AUGMENTED_LAGRANGIAN")


def _validate_mode(mode: str) -> str:
    """(ref: TrajoptConstraint.py:33-51; ADMM_PROJECTION is declared but
    unimplemented in the reference, ref: :88-91 'NOT IMPLEMENTED YET')."""
    if mode == "ADMM_PROJECTION":
        raise NotImplementedError(
            "ADMM_PROJECTION is declared but not implemented (matching the "
            "reference, ref: TrajoptConstraint.py:88-91)")
    if mode not in HARD_MODES + SOFT_MODES:
        raise ValueError(
            f"Invalid constraint mode {mode!r}; options are "
            f"{HARD_MODES + SOFT_MODES} (ref: TrajoptConstraint.py:46-51)")
    return mode


@dataclasses.dataclass(frozen=True)
class BoxLimitSpec:
    """One box-constrained slice of the per-knot decision vector [x; u]."""

    kind: str            # 'joint' | 'velocity' | 'torque'
    size: int
    col_offset: int      # start column within [x; u]
    lower: Tuple[float, ...]
    upper: Tuple[float, ...]
    mode: str
    num_timesteps: int   # N for joint/velocity (terminal column), N-1 for torque
    at_terminal: bool    # does this limit apply at k = N-1?
    mu_init: float = 1e-2
    mu_factor: float = 10.0
    mu_max: float = 1e12
    phi_init: float = 1e-2
    phi_factor: float = 10.0
    # ACTIVE_SET activation band: rows with margin < band (strictly) stay
    # in the working set; 0.0 = the reference's activation on violation
    activation_band: float = 0.0

    @property
    def rows(self) -> int:
        return 2 * self.size

    @property
    def is_hard(self) -> bool:
        return self.mode in HARD_MODES

    @property
    def is_soft(self) -> bool:
        return self.mode in SOFT_MODES

    def bounds(self, dtype, device=None):
        """(lower, upper) as (size,) tensors, built once per (dtype,
        device)."""
        return _bounds(self, dtype, torch.device(device or "cpu"))


class SoftLimitState(NamedTuple):
    """AL/penalty hyperparameters, (*batch, 2*size, num_timesteps) each
    (ref: TrajoptConstraint.py:23-25)."""

    mu: torch.Tensor
    lam: torch.Tensor
    phi: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ConstraintSet:
    """Aggregates joint/velocity/torque limits (ref: TrajoptConstraint.py:178-208)."""

    nq: int
    nv: int
    nu: int
    N: int
    limits: Tuple[BoxLimitSpec, ...] = ()

    # ---- construction ----
    def with_joint_limits(self, upper, lower, mode, **opts) -> "ConstraintSet":
        # N columns (not the reference's N-1): joint limits apply at the
        # terminal knot, which needs its own soft-state column
        spec = BoxLimitSpec("joint", self.nq, 0, _bt(lower, self.nq),
                            _bt(upper, self.nq), _validate_mode(mode),
                            self.N, True, **opts)
        return dataclasses.replace(self, limits=self.limits + (spec,))

    def with_velocity_limits(self, upper, lower, mode, size=None,
                             **opts) -> "ConstraintSet":
        size = self.nv if size is None else size
        spec = BoxLimitSpec("velocity", size, self.nq, _bt(lower, size),
                            _bt(upper, size), _validate_mode(mode),
                            self.N, True, **opts)
        return dataclasses.replace(self, limits=self.limits + (spec,))

    def with_torque_limits(self, upper, lower, mode, size=None,
                           **opts) -> "ConstraintSet":
        """``size`` < nu constrains the first ``size`` controls (the
        reference's bounds-list length, ref: TrajoptConstraint.py:12-19)."""
        size = self.nu if size is None else size
        spec = BoxLimitSpec("torque", size, self.nq + self.nv,
                            _bt(lower, size), _bt(upper, size),
                            _validate_mode(mode), self.N - 1, False, **opts)
        return dataclasses.replace(self, limits=self.limits + (spec,))

    # ---- static row counts ----
    @property
    def hard_limits(self):
        return tuple(l for l in self.limits if l.is_hard)

    @property
    def soft_limits(self):
        return tuple(l for l in self.limits if l.is_soft)

    @property
    def hard_rows_stage(self) -> int:
        return sum(l.rows for l in self.hard_limits)

    @property
    def hard_rows_term(self) -> int:
        return sum(l.rows for l in self.hard_limits if l.at_terminal)

    def has_soft(self) -> bool:
        return len(self.soft_limits) > 0

    def has_hard(self) -> bool:
        return len(self.hard_limits) > 0

    def soft_xu_separable(self) -> bool:
        """True when the soft limits touch only the state slice or only the
        control slice of [x; u], so the Gauss-Newton term outer(gc, gc)
        keeps the cost Hessian (x, u)-block-diagonal (what kkt._g_split
        needs).  A torque AL limit is separable; a torque limit stacked
        with a joint or velocity soft limit is not."""
        u_soft = any(l.kind == "torque" for l in self.soft_limits)
        x_soft = any(l.kind != "torque" for l in self.soft_limits)
        return not (u_soft and x_soft)

    # ---- state ----
    def init_state(self, dtype=torch.float64, device=None,
                   batch: Tuple[int, ...] = ()) -> Tuple[SoftLimitState, ...]:
        """A fresh state per soft limit, (*batch, 2*size, num_timesteps)
        each, in ``dtype`` on ``device``."""
        out = []
        for l in self.soft_limits:
            shape = tuple(batch) + (l.rows, l.num_timesteps)
            full = lambda v: torch.full(shape, v, dtype=dtype, device=device)
            out.append(SoftLimitState(mu=full(l.mu_init), lam=full(0.0),
                                      phi=full(l.phi_init)))
        return tuple(out)


def _bt(vals, size) -> Tuple[float, ...]:
    vals = np.asarray(vals, dtype=float).ravel()
    if vals.size == 1:
        vals = np.full(size, vals[0])
    if vals.size != size:
        raise ValueError("bounds must have the constraint size or be scalar "
                         "(ref: TrajoptConstraint.py:12-16)")
    return tuple(vals.tolist())


@functools.lru_cache(maxsize=None)
def _bounds(spec: BoxLimitSpec, dtype, device):
    return (torch.tensor(spec.lower, dtype=dtype, device=device),
            torch.tensor(spec.upper, dtype=dtype, device=device))


@functools.lru_cache(maxsize=None)
def _selector(spec: BoxLimitSpec, width: int, dtype, device):
    J = np.zeros((spec.rows, width))
    for i in range(spec.size):
        J[i, spec.col_offset + i] = 1.0
        J[spec.size + i, spec.col_offset + i] = -1.0
    return torch.tensor(J, dtype=dtype, device=device)


def select_state(mask, new, old):
    """Per scenario, ``new`` where mask (B,) else ``old``, leaf by leaf over
    a tuple of SoftLimitState."""
    def sel(a, b):
        m = mask.reshape(mask.shape + (1,) * (max(a.dim(), b.dim())
                                              - mask.dim()))
        return torch.where(m, a, b)
    return tuple(SoftLimitState(*(sel(a, b) for a, b in zip(n, o)))
                 for n, o in zip(new, old))


# --------------------------------------------------------------- primitives

def margin(spec: BoxLimitSpec, z):
    """Full-set margins [z - lb; ub - z] over z's last axis, negative =
    violated (ref: TrajoptConstraint.py:53-61)."""
    lo, hi = spec.bounds(z.dtype, z.device)
    zz = z[..., :spec.size]
    return torch.cat([zz - lo, hi - zz], dim=-1)


def signed_selector(spec: BoxLimitSpec, width: int, dtype, device=None):
    """Constant (2s, width) matrix: +1 rows for lower bounds, -1 for upper,
    placed at col_offset (ref: TrajoptConstraint.py:99-106,191-208);
    built once per (spec, width, dtype, device)."""
    return _selector(spec, width, dtype, torch.device(device or "cpu"))


def _box_margin(spec: BoxLimitSpec, Z):
    """Margins [z - lb; ub - z] of a trajectory slice Z (B, dim, T), laid
    out (B, 2s, T)."""
    lo, hi = spec.bounds(Z.dtype, Z.device)
    zz = Z[..., :spec.size, :]
    return torch.cat([zz - lo[:, None], hi[:, None] - zz], dim=-2)


def _live(spec: BoxLimitSpec, m):
    """The hard rows that count: ACTIVE_SET's m < band (strictly), every
    row for FULL_SET."""
    if spec.mode == "ACTIVE_SET":
        return m < spec.activation_band
    return torch.ones_like(m, dtype=torch.bool)


def hard_rows(spec: BoxLimitSpec, z, width: int):
    """Masked hard-constraint rows: (values (..., 2s), jacobian
    (..., 2s, width), active (..., 2s)); values and jacobian are zeroed on
    inactive rows, FULL_SET keeps every row live."""
    m = margin(spec, z)
    active = _live(spec, m)
    J = signed_selector(spec, width, z.dtype, z.device)
    vals = torch.where(active, m, torch.zeros_like(m))
    Jm = torch.where(active[..., None], J, torch.zeros_like(J))
    return vals, Jm, active


def _at(a, k):
    """State columns at the knots k: (*batch, 2s, T) -> (*batch, K, 2s)."""
    return a[..., k].transpose(-1, -2)


def soft_value(spec: BoxLimitSpec, state: SoftLimitState, z, k):
    """mu . err^2 (+ lambda . err for AL) over VIOLATED rows, (..., K)."""
    m = margin(spec, z)
    mv = torch.where(m < 0, m, torch.zeros_like(m))
    val = (_at(state.mu, k) * mv * mv).sum(-1)
    if spec.mode == "AUGMENTED_LAGRANGIAN":
        val = val + (_at(state.lam, k) * mv).sum(-1)
    return val


def soft_jacobian(spec: BoxLimitSpec, state: SoftLimitState, z, k, width: int):
    """Gradient rows (..., K, width) of the soft penalty, masked to violated
    rows (ref: TrajoptConstraint.py:114-125).  The selector's product is
    written out: row i of [lb; ub] adds to column col_offset + i with sign
    +1 / -1."""
    m = margin(spec, z)
    active = m < 0
    zero = torch.zeros_like(m)
    s, c = spec.size, spec.col_offset

    def through_selector(v):
        v = torch.where(active, v, zero)
        return v[..., :s] - v[..., s:]

    gs = 2.0 * through_selector(_at(state.mu, k) * m)
    if spec.mode == "AUGMENTED_LAGRANGIAN":
        gs = gs + through_selector(_at(state.lam, k))
    g = gs.new_zeros(gs.shape[:-1] + (width,))
    g[..., c:c + s] = gs
    return g


def update_soft_state(spec: BoxLimitSpec, state: SoftLimitState, Z):
    """AL / penalty schedule over all timesteps (ref: TrajoptConstraint.py:
    138-166).  Z: (B, dim, num_timesteps), the slice of the trajectory this
    limit constrains.  Returns (new_state, mu_all_at_max (B,)): True for a
    scenario with no mu update below the cap and no lambda update."""
    m = _box_margin(spec, Z)
    active = m < 0
    lam_near = m.abs() < state.phi
    lam_upd = active & lam_near
    mu_upd = active & ~lam_near
    mu_below = state.mu < spec.mu_max
    new_mu = torch.where(mu_upd & mu_below,
                         (state.mu * spec.mu_factor).clamp(max=spec.mu_max),
                         state.mu)
    new_lam = torch.where(lam_upd, state.lam + state.mu * m, state.lam)
    new_phi = torch.where(lam_upd, state.phi / spec.phi_factor, state.phi)
    any_progress = ((mu_upd & mu_below) | lam_upd).flatten(-2).any(-1)
    return SoftLimitState(new_mu, new_lam, new_phi), ~any_progress


def shift_soft_state(spec: BoxLimitSpec, state: SoftLimitState,
                     shift_steps: int) -> SoftLimitState:
    """MPC warm shift (ref: TrajoptConstraint.py:168-176): columns move
    ``shift_steps`` to the left and the vacated ones take mu_init, 0 and
    phi_init."""
    def sh(a, fill):
        T = a.shape[-1]
        rolled = torch.roll(a, -shift_steps, dims=-1)
        keep = torch.arange(T, device=a.device) < (T - shift_steps)
        return torch.where(keep, rolled, torch.full_like(a, fill))
    return SoftLimitState(mu=sh(state.mu, spec.mu_init),
                          lam=sh(state.lam, 0.0),
                          phi=sh(state.phi, spec.phi_init))


# ---------------------------------------------------- aggregate operations

def _z_slice(cs: ConstraintSet, spec: BoxLimitSpec, xk, uk):
    if spec.kind == "torque":
        return uk
    if spec.kind == "velocity":
        return xk[..., cs.nq:]
    return xk[..., :cs.nq]


def stage_soft_value(cs: ConstraintSet, state, xk, uk, k):
    """Sum of soft penalties at the stage knots k, (..., K)
    (ref: TrajoptConstraint.py:295-307)."""
    val = 0.0
    for spec, st in zip(cs.soft_limits, state):
        val = val + soft_value(spec, st, _z_slice(cs, spec, xk, uk), k)
    return val


def term_soft_value(cs: ConstraintSet, state, xN, k):
    val = 0.0
    for spec, st in zip(cs.soft_limits, state):
        if spec.at_terminal:
            val = val + soft_value(spec, st, _z_slice(cs, spec, xN, None), k)
    return val


def stage_soft_jacobian(cs: ConstraintSet, state, xk, uk, k):
    """(..., K, nx+nu) gradient of the stage soft penalty
    (ref: TrajoptConstraint.py:309-337)."""
    width = cs.nq + cs.nv + cs.nu
    g = xk.new_zeros(xk.shape[:-1] + (width,))
    for spec, st in zip(cs.soft_limits, state):
        g = g + soft_jacobian(spec, st, _z_slice(cs, spec, xk, uk), k, width)
    return g


def term_soft_jacobian(cs: ConstraintSet, state, xN, k):
    """(..., K, nx): the terminal knot's soft gradient spans [x] only."""
    width = cs.nq + cs.nv
    g = xN.new_zeros(xN.shape[:-1] + (width,))
    for spec, st in zip(cs.soft_limits, state):
        if spec.at_terminal:
            g = g + soft_jacobian(spec, st, _z_slice(cs, spec, xN, None), k,
                                  width)
    return g


def stage_hard_rows(cs: ConstraintSet, xk, uk, terminal: bool):
    """Stacked masked hard rows at the knots xk (..., nx): (vals (..., m),
    jac (..., m, width), active (..., m)).  width = nx+nu for stages, nx at
    the terminal knot (torque limits are excluded at N-1, ref:
    TrajoptConstraint.py:230,305)."""
    width = cs.nq + cs.nv + (0 if terminal else cs.nu)
    vals, jacs, actives = [], [], []
    for spec in cs.hard_limits:
        if terminal and not spec.at_terminal:
            continue
        v, J, a = hard_rows(spec, _z_slice(cs, spec, xk, uk), width)
        vals.append(v)
        jacs.append(J.expand(v.shape + (width,)))
        actives.append(a)
    if not vals:
        lead = xk.shape[:-1]
        return (xk.new_zeros(lead + (0,)), xk.new_zeros(lead + (0, width)),
                torch.zeros(lead + (0,), dtype=torch.bool, device=xk.device))
    return (torch.cat(vals, -1), torch.cat(jacs, -2), torch.cat(actives, -1))


def stage_hard_values(cs: ConstraintSet, xk, uk, terminal: bool):
    """The values of ``stage_hard_rows`` alone, (..., m): the masked
    margins, without the jacobian (the merit's violation term)."""
    vals = []
    for spec in cs.hard_limits:
        if terminal and not spec.at_terminal:
            continue
        m = margin(spec, _z_slice(cs, spec, xk, uk))
        vals.append(torch.where(_live(spec, m), m, torch.zeros_like(m)))
    if not vals:
        return xk.new_zeros(xk.shape[:-1] + (0,))
    return torch.cat(vals, -1)


def _trajectory_slice(cs: ConstraintSet, spec: BoxLimitSpec, X, U):
    """The (B, size, num_timesteps) slice of X (B, nx, N) / U (B, nu, N-1)
    that ``spec`` bounds."""
    if spec.kind == "torque":
        return U[..., :spec.size, :spec.num_timesteps]
    if spec.kind == "velocity":
        return X[..., cs.nq:cs.nq + spec.size, :spec.num_timesteps]
    return X[..., :spec.size, :spec.num_timesteps]


def _max_violation(cs: ConstraintSet, specs, X, U):
    best = X.new_zeros(X.shape[:-2])
    for spec in specs:
        m = _box_margin(spec, _trajectory_slice(cs, spec, X, U))
        worst = torch.minimum(m.amin(-2), torch.zeros_like(m[..., 0, :]))
        best = torch.maximum(best, worst.abs().amax(-1))
    return best


def max_soft_violation(cs: ConstraintSet, state, X, U):
    """(B,) max over soft limits and timesteps of the VIOLATION
    |min(margin, 0)| (ref: TrajoptConstraint.py:131-136,358-367, with the
    JAX package's fix: the reference takes abs(min(margin)), so a
    trajectory inside every bound reads as violating by its margin)."""
    return _max_violation(cs, cs.soft_limits, X, U)


def max_hard_violation(cs: ConstraintSet, X, U):
    """(B,) max over HARD limits and timesteps of |min(margin, 0)|, the
    instrument of SQPOptions.hard_violation_exit_tol."""
    return _max_violation(cs, cs.hard_limits, X, U)


def update_all_soft(cs: ConstraintSet, state, X, U):
    """Update every soft limit's hyperparameters; returns (state',
    all_at_max (B,)) (ref: TrajoptConstraint.py:369-378)."""
    new_states = []
    all_flag = torch.ones(X.shape[:-2], dtype=torch.bool, device=X.device)
    for spec, st in zip(cs.soft_limits, state):
        ns, flag = update_soft_state(spec, st,
                                     _trajectory_slice(cs, spec, X, U))
        new_states.append(ns)
        all_flag = all_flag & flag
    return tuple(new_states), all_flag


def shift_all_soft(cs: ConstraintSet, state, shift_steps: int):
    """(ref: TrajoptConstraint.py:380-387)."""
    return tuple(shift_soft_state(spec, st, shift_steps)
                 for spec, st in zip(cs.soft_limits, state))
