"""The Schur system S lam = gam by PCG with the symmetric-stair (SS)
preconditioner, in plain PyTorch on the dense S.

As the reference's upstream defines it (A2R-Lab/TrajoptMPCReference,
GBD-PCG-Python PCG.py:66-111 and :168-212) and the port's
``btridiag.pcg`` runs it: the block-tridiagonal blocks D_k (diagonal) and
O_k = S[k, k+1] are read out of the dense S; the preconditioner has the
block-Jacobi inverses inv(D_k) on its diagonal and the pair
-inv(D_k) O_k inv(D_{k+1}) and its transpose off it; nu = r' Pinv r, and a
scenario stops once |nu| <= tol |nu_0| (with a floor of 1e-30) or after
``iters`` iterations, and keeps its iterate from then on.  The iteration
starts from ``guess``.

Each matrix-vector product is a dense one: S and Pinv as whole
(N bs)^2 matrices, no block structure exploited.

Departures from the port (``ops/fused_pcg``, K4 and its plain version):
the port packs each diagonal block and its inverse as a lower triangle
(read back symmetric) and inverts the blocks by its own batched solve,
where this inverts them by ``torch.linalg.inv``; the port solves for the
step dx from zero against r0 = gam - S guess and returns guess + dx, where
this iterates on lam from the guess; the port stops all scenarios' loop on
one host check per iteration, as this does.  Each is a difference of
rounding only.
"""

from __future__ import annotations

import torch


def stair_inverse(S: torch.Tensor, N: int, bs: int) -> torch.Tensor:
    """The SS preconditioner of the dense S (B, N bs, N bs), dense."""
    B = S.shape[0]
    Sv = S.view(B, N, bs, N, bs)
    ks = torch.arange(N, device=S.device)
    Dinv = torch.linalg.inv(Sv[:, ks, :, ks, :].transpose(0, 1))   # (B, N, bs, bs)
    O = Sv[:, ks[:-1], :, ks[1:], :].transpose(0, 1)               # (B, N-1, bs, bs)
    off = -Dinv[:, :-1] @ O @ Dinv[:, 1:]
    P = torch.zeros_like(S)
    Pv = P.view(B, N, bs, N, bs)
    Pv[:, ks, :, ks, :] = Dinv.transpose(0, 1)
    Pv[:, ks[:-1], :, ks[1:], :] = off.transpose(0, 1)
    Pv[:, ks[1:], :, ks[:-1], :] = off.transpose(-1, -2).transpose(0, 1)
    return P


def solve(S: torch.Tensor, gam: torch.Tensor, guess: torch.Tensor, N: int,
          bs: int, iters: int, tol: float) -> torch.Tensor:
    """lam (B, N bs) from S (B, N bs, N bs), gam and guess (B, N bs)."""
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    dot = lambda a, b: (a * b).sum(-1)
    P = stair_inverse(S, N, bs)
    x = guess
    r = gam - mv(S, x)
    s = mv(P, r)
    p = s
    nu = dot(r, s)
    thr = (tol * nu.abs()).clamp(min=1e-30)
    done = nu.abs() <= thr
    for _ in range(iters):
        if bool(done.all()):
            break
        Ap = mv(S, p)
        pAp = dot(p, Ap)
        alpha = (nu / torch.where(pAp != 0, pAp, torch.ones_like(pAp)))[:, None]
        x_new, r_new = x + alpha * p, r - alpha * Ap
        s = mv(P, r_new)
        nu_new = dot(r_new, s)
        p_new = s + (nu_new / nu)[:, None] * p
        keep = done[:, None]
        x = torch.where(keep, x, x_new)
        r = torch.where(keep, r, r_new)
        p = torch.where(keep, p, p_new)
        nu = torch.where(done, nu, nu_new)
        done = done | (nu_new.abs() <= thr)
    return x
