"""Plain reference of the generalised Hermitian-definite eigenproblem.

A x = lambda B x with B positive definite (LAPACK ITYPE=1), worked out again
from the benchmark's own inputs: the Cholesky factor B = L L^H, the standard
form C = L^-1 A L^-H and its eigenvalues, in the precision of the tensors given
(fp64 for the check). Plain PyTorch (``torch.linalg``); it imports nothing of
the program and takes nothing the program made.

Leading axes are a batch of problems throughout.
"""

from __future__ import annotations

import torch


def matrices(kind, problem):
    """(A, B) of one problem as the input generator made it: planar problems
    (A_re, A_im, B_re, B_im) become complex tensors, real ones stay."""
    if kind == "planar":
        ar, ai, br, bi = problem
        return torch.complex(ar, ai), torch.complex(br, bi)
    if kind == "real":
        a, b = problem
        return a, b
    raise ValueError(f"unknown input kind {kind!r}")


def standard_form(a, b):
    """(C, L): C = L^-1 A L^-H with B = L L^H, C made exactly Hermitian."""
    low = torch.linalg.cholesky(b)
    x = torch.linalg.solve_triangular(low, a, upper=False)  # L^-1 A
    c = torch.linalg.solve_triangular(low, x.mH, upper=False)  # L^-1 A^H L^-H
    return (c + c.mH) / 2, low


def eigvals(a, b):
    """Every eigenvalue of the pencil (A, B), ascending."""
    c, _ = standard_form(a, b)
    return torch.linalg.eigvalsh(c)


def eigh_range(a, b, il, iu):
    """(w, z): eigenpairs il..iu (1-based) of the pencil, z B-orthonormal."""
    c, low = standard_form(a, b)
    w, y = torch.linalg.eigh(c)
    y = y[..., il - 1 : iu]
    z = torch.linalg.solve_triangular(low.mH, y, upper=True)  # L^-H y
    return w[..., il - 1 : iu], z


def residuals(a, b, w, z):
    """Per column ||A z - w B z|| / ((||A||_1 + |w| ||B||_1) ||z||)."""
    az = a @ z
    bz = b @ z
    r = torch.linalg.vector_norm(az - bz * w[..., None, :], dim=-2)
    an = a.abs().sum(-2).amax(-1, keepdim=True)
    bn = b.abs().sum(-2).amax(-1, keepdim=True)
    return r / ((an + w.abs() * bn) * torch.linalg.vector_norm(z, dim=-2))


def b_orthonormality(b, z):
    """max |Z^H B Z - I|."""
    g = z.mH @ (b @ z)
    eye = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)
    return (g - eye).abs().amax()
