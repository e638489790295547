"""Cholesky factorization of the metric matrix B (twin of
eigensolver_gpu_tpu/ops/cholesky.py).

The reference's drivers call cuSOLVER potrf with the upper fill mode to
get ``B = U^H U`` (dsygvdx_gpu.F90:121, zhegvdx_gpu.F90:135). The JAX
package calls XLA's Cholesky (no Pallas kernel on this stage); the port
calls ``torch.linalg.cholesky_ex``, which produces the lower factor
``L`` with ``B = L L^H``, so ``U = L^H``.

Positive-definiteness is reported as cuSOLVER's ``devInfo`` does: an
``info`` tensor on the device, never an exception and never a host
round trip.
"""

from __future__ import annotations

import torch


def cholesky_upper(b):
    """Upper Cholesky factor ``U`` with ``B = U^H @ U``.

    Returns (u, info): ``u`` upper triangular; ``info`` an int32 0-d
    tensor, 0 on success, else the 1-based index of the first row whose
    pivot is invalid (non-positive or NaN diagonal, or a non-finite entry
    in the row) -- the LAPACK/cuSOLVER devInfo convention. When info > 0
    the factor is undefined, as in LAPACK. Leading axes of ``b`` are a
    batch of problems: ``info`` then has one entry an item."""
    l, info = torch.linalg.cholesky_ex(b, upper=False, check_errors=False)
    u = l.mH.resolve_conj()
    # potrf reports the first non-positive pivot; the scan below also
    # catches a factor poisoned by NaN/Inf input, as the JAX function does
    row_bad = ~torch.isfinite(u).all(-1) | ~(torch.diagonal(u, dim1=-2, dim2=-1).real > 0)
    first = torch.argmax(row_bad.to(torch.int32), dim=-1).to(torch.int32) + 1
    scanned = torch.where(row_bad.any(-1), first, torch.zeros_like(first))
    info = info.to(torch.int32)
    return u, torch.where(info > 0, info, scanned)
