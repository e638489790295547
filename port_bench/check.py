"""The comparison that decides a run's ``correct``.

What the timed calls returned is judged against ``reference.py``, on the same
input tensors, after the window has closed:

* ``info_bad``: items, over every call of the window, whose ``info`` is not 0;
* ``eig_err``: max |w - w_ref| over the largest |eigenvalue| of the pencil, with
  w_ref the reference's eigenvalues il..iu;
* ``residual``: max over columns of ||A z - w B z|| / ((||A||_1 + |w| ||B||_1) ||z||);
* ``b_orth``: max |Z^H B Z - I|.

Each of a kept call's items is judged, a batch whole. A number passes when it is
at most its limit (a NaN never is); the limits are the cell's, set from readings
of the program and of its control (``control.py``) on the chip.
"""

from __future__ import annotations

import math

import torch

from port_bench import reference

NAMES = ("info_bad", "eig_err", "residual", "b_orth")
CHUNK = 16  # batch items the reference holds at once


def outputs(kind, out):
    """(w, z, info) of an entry's result tuple; planar z made complex."""
    if kind == "planar":
        w, zr, zi, info = out
        return w, torch.complex(zr, zi), info
    w, z, info = out
    return w, z, info


def result_shapes(kind, n, m, batch, device):
    """(shape, dtype, device) of each field of an entry's result."""
    lead = () if batch == 1 else (batch,)
    vectors = (lead + (n, m), "float64", device)
    fields = [vectors, vectors] if kind == "planar" else [vectors]
    return [(lead + (m,), "float64", device), *fields, (lead, "int32", device)]


def _chunks(problem, batched):
    if not batched:
        yield slice(None), problem
        return
    size = problem[0].shape[0]
    for lo in range(0, size, CHUNK):
        sl = slice(lo, lo + CHUNK)
        yield sl, tuple(t[sl] for t in problem)


def reference_eigvals(kind, problem, batched):
    """Every eigenvalue of each item of one problem, in blocks of items."""
    parts = [reference.eigvals(*reference.matrices(kind, part))
             for _, part in _chunks(problem, batched)]
    return parts[0] if not batched else torch.cat(parts)


def numbers(kind, problem, out, w_all, il, iu, batched):
    """eig_err, residual and b_orth of one call's result, the worst item's."""
    w, z, _ = outputs(kind, out)
    eig = res = orth = torch.zeros((), dtype=torch.float64, device=w.device)
    for sl, part in _chunks(problem, batched):
        a, b = reference.matrices(kind, part)
        wi, zi, ref = w[sl], z[sl], w_all[sl]
        scale = ref.abs().amax(-1, keepdim=True)
        eig = torch.maximum(eig, ((wi - ref[..., il - 1 : iu]).abs() / scale).amax())
        res = torch.maximum(res, reference.residuals(a, b, wi, zi).amax())
        orth = torch.maximum(orth, reference.b_orthonormality(b, zi))
    return {"eig_err": float(eig), "residual": float(res), "b_orth": float(orth)}


def worst(kind, pool, calls, il, iu, batched, limits):
    """The worst eig_err, residual and b_orth over ``calls``, (key, p, out)
    triples of an output ``out`` of problem ``pool[p]``, and the keys of the
    calls that fail a limit; the reference's eigenvalues once a problem."""
    ref, failed = {}, set()
    got = dict.fromkeys(NAMES[1:], 0.0)
    for key, p, out in calls:
        if p not in ref:
            ref[p] = reference_eigvals(kind, pool[p], batched)
        nums = numbers(kind, pool[p], out, ref[p], il, iu, batched)
        if not judge({**nums, "info_bad": 0.0}, limits)[0]:
            failed.add(key)
        for k, v in nums.items():
            if not v <= got[k] and not math.isnan(got[k]):  # a NaN stays
                got[k] = v
    return got, failed


def judge(values, limits):
    """(correct, rows): each number beside its limit, all of them at most it."""
    rows = [(name, values[name], limits[name]) for name in NAMES]
    return all(v <= lim for _, v, lim in rows), rows
