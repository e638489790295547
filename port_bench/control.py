"""The control of the check: the reference put in the program's place, one precision down.

The configurations state fp64 inputs and fp64 results, so the control computes
``reference.eigh_range`` in fp32 (complex64 for planar problems), with TF32 off
so that it is fp32 and not lower, and hands back its result in the program's
form and type: (w, zr, zi, info) for a planar entry, (w, z, info) for a real
one. ``calibrate.py`` runs it at each cell's size on the chip; the check has to
call it not correct.
"""

from __future__ import annotations

import torch

from port_bench import reference


def entry(kind):
    """A callable with the program entry's signature that solves in fp32."""

    def solve(*problem, il=1, iu=None, cfg=None):
        a, b = reference.matrices(kind, problem)
        low = torch.complex64 if a.is_complex() else torch.float32
        matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            w, z = reference.eigh_range(a.to(low), b.to(low), il, iu or a.shape[-1])
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
        info = torch.zeros(a.shape[:-2], dtype=torch.int32, device=a.device)
        w = w.double()
        if kind == "planar":
            z = z.to(torch.complex128)
            return w, z.real.contiguous(), z.imag.contiguous(), info
        return w, z.double(), info

    return solve
