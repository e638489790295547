"""Random Hermitian-definite pairs in planar form, made on the device from the seed.

The construction of ``create_random_hermetian_pd`` (NVIDIA/Eigensolver_gpu,
test_driver/test_zhegvdx.F90): A = (T + T^H) / 2 and B = T2 T2^H / n + I, with T
and T2 of standard normal real and imaginary parts. Each problem is the four fp64
planes (A_re, A_im, B_re, B_im) that ``zhegvdx_planar`` takes, each (n, n), or
(batch, n, n) for a k-point batch. Plain PyTorch; nothing of the program.
"""

from __future__ import annotations

import torch

KIND = "planar"


def generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**64)
    return g


def make(n, batch, pool, seed, device):
    """``pool`` distinct problems drawn one after another from one generator."""
    g = generator(seed, device)
    shape = (n, n) if batch == 1 else (batch, n, n)
    eye = torch.eye(n, dtype=torch.float64, device=device)
    problems = []
    for _ in range(pool):
        tr, ti = torch.randn((2, *shape), generator=g, dtype=torch.float64, device=device)
        ar = (tr + tr.mT) / 2
        ai = (ti - ti.mT) / 2
        del tr, ti
        sr, si = torch.randn((2, *shape), generator=g, dtype=torch.float64, device=device)
        # T2 T2^H = (Sr + i Si)(Sr^T - i Si^T), made exactly Hermitian
        br = (sr @ sr.mT + si @ si.mT) / n
        bi = (si @ sr.mT - sr @ si.mT) / n
        del sr, si
        br = (br + br.mT) / 2 + eye
        bi = (bi - bi.mT) / 2
        problems.append((ar, ai, br, bi))
    return problems
