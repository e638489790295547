"""Random symmetric-definite pairs, made on the device from the seed.

The construction of ``create_random_symmetric_pd`` (NVIDIA/Eigensolver_gpu,
test_driver/test_dsygvdx.F90): A = (T + T^T) / 2 and B = T2 T2^T / n + I, with T
and T2 standard normal. Each problem is the pair (A, B) of fp64 tensors that
``sygvdx`` takes, each (n, n), or (batch, n, n) for a k-point batch. Plain
PyTorch; nothing of the program.
"""

from __future__ import annotations

import torch

KIND = "real"


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
        t = torch.randn(shape, generator=g, dtype=torch.float64, device=device)
        a = (t + t.mT) / 2
        del t
        s = torch.randn(shape, generator=g, dtype=torch.float64, device=device)
        b = s @ s.mT / n
        del s
        b = (b + b.mT) / 2 + eye
        problems.append((a, b))
    return problems
