"""reference.py and the input generators, on the CPU."""

import numpy as np
import pytest
import torch

from port_bench import reference, spec

GENERATORS = ["hpd_planar", "spd_real"]


def _standard_form_np(a, b):
    low = np.linalg.cholesky(b)
    x = np.linalg.solve(low, a)
    c = np.linalg.solve(low, x.conj().T)
    return (c + c.conj().T) / 2


@pytest.mark.parametrize("gen", GENERATORS)
@pytest.mark.parametrize("n", [17, 64, 128])
def test_reference_matches_numpy(gen, n):
    mod = spec.module("inputs", gen)
    (problem,) = mod.make(n, 1, 1, 2**31 + 11, "cpu")
    a, b = reference.matrices(mod.KIND, problem)
    want = np.linalg.eigh(_standard_form_np(a.numpy(), b.numpy()))[0]
    got = reference.eigvals(a, b).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    w, z = reference.eigh_range(a, b, 2, n // 2)
    assert np.abs(w.numpy() - want[1 : n // 2]).max() <= 1e-12 * np.abs(want).max()
    assert float(reference.residuals(a, b, w, z).max()) < 1e-15
    assert float(reference.b_orthonormality(b, z)) < 1e-12


@pytest.mark.parametrize("gen", GENERATORS)
def test_generator_seeded_and_pool_distinct(gen):
    mod = spec.module("inputs", gen)
    one = mod.make(32, 3, 3, 3_000_000_019, "cpu")
    again = mod.make(32, 3, 3, 3_000_000_019, "cpu")
    other = mod.make(32, 3, 3, 3_000_000_021, "cpu")
    assert len(one) == 3
    for p, q, r in zip(one, again, other):
        assert all(torch.equal(x, y) for x, y in zip(p, q))
        assert not any(torch.equal(x, y) for x, y in zip(p, r))
    for i in range(3):
        for j in range(i):
            assert not any(torch.equal(x, y) for x, y in zip(one[i], one[j]))
    for t in one[0]:
        assert t.shape == (3, 32, 32) and t.dtype == torch.float64
        assert not torch.equal(t[0], t[1])  # the items of a batch differ too


@pytest.mark.parametrize("gen", GENERATORS)
def test_generator_pairs_hermitian_definite(gen):
    mod = spec.module("inputs", gen)
    (problem,) = mod.make(48, 1, 1, 5, "cpu")
    a, b = reference.matrices(mod.KIND, problem)
    assert torch.equal(a, a.mH) and torch.equal(b, b.mH)
    assert float(torch.linalg.eigvalsh(b).min()) >= 1.0 - 1e-12
