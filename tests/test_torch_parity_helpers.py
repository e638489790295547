"""The port's small helpers against their JAX twins, on the CPU: the planar
elementwise functions of ops/planar.py, utils/testing's compare_values,
std_residual and qe_style_pair, and utils/timer.wallclock.

The helpers do exact arithmetic on the same inputs, so they are held bit
for bit (the division to 1 ulp); batches (leading axes) item by item.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eigensolver_gpu_tpu.ops import planar as jax_planar
from eigensolver_gpu_tpu.utils import testing as jax_testing
from eigensolver_gpu_tpu.utils.timer import wallclock as jax_wallclock
from eigensolver_gpu_torch.ops import planar
from eigensolver_gpu_torch.utils import testing
from eigensolver_gpu_torch.utils.timer import wallclock

T = lambda x: torch.tensor(np.ascontiguousarray(x))


def _pairs(seed, shape=(24, 16)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    y = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    y[0, :3] = 0.0  # division by zero gives 0 in both
    return x, y


def _same(got, want, ulp=0):
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        if ulp:
            assert np.all(np.abs(g - w) <= ulp * np.spacing(np.abs(w)))
        else:
            assert np.array_equal(g, w)


@pytest.mark.parametrize("name", ["pconj", "pT", "pH", "padd", "psub", "pscale", "pdiv"])
def test_planar_helpers_match_jax(name):
    """Each helper on a (24, 16) planar pair (pscale with a complex
    scalar), against JAX's."""
    x, y = _pairs(1)
    px, py = (T(x.real), T(x.imag)), (T(y.real), T(y.imag))
    jx = (jnp.asarray(x.real), jnp.asarray(x.imag))
    jy = (jnp.asarray(y.real), jnp.asarray(y.imag))
    args, jargs = {
        "pconj": ((px,), (jx,)), "pT": ((px,), (jx,)), "pH": ((px,), (jx,)),
        "padd": ((px, py), (jx, jy)), "psub": ((px, py), (jx, jy)),
        "pscale": ((px, 0.75, -1.5), (jx, 0.75, -1.5)), "pdiv": ((px, py), (jx, jy)),
    }[name]
    _same(getattr(planar, name)(*args), getattr(jax_planar, name)(*jargs),
          ulp=1 if name == "pdiv" else 0)


def test_planar_helpers_take_a_batch():
    """A batch of 3 (leading axis) with one scalar an item for pscale: each
    item equal to its own call."""
    x, y = _pairs(2, (3, 8, 5))
    px, py = (T(x.real), T(x.imag)), (T(y.real), T(y.imag))
    sr = torch.tensor([0.5, -2.0, 3.0])[:, None, None].double()
    si = torch.tensor([1.0, 0.0, -0.25])[:, None, None].double()
    for k in range(3):
        item = lambda p: (p[0][k], p[1][k])
        for fn, args, one in (
            (planar.pT, (px,), (item(px),)),
            (planar.pH, (px,), (item(px),)),
            (planar.pdiv, (px, py), (item(px), item(py))),
            (planar.pscale, (px, sr, si), (item(px), float(sr[k]), float(si[k]))),
        ):
            got = fn(*args)
            want = fn(*one)
            assert torch.equal(got[0][k], want[0]) and torch.equal(got[1][k], want[1])


def test_to_and_from_planar_match_jax():
    """to_planar of a complex array (and of a real one: zero imaginary
    plane), from_planar back: the JAX planes and the same complex array."""
    x, _ = _pairs(3)
    pr, pi = planar.to_planar(x)
    jr, ji = jax_planar.to_planar(x)
    assert pr.dtype == torch.float64 and pr.is_contiguous() and pi.is_contiguous()
    assert np.array_equal(pr.numpy(), np.asarray(jr)) and np.array_equal(pi.numpy(), np.asarray(ji))
    assert np.array_equal(planar.from_planar((pr, pi)), jax_planar.from_planar((jr, ji)))
    assert np.array_equal(planar.from_planar((pr, pi)), x)
    xr = x.real.astype(np.float32)
    pr, pi = planar.to_planar(torch.tensor(xr))
    jr, ji = jax_planar.to_planar(xr)
    assert pr.dtype == torch.float32 and np.array_equal(pi.numpy(), np.asarray(ji))
    assert np.array_equal(pr.numpy(), np.asarray(jr))


def test_compare_values_and_std_residual_match_jax():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((32, 32))
    a = (a + a.T) / 2
    w, z = np.linalg.eigh(a)
    w_pert = w + 1e-9 * rng.standard_normal(32)
    assert testing.compare_values(w_pert, w) == jax_testing.compare_values(w_pert, w)
    assert testing.compare_values(np.zeros(3), np.zeros(3)) == 0.0
    for ww in (w, w_pert):
        assert testing.std_residual(a, ww, z) == jax_testing.std_residual(a, ww, z)
    assert testing.std_residual(a, w, z) < 1e-15


@pytest.mark.parametrize("dtype", [np.complex128, np.float64])
def test_qe_style_pair_takes_decay_and_matches_jax(dtype):
    """One call with ``decay`` drives both packages: the same arrays."""
    a, b = testing.qe_style_pair(48, seed=5, dtype=dtype, decay=0.25)
    ja, jb = jax_testing.qe_style_pair(48, seed=5, dtype=dtype, decay=0.25)
    assert np.array_equal(a, ja) and np.array_equal(b, jb)
    a0, _ = testing.qe_style_pair(48, seed=5, dtype=dtype)
    assert np.array_equal(a, a0)  # decay is accepted and not read, as in JAX


def test_wallclock_is_the_monotonic_clock_of_the_jax_twin():
    """Seconds, monotonic, on the clock of JAX's wallclock (CLOCK_MONOTONIC):
    readings taken together agree within a second."""
    t0 = wallclock()
    j = jax_wallclock()
    t1 = wallclock()
    assert t1 >= t0 and abs(j - t0) < 1.0
