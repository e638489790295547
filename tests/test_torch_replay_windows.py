"""The compact window stores of the replays (kernels K9 and K10,
eigensolver_gpu_torch/ops/replay.py: ``window_table``, ``window_store``,
``window_store_planar`` and the JAX-layout ``window_qs`` and
``window_qs_planar`` made from them), on the CPU.

The table must list exactly the valid slots of the wave schedule
(``_wave_gather``), wave after wave and slots ascending, with each window's
first row; the store must hold, window for window, the unitaries that the
JAX ``window_qs_planar`` puts in those slots; and the scattered JAX layout
must hold the identity in every other slot. The same numpy inputs go
through both packages, in fp32, the kernel's working type. The real
layout, scattered from its store, is held bit for bit against the
all-slots form it replaced, in fp32 and fp64.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigensolver_gpu_tpu.ops.replay_pallas import window_qs as jax_window_qs
from eigensolver_gpu_tpu.ops.replay_pallas import window_qs_planar as jax_window_qs_planar
from eigensolver_gpu_torch.ops import replay as t_replay
from eigensolver_gpu_torch.ops import sb2st as t_sb2st
from eigensolver_gpu_torch.utils.convert import chase_from_numpy, planar_chase_from_numpy

j_sb2st = importlib.import_module("eigensolver_gpu_tpu.ops.sb2st")
j_sb2st_planar = importlib.import_module("eigensolver_gpu_tpu.ops.sb2st_planar")

torch.set_num_threads(2)

# (n, b, g): the main path's shape, g = b (the pure-fp64 path), l_win = 128,
# small and odd shapes
TABLE_CASES = [(4096, 32, 96), (4096, 32, 32), (1024, 32, 32), (400, 32, 97), (300, 8, 24),
               (250, 6, 5), (1000, 24, 24), (3, 2, 1), (37, 4, 9)]
STORE_CASES = [(128, 8, 24), (96, 8, 8), (120, 8, 16), (160, 16, 113)]


@pytest.mark.parametrize("n,b,g", TABLE_CASES)
def test_window_table_lists_the_valid_slots_in_replay_order(n, b, g):
    """The table's windows are the valid (wave, slot) pairs of
    ``_wave_gather``, wave after wave and slots ascending; ``wave_ptr``
    delimits the waves; each window starts at row a0 + 1 = j g + k b + 1 of
    its (j, k), lies inside the matrix and is disjoint from the other
    windows of its wave; its reflector rows are ``_wave_gather``'s."""
    geo = t_replay._geometry(n, b, g)
    valid, ridx = t_replay._wave_gather(geo, n, b, g, geo["n_groups"] * g + g, geo["kmax"] + 2)
    table = t_replay.window_table(n, b, g)
    assert np.array_equal(table["valid"], valid)
    wave, slot = np.nonzero(valid)
    assert np.array_equal(table["wave"], wave) and np.array_equal(table["slot"], slot)
    ptr = table["wave_ptr"]
    assert ptr.shape == (geo["n_waves"] + 1,) and ptr[0] == 0 and ptr[-1] == len(wave)
    for w in range(geo["n_waves"]):
        assert np.array_equal(table["slot"][ptr[w] : ptr[w + 1]], np.nonzero(valid[w])[0])
    u = geo["u_lo"][wave] + slot
    j, k = geo["c0"][wave] + u, geo["par"][wave] + 2 * u
    assert np.array_equal(table["row0"], j * g + k * b + 1)
    assert (table["row0"] >= 1).all() and (table["row0"] <= n - 2).all()
    for w in range(geo["n_waves"]):
        r = table["row0"][ptr[w] : ptr[w + 1]]
        assert (np.diff(r) >= geo["l_win"]).all()
    assert np.array_equal(table["ridx"], ridx[wave, slot])


def _jax_windows(n, b, g):
    """fp32 reflectors of a random Hermitian band matrix from the JAX chase,
    the JAX window layout, and the port's carriers of the reflectors."""
    rng = np.random.default_rng(n + b + g)
    t = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    a = (t + t.conj().T) / 2
    a[np.abs(np.subtract.outer(np.arange(n), np.arange(n))) > b] = 0
    a = a.astype(np.complex64)
    band = [j_sb2st.dense_to_band(jnp.asarray(x.copy(), jnp.float32), b) for x in (a.real, a.imag)]
    d, e, vt, taut = j_sb2st_planar.bulge_chase_planar(*band, b)
    want = np.asarray(jax_window_qs_planar(vt, taut, n, b, g))
    pair = lambda x: (np.asarray(x[0]), np.asarray(x[1]))  # noqa: E731
    _, _, tvt, ttaut = planar_chase_from_numpy(np.asarray(d), pair(e), pair(vt), pair(taut),
                                               n, b, device="cpu")
    return want, tvt, ttaut


@pytest.mark.parametrize("n,b,g", STORE_CASES)
def test_window_store_planar_matches_jax_slot_for_slot(n, b, g):
    """Window v of the compact store is the JAX [Q_r | Q_i] block of slot
    (wave[v], slot[v]) to fp32 round-off (1e-5, the tolerance of the JAX
    layout's own test), identity tail included; the store holds the valid
    windows only."""
    want, tvt, ttaut = _jax_windows(n, b, g)
    store, table = t_replay.window_store_planar(tvt, ttaut, n, b, g)
    n_valid = int(table["valid"].sum())
    assert store.dtype == torch.float32 and store.is_contiguous()
    assert store.shape == (2, n_valid, 128, 128) and n_valid < table["valid"].size
    got = torch.cat([store[0], store[1]], dim=-1).numpy()
    assert np.abs(got - want[table["wave"], table["slot"]]).max() < 1e-5


@pytest.mark.parametrize("n,b,g", STORE_CASES)
def test_window_qs_planar_scatters_the_store_into_identity_slots(n, b, g):
    """The JAX layout is the compact store scattered: each valid slot holds
    its window of the store exactly, and every invalid slot holds Q_r = I,
    Q_i = 0 exactly."""
    _, tvt, ttaut = _jax_windows(n, b, g)
    store, table = t_replay.window_store_planar(tvt, ttaut, n, b, g)
    qw = t_replay.window_qs_planar(tvt, ttaut, n, b, g)
    valid = table["valid"]
    assert torch.equal(qw[:, table["wave"], table["slot"]], store)
    idle = torch.from_numpy(~valid)
    assert int(idle.sum()) > 0
    assert torch.equal(qw[0][idle], torch.eye(128).expand(int(idle.sum()), 128, 128))
    assert not qw[1][idle].any()


def _jax_real_windows(n, b, g, dtype=np.float32):
    """Reflectors of a random symmetric band matrix from the JAX chase, the
    JAX window layout, and the port's carriers of the reflectors."""
    rng = np.random.default_rng(n + b + g + 1)
    t = rng.standard_normal((n, n))
    a = (t + t.T) / 2
    a[np.abs(np.subtract.outer(np.arange(n), np.arange(n))) > b] = 0
    band = j_sb2st.dense_to_band(jnp.asarray(a.astype(dtype)), b)
    d, e, vt, taut = (np.asarray(x) for x in j_sb2st.bulge_chase(band, b))
    want = np.asarray(jax_window_qs(jnp.asarray(vt), jnp.asarray(taut), n, b, g))
    _, _, tvt, ttaut = chase_from_numpy(d, e, vt, taut, n, b, device="cpu")
    return want, tvt, ttaut


def _all_slots_window_qs(vt, taut, n, b, g):
    """The JAX layout formed slot for slot, 8 waves at a time, as the real
    window pass did before it formed the valid windows only."""
    geo = t_replay._geometry(n, b, g)
    l_win, n_waves, n_slots = geo["l_win"], geo["n_waves"], geo["n_slots"]
    v2f, t2f, nvp, kp = t_sb2st._padded_pack(vt, taut, b, n, g, geo["n_groups"], geo["kmax"])
    _, flat_idx = t_replay._wave_gather(geo, n, b, g, nvp, kp)
    flat_idx = torch.from_numpy(flat_idx)
    qw = torch.zeros((n_waves, n_slots, 128, 128), dtype=vt.dtype)
    tail = torch.arange(l_win, 128)
    qw[:, :, tail, tail] = 1.0
    for w0 in range(0, n_waves, 8):
        idx = flat_idx[w0 : w0 + 8]
        taus = t2f[idx]
        qw[w0 : w0 + 8, :, :l_win, :l_win] = t_sb2st.window_q(
            t_sb2st._staircase(v2f[idx], taus, g, b), taus)
    return qw


@pytest.mark.parametrize("n,b,g", STORE_CASES)
def test_window_store_matches_jax_at_the_valid_slots(n, b, g):
    """Window v of the real compact store is the JAX window of slot
    (wave[v], slot[v]), in ``window_table`` order, to fp32 round-off (1e-5,
    the tolerance of the JAX layout's own test), identity tail included; the
    store holds the valid windows only."""
    want, tvt, ttaut = _jax_real_windows(n, b, g)
    store, table = t_replay.window_store(tvt, ttaut, n, b, g)
    n_valid = int(table["valid"].sum())
    assert store.dtype == torch.float32 and store.is_contiguous()
    assert store.shape == (n_valid, 128, 128) and n_valid < table["valid"].size
    assert np.abs(store.numpy() - want[table["wave"], table["slot"]]).max() < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,b,g", [(128, 8, 24), (120, 8, 16)])
def test_window_qs_is_the_all_slots_form_bit_for_bit(n, b, g, dtype):
    """The real JAX layout scattered from the compact store holds the same
    bits as the all-slots form, in every slot, valid or not."""
    _, tvt, ttaut = _jax_real_windows(n, b, g, np.float64)
    tvt, ttaut = tvt.to(dtype), ttaut.to(dtype)
    got = t_replay.window_qs(tvt, ttaut, n, b, g)
    want = _all_slots_window_qs(tvt, ttaut, n, b, g)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
