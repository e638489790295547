"""The dependency rule of the bulge chase's wavefront schedule, on which the
persistent chase kernels (K7, eigensolver_gpu_torch/csrc/chase.cu, and K8,
csrc/chase_planar.cu) rely.

Each kernel runs every timestep in one launch: slot s starts timestep t
once slots s - 1 and s + 1 have finished t - 1 (and its own block has
finished s at t - 1), inactive slots included. By induction slot s at t
then starts only after every slot s' has finished every timestep t' with
|s' - s| <= t - t'. These tests enumerate, from the plain chase's own
window formula (ops/sb2st.bulge_chase: the strip rows
``vmax + 1 + k0 b - b + s (3b - 1) + [0, 2b)`` of lower band storage, the
whole strip read and the entries with ``q + d < 3b`` written back), the
band entries that each active (t, s) reads and writes, and check that

* no two windows of one timestep share an entry;
* two windows at t - 1 and t that share an entry, one of them writing it,
  are at most one slot apart (and both neighbours occur);
* any two windows that share an entry, one of them writing it, at any
  distance in time, satisfy |s' - s| <= t - t' (the cone the waits give).

Pure integer work on numpy arrays.
"""

import numpy as np
import pytest

from eigensolver_gpu_torch.ops.sb2st import chase_dims


def _accesses(n, b):
    """Per timestep t: (t, reads, writes), each an (entries, slots) pair of
    flat band indices j * 2b + d and the active slot that touches them."""
    s_slots, t_total, _ = chase_dims(n, b)
    w, stride = 2 * b, 3 * b - 1
    s = np.arange(s_slots)
    q = np.arange(w)[:, None]
    d = np.arange(w)[None, :]
    in_win = np.broadcast_to(q + d < 3 * b, (w, w))
    for t in range(t_total):
        vmax, k0 = divmod(t, 3)
        v = vmax - s
        r0 = v + 1 + (k0 + 3 * s) * b
        act = s[(v >= 0) & (v <= n - 3) & (r0 <= n - 2)]
        j = (vmax + 1 + k0 * b - b + act * stride)[:, None, None] + q[None]  # (S, 2b, 1)
        inside = np.broadcast_to((j >= 0) & (j < n), (len(act), w, w))
        flat = np.broadcast_to(j * w + d[None], (len(act), w, w))
        slot = np.broadcast_to(act[:, None, None], (len(act), w, w))
        wmask = inside & in_win[None]
        yield t, (flat[inside], slot[inside]), (flat[wmask], slot[wmask])


def _owners(n, b, entries, slots):
    out = np.full(n * 2 * b, -1)
    out[entries] = slots
    return out


CASES = [(2, 97), (2, 300), (3, 150), (4, 300), (6, 200), (32, 300)]


@pytest.mark.parametrize("b,n", CASES)
def test_windows_of_one_timestep_are_disjoint(b, n):
    for _, (r_e, _), _ in _accesses(n, b):
        assert np.bincount(r_e, minlength=n * 2 * b).max(initial=0) <= 1


@pytest.mark.parametrize("b,n", CASES)
def test_a_window_depends_only_on_its_neighbours_one_timestep_back(b, n):
    seen = set()
    prev = None
    for t, (r_e, r_s), (w_e, w_s) in _accesses(n, b):
        reads, writes = _owners(n, b, r_e, r_s), _owners(n, b, w_e, w_s)
        if prev is not None:
            p_reads, p_writes = prev
            for before, after in ((p_writes, reads), (p_reads, writes)):
                both = (before >= 0) & (after >= 0)
                gap = before[both] - after[both]
                assert np.abs(gap).max(initial=0) <= 1, f"t={t}: slots {set(gap.tolist())} apart"
                seen.update(gap.tolist())
        prev = (reads, writes)
    # both neighbours matter: slot s at t meets s - 1 and s + 1 at t - 1
    s_slots = chase_dims(n, b)[0]
    if s_slots > 1:
        assert {-1, 1} <= seen


@pytest.mark.parametrize("b,n", CASES)
def test_every_conflict_lies_inside_the_cone_of_the_waits(b, n):
    """Against the last write of each entry and the reads since it: a
    conflict between (t', s') and a later (t, s) needs |s - s'| <= t - t',
    i.e. s' + t' <= s + t and s' - t' >= s - t. Older accesses follow by
    transitivity of the cone."""
    size = n * 2 * b
    big = 1 << 40
    w_plus = np.full(size, -big)  # s + t of the last write
    w_minus = np.full(size, big)  # s - t of the last write
    r_plus = np.full(size, -big)  # max s + t over the reads since it
    r_minus = np.full(size, big)  # min s - t over the reads since it
    conflicts = 0
    for t, (r_e, r_s), (w_e, w_s) in _accesses(n, b):
        # every access against the last write (writes are reads too)
        assert np.all(w_plus[r_e] <= r_s + t) and np.all(w_minus[r_e] >= r_s - t), f"t={t}"
        conflicts += int(np.count_nonzero(w_plus[r_e] > -big))
        # every write against the reads since the last write
        assert np.all(r_plus[w_e] <= w_s + t) and np.all(r_minus[w_e] >= w_s - t), f"t={t}"
        np.maximum.at(r_plus, r_e, r_s + t)
        np.minimum.at(r_minus, r_e, r_s - t)
        w_plus[w_e], w_minus[w_e] = w_s + t, w_s - t
        r_plus[w_e], r_minus[w_e] = -big, big
    assert conflicts > 0

