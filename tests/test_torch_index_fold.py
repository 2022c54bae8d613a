"""``qsfh_torch.engine.state.IndexFold``: the per-index sum that replaces
``index_add_`` in the adjoint gradient, the ADAPT pool screen and the
correlation entries (``index_add_`` adds with atomics on the card, so its
last bits change from call to call).

On the CPU: the fold against ``index_add_`` within 1e-14 relative in
float64 (repeated, missing and dropped indices), equal bits on two calls,
and the three users' results against ``index_add_`` over the same
per-term values.  The same bits on the card: ``tests/test_torch_gpu.py::
test_index_fold_same_bits_on_card``.
"""

import numpy as np
import pytest
import torch

from qsfh_torch.engine.state import IndexFold

TOL = 1e-14


def _index_add(idx, size, values):
    keep = torch.as_tensor(np.asarray(idx) < size)
    out = torch.zeros(size, dtype=values.dtype)
    return out.index_add_(0, torch.as_tensor(np.asarray(idx))[keep], values[keep])


@pytest.mark.parametrize("size,T,hi", [(1, 5, 1), (7, 40, 7), (30, 500, 33), (5, 3, 9)])
def test_fold_matches_index_add(size, T, hi):
    rng = np.random.default_rng(size * 1000 + T)
    idx = rng.integers(0, hi, size=T)  # hi > size: some values are dropped
    values = torch.as_tensor(rng.standard_normal(T))
    fold = IndexFold(idx, size)
    got = fold(values)
    ref = _index_add(idx, size, values)
    assert got.shape == (size,)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=TOL, atol=TOL)
    assert torch.equal(got, fold(values))


def test_fold_empty_rows_and_layout():
    """An index with no values sums to 0; the slots are distinct, the
    width is the largest count and each dropped value has a slot of its
    own past the rows."""
    idx = np.array([3, 0, 3, 5, 3, 0])
    fold = IndexFold(idx, 4)
    assert fold.width == 3 and fold.n_slots == 4 * 3 + 1
    assert len(set(fold.slot.tolist())) == len(idx)
    got = fold(torch.arange(1.0, 7.0, dtype=torch.float64))
    np.testing.assert_array_equal(got.numpy(), [2.0 + 6.0, 0.0, 0.0, 1.0 + 3.0 + 5.0])
    with pytest.raises(ValueError):
        IndexFold(np.array([0, -1]), 2)


def test_rot_adjoint_gradient_fold():
    """``run_rot_adjoint``'s gradient against ``index_add_`` of its own
    per-term contributions (shared and static parameters)."""
    from qsfh_torch.engine import compiled as tc
    from qsfh_torch.engine import kernels as K

    rng = np.random.default_rng(3)
    n, n_params = 10, 4
    ops = []
    for _ in range(14):
        terms = tuple((int(rng.integers(0, 1 << n)), int(rng.integers(0, 1 << n)),
                       float(rng.uniform(-1, 1))) for _ in range(int(rng.integers(1, 4))))
        ops.append(("rot", terms, int(rng.integers(-1, n_params))))
    (seg,) = tc.CompiledCircuit(ops, n).segments
    psi = torch.as_tensor(rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n))
    lam = torch.as_tensor(rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n))
    th = torch.as_tensor(rng.uniform(-1, 1, n_params))
    _, _, grads = tc.run_rot_adjoint(seg, psi, lam, th, n)

    d = seg.tensors(psi.device, torch.float64, n_params)
    angles = torch.cat([th, th.new_ones(1)])[d["pidx"]] * d["scale"]
    arrs = tuple(a.flip(0) for a in (d["xb"], d["zb"], angles, d["phre"], d["phim"]))
    v = K.adjoint_rotation_plain(psi.clone(), lam.clone(), *arrs)
    contribs = d["scale"].flip(0) * v.imag
    ref = torch.zeros(n_params + 1, dtype=torch.float64).index_add_(0, d["pidx"].flip(0), contribs)
    np.testing.assert_allclose(grads.numpy(), ref[:n_params].numpy(), rtol=1e-12, atol=1e-13)


def test_pool_screen_and_correlation_folds():
    """``PackedPool.screen_scan`` and ``EntryTerms.values`` against
    ``index_add_`` over the same per-term values (2x2, 8 qubits)."""
    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine.expectation import PackedPool
    from qsfh_torch.ops import correlations as C
    from qsfh_torch.ops.jw import jordan_wigner
    from qsfh_torch.ops.pool import hubbard_interaction_pool_simplified

    rng = np.random.default_rng(4)
    pool = PackedPool([jordan_wigner(g) for g in hubbard_interaction_pool_simplified(2, 2)], 8)
    n = pool.n
    psi = torch.as_tensor(rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n))
    w = torch.as_tensor(rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n))
    xs, zs, c = pool._tensors(psi)[:3]
    contribs = 2.0 * (c * K.pauli_inner_plain(w, psi, xs, zs).to(psi.dtype)).imag
    ks = torch.as_tensor(pool.scan_arrays()[4].astype(np.int64))
    ref = torch.zeros(pool.size, dtype=torch.float64).index_add_(0, ks, contribs)
    np.testing.assert_allclose(pool.screen_scan(psi, w).numpy(), ref.numpy(),
                               rtol=1e-12, atol=1e-13)

    entries = C.spin_entries(4)
    psi = psi / torch.linalg.vector_norm(psi)
    _, _, cc = C._device_terms(entries._cache, entries.arrays, psi)
    vals = (cc * entries.term_values(psi).to(psi.dtype)).real
    ref = torch.zeros(entries.n_entries, dtype=torch.float64).index_add_(
        0, torch.as_tensor(entries.entry), vals)
    np.testing.assert_allclose(entries.values(psi).numpy(), ref.numpy(), rtol=1e-12, atol=1e-13)
