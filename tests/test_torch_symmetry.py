"""The port's lattice symmetry analysis (``qsfh_torch/linalg/symmetry.py``)
against the JAX module (complex128, CPU), tolerance 1e-10.

* Site maps: the 3x3 rotation and reflection tables (the reference's hand
  tables) and the translations, equal to JAX's; ``mode_permutation``.
* ``permute_modes``, signed and unsigned, on sparse and dense seeded
  states at 2x2 and 2x3 (torch int64 occupancy), equal to JAX's; the
  signed maps commute with H at 2x2 and 2x3, the unsigned one does not.
* The C4 components, the symmetry-adapted states and norms, the irrep and
  momentum weights and the momentum projection, equal to JAX's; the
  symmetry-adapted ground space on the port's ED at 2x2.
"""

import numpy as np
import pytest
import torch

from qsfh_tpu.linalg import exact as jax_exact
from qsfh_tpu.linalg import symmetry as J
from qsfh_tpu.ops.lattice import fermi_hubbard as jax_fermi_hubbard
from qsfh_torch.linalg import exact
from qsfh_torch.linalg import symmetry as T
from qsfh_torch.ops.lattice import fermi_hubbard

TOL = 1e-10


def _state(n, seed, sparsity=0.0):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    v[rng.random(1 << n) < sparsity] = 0.0
    return v / np.linalg.norm(v)


def test_site_maps_equal_jax():
    # the reference's 3x3 mode tables (rot90, reflections x and y)
    tables = {
        "rot": [0, 1, 12, 13, 6, 7, 2, 3, 14, 15, 8, 9, 4, 5, 16, 17, 10, 11],
        "x": [0, 1, 2, 3, 4, 5, 12, 13, 14, 15, 16, 17, 6, 7, 8, 9, 10, 11],
        "y": [0, 1, 4, 5, 2, 3, 6, 7, 10, 11, 8, 9, 12, 13, 16, 17, 14, 15],
    }
    assert T.mode_permutation(T.rot90_site_map(3, 3)).tolist() == tables["rot"]
    for axis in ("x", "y"):
        assert T.mode_permutation(T.reflect_site_map(3, 3, axis)).tolist() == tables[axis]
    for nx, ny in [(3, 3), (2, 3), (4, 4)]:
        for axis in ("x", "y"):
            assert T.reflect_site_map(nx, ny, axis) == J.reflect_site_map(nx, ny, axis)
        for d in [(1, 0), (0, 1), (1, 2)]:
            assert T.translation_site_map(nx, ny, *d) == J.translation_site_map(nx, ny, *d)
        m = T.translation_site_map(nx, ny, 1, 1)
        np.testing.assert_array_equal(T.mode_permutation(m), J.mode_permutation(m))
    assert T.rot90_site_map(3, 3) == J.rot90_site_map(3, 3)
    with pytest.raises(ValueError, match="square"):
        T.rot90_site_map(2, 3)
    with pytest.raises(ValueError, match="axis"):
        T.reflect_site_map(3, 3, "z")


@pytest.mark.parametrize("nx,ny", [(2, 2), (2, 3)])
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("sparsity", [0.0, 0.7])
def test_permute_modes_equals_jax(nx, ny, signed, sparsity):
    n = 2 * nx * ny
    v = _state(n, n, sparsity)
    maps = [J.reflect_site_map(nx, ny, "x"), J.translation_site_map(nx, ny, 1, 1)]
    if nx == ny:
        maps.append(J.rot90_site_map(nx, ny))
    for site_map in maps:
        perm = J.mode_permutation(site_map)
        got = T.permute_modes(torch.tensor(v), perm, signed=signed)
        np.testing.assert_array_equal(got.numpy(), J.permute_modes(v, perm, signed=signed))
    with pytest.raises(ValueError, match="shape"):
        T.permute_modes(torch.tensor(v[:-2]), J.mode_permutation(maps[0]))


@pytest.mark.parametrize("nx,ny", [(2, 2), (2, 3)])
def test_signed_maps_commute_with_hamiltonian(nx, ny):
    n = 2 * nx * ny
    h = exact.get_sparse_operator(fermi_hubbard(nx, ny, 1.0, 4.0), n)
    v = _state(n, 1)
    perms = [T.mode_permutation(T.reflect_site_map(nx, ny, "y")),
             T.mode_permutation(T.translation_site_map(nx, ny, 1, 0))]
    if nx == ny:
        perms.append(T.mode_permutation(T.rot90_site_map(nx, ny)))

    def err(p, signed):
        a = T.permute_modes(torch.tensor(h @ v), p, signed=signed).numpy()
        b = h @ T.permute_modes(torch.tensor(v), p, signed=signed).numpy()
        return np.abs(a - b).max()

    for p in perms:
        assert err(p, True) < TOL
    if nx == ny:
        assert err(perms[-1], False) > 1e8 * max(err(perms[-1], True), 1e-16)


@pytest.mark.parametrize("sparsity", [0.0, 0.5])
def test_irrep_and_momentum_analysis_equal_jax(sparsity):
    v = _state(8, 3, sparsity)
    psi = torch.tensor(v)
    rot = J.mode_permutation(J.rot90_site_map(2, 2))
    jc = J.c4_irrep_components(v, lambda s: J.permute_modes(s, rot))
    tc = T.c4_irrep_components(psi, lambda s: T.permute_modes(s, rot))
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), jc[k], rtol=0, atol=TOL)
    js, jn = J.symmetry_adapted_states(v, 2, 2)
    ts, tn = T.symmetry_adapted_states(psi, 2, 2)
    assert js.keys() == ts.keys() and jn.keys() == tn.keys()
    assert max(abs(jn[k] - tn[k]) for k in jn) < TOL
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), js[k], rtol=0, atol=TOL)
    other = _state(8, 4)
    jw, tw = J.irrep_weights(other, js), T.irrep_weights(torch.tensor(other), ts)
    assert jw.keys() == tw.keys() and max(abs(jw[k] - tw[k]) for k in jw) < TOL
    jm, tm = J.momentum_weights(v, 2, 2), T.momentum_weights(psi, 2, 2)
    assert max(abs(jm[k] - tm[k]) for k in jm) < TOL
    for k in [(0, 0), (1, 0), (1, 1)]:
        np.testing.assert_allclose(T.momentum_project(psi, 2, 2, *k).numpy(),
                                   J.momentum_project(v, 2, 2, *k), rtol=0, atol=TOL)


def test_momentum_weights_2x3_numpy_state_on_cpu():
    v = _state(12, 5, 0.3)
    got = T.momentum_weights(v, 2, 3, device="cpu")
    ref = J.momentum_weights(v, 2, 3)
    assert max(abs(ref[k] - got[k]) for k in ref) < TOL
    assert abs(sum(got.values()) - 1.0) < TOL


def test_symmetry_adapted_ground_space_2x2():
    sp = exact.get_sparse_operator(fermi_hubbard(2, 2, 1.0, 6.0), 8)
    e, states, norms = T.symmetry_adapted_ground_space(sp, 4, 2, 2, 2, 2, device="cpu")
    jsp = jax_exact.get_sparse_operator(jax_fermi_hubbard(2, 2, 1.0, 6.0), 8)
    je, jstates, jnorms = J.symmetry_adapted_ground_space(jsp, 4, 2, 2, 2, 2)
    assert abs(e - je) < TOL
    assert states.keys() == jstates.keys()
    # the ED vector's phase is free: compare phase-free quantities
    assert max(abs(norms[k] - jnorms[k]) for k in norms) < 1e-8
    for k in states:
        assert abs(abs(np.vdot(jstates[k], states[k].numpy())) - 1.0) < 1e-8
