"""The port's float64 Rayleigh readout against the JAX double-float one.

On random complex64 states at 8, 10 and 12 qubits (2x2, 1x5 and 2x3
Hubbard H, and S^2 of the 2x2 lattice), ``combine_rayleigh`` of the
port's ``expectation_norm_df`` agrees within 1e-12 relative with the JAX
package's ``expectation_norm_df`` on the same float32 planes and with a
numpy float64 evaluation of the same float32 state.  On the CPU the port
takes the plain version of the ``expectation_norm_f64`` kernel (the state
upcast to complex128); the layout the kernel reads (terms grouped by flip
mask) holds every term once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsfh_tpu.engine import dfloat as jax_dfloat
from qsfh_tpu.ops.pauli import PauliSum as JaxPauliSum
from qsfh_torch.engine import kernels as K
from qsfh_torch.engine.dfloat import (
    combine_df,
    combine_rayleigh,
    expectation_norm_df,
    f64_terms,
)
from qsfh_torch.engine.expectation import Observable
from qsfh_torch.linalg.exact import get_sparse_operator
from qsfh_torch.ops.jw import jordan_wigner
from qsfh_torch.ops.lattice import fermi_hubbard, spin_operator

# (operator, qubits)
CASES = {
    "2x2 H": lambda: (jordan_wigner(fermi_hubbard(2, 2, 1.0, 4.0)), 8),
    "2x2 S^2": lambda: (jordan_wigner(spin_operator(4, "S^2")), 8),
    "1x5 H": lambda: (jordan_wigner(fermi_hubbard(5, 1, 1.0, 6.0)), 10),
    "2x3 H": lambda: (jordan_wigner(fermi_hubbard(2, 3, 1.0, 4.0)), 12),
}


def _state32(seed, n):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return (v / np.linalg.norm(v) * 1.3).astype(np.complex64)  # not normalized


@pytest.mark.parametrize("name", CASES)
def test_rayleigh_matches_jax_and_float64(name):
    op, n = CASES[name]()
    psi = _state32(n, n)
    got = expectation_norm_df(torch.as_tensor(psi), n, Observable(op, n))
    assert got.dtype == torch.float64 and got.shape == (4,)
    assert float(got[1]) == 0.0 and float(got[3]) == 0.0
    e = combine_rayleigh(got.numpy())

    reim = np.stack([psi.real, psi.imag]).astype(np.float32)
    jop = JaxPauliSum(op.x, op.z, op.c)
    je = combine_rayleigh(np.asarray(jax_dfloat.expectation_norm_df(jnp.asarray(reim), n, jop)))
    p64 = psi.astype(np.complex128)
    ref = np.vdot(p64, get_sparse_operator(op, n) @ p64).real / np.vdot(p64, p64).real
    assert abs(e - je) <= 1e-12 * abs(je)
    assert abs(e - ref) <= 1e-12 * abs(ref)
    # a PauliSum gives the same bits as its Observable
    assert torch.equal(expectation_norm_df(torch.as_tensor(psi), n, op), got)
    # a complex128 state reads as its complex64 rounding
    again = expectation_norm_df(torch.as_tensor(p64), n, op)
    assert combine_rayleigh(again.numpy()) == e


def test_f64_terms_group_every_term_once():
    op, _ = CASES["2x3 H"]()
    obs = Observable(op, 12)
    xs, zs, cre, cim, starts = f64_terms(obs, torch.device("cpu"))
    assert xs.dtype == zs.dtype == starts.dtype == torch.int32
    assert cre.dtype == cim.dtype == torch.float64
    s = starts.tolist()
    assert s[0] == 0 and s[-1] == len(obs) and s == sorted(set(s))
    for g in range(len(s) - 1):  # one mask per group, every group a new mask
        assert set(xs[s[g]:s[g + 1]].tolist()) == {int(xs[s[g]])}
    assert len(set(int(xs[s[g]]) for g in range(len(s) - 1))) == len(s) - 1
    # the same terms as the scan arrays, reordered
    sx, sz, sre, sim = obs._scan_terms()
    got = sorted(zip(xs.tolist(), zs.tolist(), cre.tolist(), cim.tolist()))
    want = sorted(zip(sx.astype(np.int64).tolist(), sz.astype(np.int64).tolist(), sre.tolist(),
                      sim.tolist()))
    assert got == want
    assert f64_terms(obs, torch.device("cpu"))[0] is xs  # built once


def test_plain_readout_and_combiners():
    op, _ = CASES["2x2 H"]()
    psi = torch.as_tensor(_state32(3, 8))
    terms = f64_terms(Observable(op, 8), psi.device)
    out = K.expectation_norm_f64(psi, *terms)
    assert torch.equal(out, K.expectation_norm_f64_plain(psi, *terms))
    norm = float(torch.vdot(psi.to(torch.complex128), psi.to(torch.complex128)).real)
    assert float(out[2]) == pytest.approx(norm, rel=1e-15)
    assert combine_df(out[:2].numpy()) == float(out[0])
    with pytest.raises(ValueError):
        expectation_norm_df(psi, 10, op)
