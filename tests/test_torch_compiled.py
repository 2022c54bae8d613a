"""``qsfh_torch.engine.compiled`` against ``qsfh_tpu.engine.compiled``.

Random 10-12 qubit rot programs (multi-term ops, shared and static
parameters, a global phase) and the 2x2 ADAPT program (pool ansatz +
Givens network): states from ``CompiledCircuit.apply``/``apply_inverse``
and gradients from ``run_rot_adjoint`` at complex128 within 1e-10, and the
round trip apply o apply_inverse = identity.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsfh_tpu.algos.adapt import ADAPT as JaxADAPT
from qsfh_tpu.engine import compiled as jc
from qsfh_torch.engine import compiled as tc

TOL = 1e-10


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _state(rng, n):
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return v / np.linalg.norm(v)


def _random_program(rng, n, n_ops=12, n_params=5):
    ops = []
    for _ in range(n_ops):
        terms = []
        for _ in range(int(rng.integers(1, 4))):
            x = int(rng.integers(0, 1 << n)) if rng.random() > 0.25 else 0
            terms.append((x, int(rng.integers(0, 1 << n)), float(rng.uniform(-1, 1))))
        ops.append(("rot", tuple(terms), int(rng.integers(-1, n_params))))
    return ops


@pytest.mark.parametrize("n", [10, 12])
def test_apply_and_inverse_match(n):
    rng = np.random.default_rng(n)
    ops = _random_program(rng, n)
    thetas = rng.uniform(-1, 1, size=5)
    psi = _state(rng, n)
    jcc = jc.CompiledCircuit(ops, n, global_phase=1j)
    tcc = tc.CompiledCircuit(ops, n, global_phase=1j)
    ref = np.asarray(jcc.apply(jnp.asarray(psi), jnp.asarray(thetas)))
    got = tcc.apply(torch.as_tensor(psi), torch.as_tensor(thetas))
    assert _rel(got.numpy(), ref) <= TOL
    ref_inv = np.asarray(jcc.apply_inverse(jnp.asarray(psi), jnp.asarray(thetas)))
    got_inv = tcc.apply_inverse(torch.as_tensor(psi), torch.as_tensor(thetas))
    assert _rel(got_inv.numpy(), ref_inv) <= TOL
    back = tcc.apply_inverse(got, torch.as_tensor(thetas))
    assert _rel(back.numpy(), psi) <= TOL


@pytest.mark.parametrize("n", [10, 12])
def test_rot_adjoint_matches(n):
    rng = np.random.default_rng(20 + n)
    ops = _random_program(rng, n)
    thetas = rng.uniform(-1, 1, size=5)
    psi, lam = _state(rng, n), _state(rng, n)
    jseg = jc.CompiledCircuit(ops, n).segments[0]
    tseg = tc.CompiledCircuit(ops, n).segments[0]
    rpsi, rlam, rgrads = jc.run_rot_adjoint(jseg, jnp.asarray(psi), jnp.asarray(lam),
                                            jnp.asarray(thetas), n)
    tpsi, tlam = torch.as_tensor(psi), torch.as_tensor(lam)
    gpsi, glam, grads = tc.run_rot_adjoint(tseg, tpsi, tlam, torch.as_tensor(thetas), n)
    assert _rel(gpsi.numpy(), rpsi) <= TOL
    assert _rel(glam.numpy(), rlam) <= TOL
    assert _rel(grads.numpy(), rgrads) <= TOL
    # the inputs are left as they were
    assert np.array_equal(tpsi.numpy(), psi) and np.array_equal(tlam.numpy(), lam)


def _flat(payload):
    out = []
    for v in payload:
        out.extend(_flat(v) if isinstance(v, tuple) else [complex(v)])
    return np.asarray(out)


def _givens_program(nx, ny):
    """The Givens network of the nx x ny lattice as 4x4 gates (the JAX
    package's ``givens_network_ops``, the port's alongside), with ``se``
    gates (one with qa > qb), an ``x`` on the first and on a later qubit,
    a ``u4`` whose qubits come in descending order and rot ops between."""
    from qsfh_tpu.algos.base import HubbardProblem as JaxProblem
    from qsfh_tpu.grad.adjoint import givens_network_ops as jax_net
    from qsfh_torch.grad.adjoint import givens_network_ops as port_net

    p = JaxProblem(nx, ny, 1.0, 4.0, nx * ny, (nx * ny + 1) // 2, nx * ny // 2)
    n = p.n_qubits
    net = jax_net(n, p.diagonal, p.decomposition)
    port = port_net(n, p.diagonal, p.decomposition)
    assert len(port) == len(net)
    for a, b in zip(port, net):
        assert a[:2] == b[:2]
        np.testing.assert_allclose(_flat(a[2]), _flat(b[2]), rtol=0, atol=1e-15)
    rng = np.random.default_rng(n)
    u = np.linalg.qr(rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4)))[0]
    extra = [("fixed", "se", (0.37, 1, 2)), ("fixed", "se", (-0.81, 5, 3)),
             ("fixed", "x", (0,)), ("fixed", "x", (n - 2,)),
             ("fixed", "u4", (tuple(map(complex, u.ravel())), n - 1, 2))]
    rots = [("rot", ((3, 1, 0.4), (0, 5, -0.2)), 0), ("rot", ((1 << (n - 1)) | 1, 0, 0.3), -1)]
    rots[1] = ("rot", (rots[1][1],), -1)
    return n, net[:1] + rots[:1] + net[1:] + extra[:2] + rots[1:] + extra[2:]


@pytest.mark.parametrize("lattice", [(2, 2), (5, 1)], ids=["8q", "10q"])
def test_lower_program_u4_segments_match_jax(lattice):
    n, ops = _givens_program(*lattice)
    jsegs, tsegs = jc.lower_program(ops, n), tc.lower_program(ops, n)
    assert [s.kind for s in tsegs] == [s.kind for s in jsegs]
    assert "u4" in [s.kind for s in tsegs]
    for j, t in zip(jsegs, tsegs):
        if t.kind in ("u4", "rot"):
            assert set(t.data) == set(j.data)
            for key in j.data:
                assert t.data[key].dtype == j.data[key].dtype, key
                np.testing.assert_allclose(t.data[key], j.data[key], rtol=0, atol=1e-15)
        else:
            assert t.data == j.data


@pytest.mark.parametrize("lattice", [(2, 2), (5, 1)], ids=["8q", "10q"])
def test_u4_circuit_apply_and_inverse_match_jax(lattice):
    n, ops = _givens_program(*lattice)
    rng = np.random.default_rng(7 + n)
    psi = _state(rng, n)
    thetas = np.array([0.23])
    jcc, tcc = jc.CompiledCircuit(ops, n, global_phase=1j), tc.CompiledCircuit(ops, n,
                                                                              global_phase=1j)
    ref = np.asarray(jcc.apply(jnp.asarray(psi), jnp.asarray(thetas)))
    got = tcc.apply(torch.as_tensor(psi), torch.as_tensor(thetas))
    assert _rel(got.numpy(), ref) <= TOL
    ref_inv = np.asarray(jcc.apply_inverse(jnp.asarray(psi), jnp.asarray(thetas)))
    got_inv = tcc.apply_inverse(torch.as_tensor(psi), torch.as_tensor(thetas))
    assert _rel(got_inv.numpy(), ref_inv) <= TOL
    back = tcc.apply_inverse(got, torch.as_tensor(thetas))
    assert _rel(back.numpy(), psi) <= TOL


def test_u4_network_equals_the_gate_network():
    """The Givens network lowered to a u4 segment is the port's gate-level
    network, and its static-rotation lowering up to the global phase."""
    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.engine.circuits import apply_givens_network
    from qsfh_torch.grad.adjoint import givens_network_ops

    p = HubbardProblem(2, 2, 1.0, 4.0, 4, 2, 2)
    psi = torch.as_tensor(_state(np.random.default_rng(2), 8))
    empty = torch.zeros(0, dtype=torch.float64)
    u4 = tc.CompiledCircuit(givens_network_ops(8, p.diagonal, p.decomposition), 8)
    static_ops, phase = tc.givens_network_static_ops(8, p.diagonal, p.decomposition)
    rot = tc.CompiledCircuit(static_ops, 8, global_phase=phase)
    ref = apply_givens_network(psi, 8, p.diagonal, p.decomposition)
    assert _rel(u4.apply(psi, empty).numpy(), ref.numpy()) <= TOL
    assert _rel(rot.apply(psi, empty).numpy(), ref.numpy()) <= TOL


def test_lower_program_rejects_unknown_ops():
    with pytest.raises(ValueError, match="unknown fixed tag"):
        tc.lower_program([("fixed", "cz", (0, 1))], 4)
    with pytest.raises(ValueError, match="unknown op"):
        tc.lower_program([("swap", 0, 1)], 4)


@pytest.fixture(scope="module")
def adapt_2x2(tmp_path_factory):
    return JaxADAPT(
        n_epoch=1, threshold1=1e-2, threshold2=1e-2, x_dimension=2, y_dimension=2,
        n_electrons=4, n_spin_up=2, n_spin_down=2, tunneling=1, coulomb=4,
        results_root=str(tmp_path_factory.mktemp("cc")), plot=False, log_metrics=False,
        ground_truth=False,
    )


def test_adapt_program_state_and_gradient(adapt_2x2):
    a = adapt_2x2
    n = a.n_qubits
    p = a.problem
    indices = [1, 4, 12, 13]
    ops = [("rot", tuple(a.pool_rot[i]), s) for s, i in enumerate(indices)]
    net_ops, gphase = jc.givens_network_static_ops(n, p.diagonal, p.decomposition)
    tnet, tphase = tc.givens_network_static_ops(n, p.diagonal, p.decomposition)
    assert tnet == net_ops and tphase == gphase
    thetas = np.random.default_rng(3).uniform(-0.3, 0.3, size=len(indices))
    psi0 = np.zeros(1 << n, complex)
    idx = sum(1 << (n - 1 - q) for q in p.spin_up_indices + p.spin_down_indices)
    psi0[idx] = 1.0
    jcc = jc.CompiledCircuit(ops + net_ops, n, global_phase=gphase)
    tcc = tc.CompiledCircuit(ops + tnet, n, global_phase=tphase)
    ref = jcc.apply(jnp.asarray(psi0), jnp.asarray(thetas))
    got = tcc.apply(torch.as_tensor(psi0), torch.as_tensor(thetas))
    assert _rel(got.numpy(), np.asarray(ref)) <= TOL
    lam = 2.0 * np.asarray(p.observables["H"].apply_scan(ref))
    rg = jc.run_rot_adjoint(jcc.segments[0], ref, jnp.asarray(lam), jnp.asarray(thetas), n)[2]
    tg = tc.run_rot_adjoint(tcc.segments[0], got, torch.as_tensor(lam),
                            torch.as_tensor(thetas), n)[2]
    assert _rel(tg.numpy(), np.asarray(rg)) <= TOL
