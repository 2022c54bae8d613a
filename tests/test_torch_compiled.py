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


def test_lower_program_rejects_unported_kinds():
    with pytest.raises(NotImplementedError):
        tc.lower_program([("fixed", "rz", (0.1, 0))], 4)


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
