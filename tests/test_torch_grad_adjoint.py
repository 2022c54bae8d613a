"""The port's gate-level adjoint and the unrolled ADAPT lowering.

* ``adjoint_apply`` / ``build_adjoint_energy`` on the 2x2 program of
  ``tests/test_adjoint.py`` (5 pool operators + the Givens network,
  complex128): energy and gradients against JAX's ``build_adjoint_energy``
  within 1e-10, against autograd through the port's gates within 1e-10,
  the psi0 cotangent against autograd, and the gradient at theta = 0
  against the pool screen.
* ``lower_program`` takes ``diag`` and ``rzlayer`` / ``rz`` ops as phase
  segments (their inverse undoes them) and refuses the HEA ``u4`` op.
* ``ADAPT(circuit_mode="unrolled")`` at 2x2: gradients (both the adjoint
  and the autograd branch) equal the split route's within 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsfh_tpu.algos.base import HubbardProblem as JaxProblem
from qsfh_tpu.engine.state import basis_state as jax_basis_state
from qsfh_tpu.grad import build_adjoint_energy as jax_build_adjoint_energy
from qsfh_tpu.grad import givens_network_ops as jax_givens_network_ops
from qsfh_torch.algos.adapt import ADAPT
from qsfh_torch.algos.base import HubbardProblem
from qsfh_torch.engine.circuits import apply_givens_network, apply_givens_network_adjoint
from qsfh_torch.engine.compiled import CompiledCircuit, lower_program
from qsfh_torch.engine.expectation import PackedPool
from qsfh_torch.engine.gates import generator_rotation
from qsfh_torch.engine.state import basis_state
from qsfh_torch.grad import adjoint_apply, build_adjoint_energy, givens_network_ops
from qsfh_torch.ops.jw import jordan_wigner
from qsfh_torch.ops.pool import hubbard_interaction_pool_simplified

THETAS = [0.3, -0.2, 0.15, 0.4, -0.1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small states: the tier-1 run puts
    several pytest workers on the cores, where torch's thread pool waits
    on descheduled threads (10-40x slower); the results do not change."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def setup():
    p = HubbardProblem(2, 2, 1.0, 6.0, 4, 2, 2)
    pool = hubbard_interaction_pool_simplified(2, 2)[:5]
    rot = [jordan_wigner(g).rotation_terms() for g in pool]
    ops = [("rot", tuple(r), k) for k, r in enumerate(rot)]
    ops += givens_network_ops(p.n_qubits, p.diagonal, p.decomposition)
    psi0 = basis_state(p.n_qubits, p.spin_up_indices + p.spin_down_indices)
    return p, rot, ops, psi0


def _backprop_energy(p, rot, psi0, th):
    psi = psi0
    for k, r in enumerate(rot):
        psi = generator_rotation(psi, p.n_qubits, r, th[k])
    psi = apply_givens_network(psi, p.n_qubits, p.diagonal, p.decomposition)
    return p.observables["H"].expectation(psi)


def test_ops_match_jax(setup):
    p, _, ops, _ = setup
    jp = JaxProblem(2, 2, 1.0, 6.0, 4, 2, 2)
    assert givens_network_ops(p.n_qubits, p.diagonal, p.decomposition) == \
        jax_givens_network_ops(jp.n_qubits, jp.diagonal, jp.decomposition)


@pytest.mark.parametrize("at_zero", [False, True], ids=["thetas", "zero"])
def test_adjoint_energy_and_gradients_match_jax(setup, at_zero):
    p, _, ops, psi0 = setup
    th = np.zeros(5) if at_zero else np.asarray(THETAS)
    jp = JaxProblem(2, 2, 1.0, 6.0, 4, 2, 2)
    jloss = jax_build_adjoint_energy(jp.observables["H"], jp.n_qubits, ops)
    jpsi0 = jax_basis_state(jp.n_qubits, jp.spin_up_indices + jp.spin_down_indices)
    e_ref, g_ref = jax.value_and_grad(jloss)(jnp.asarray(th), jpsi0)
    tth = torch.tensor(th, requires_grad=True)
    e = build_adjoint_energy(p.observables["H"], p.n_qubits, ops)(tth, psi0)
    (g,) = torch.autograd.grad(e, tth)
    assert abs(e.item() - float(e_ref)) <= 1e-10
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=0, atol=1e-10)


def test_adjoint_gradients_match_autograd(setup):
    p, rot, ops, psi0 = setup
    th = torch.tensor(THETAS, requires_grad=True)
    psi0 = psi0.clone().requires_grad_(True)
    e = build_adjoint_energy(p.observables["H"], p.n_qubits, ops)(th, psi0)
    g, gpsi = torch.autograd.grad(e, (th, psi0))
    th2 = torch.tensor(THETAS, requires_grad=True)
    psi02 = psi0.detach().clone().requires_grad_(True)
    e2 = _backprop_energy(p, rot, psi02, th2)
    g2, gpsi2 = torch.autograd.grad(e2, (th2, psi02))
    assert abs(e.item() - e2.item()) <= 1e-10
    np.testing.assert_allclose(g.numpy(), g2.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(gpsi.numpy(), gpsi2.numpy(), rtol=0, atol=1e-10)


def test_gradient_at_zero_matches_the_pool_screen(setup):
    p, rot, ops, psi0 = setup
    th = torch.zeros(5, requires_grad=True)
    e = build_adjoint_energy(p.observables["H"], p.n_qubits, ops)(th, psi0)
    (g,) = torch.autograd.grad(e, th)
    pool = PackedPool([jordan_wigner(gen) for gen in hubbard_interaction_pool_simplified(2, 2)[:5]],
                      p.n_qubits)
    w_r = p.observables["H"].apply(apply_givens_network(psi0, p.n_qubits, p.diagonal,
                                                        p.decomposition))
    w_k = apply_givens_network_adjoint(w_r, p.n_qubits, p.diagonal, p.decomposition)
    np.testing.assert_allclose(g.numpy(), pool.screen_scan(psi0, w_k).numpy(), rtol=0, atol=1e-10)


def test_phase_segments_lower_and_invert():
    n = 6
    rng = np.random.default_rng(2)
    psi = torch.tensor(rng.standard_normal(64) + 1j * rng.standard_normal(64))
    diag = rng.standard_normal(64)
    gate_ops = [("fixed", "rzlayer", tuple(rng.uniform(-1, 1, n))),
                ("rot", ((0b11, 0b01, 0.5), (0, 0b100, -0.25)), 0),
                ("fixed", "rz", (0.3, 2)), ("rot", ((0b1000, 0, 1.0),), 1)]
    ops = gate_ops[:2] + [("diag", diag, 1)] + gate_ops[2:]
    cc = CompiledCircuit(ops, n)
    assert [s.kind for s in cc.segments] == ["rzlayer", "rot", "diag", "rzlayer", "rot"]
    th = torch.tensor([0.4, -0.7], dtype=torch.float64)
    out = cc.apply(psi, th)
    np.testing.assert_allclose(cc.apply_inverse(out, th).numpy(), psi.numpy(), rtol=0, atol=1e-12)
    # the segments against the gates, and the diag segment against its phases
    np.testing.assert_allclose(CompiledCircuit(gate_ops, n).apply(psi, th).numpy(),
                               adjoint_apply(n, gate_ops, psi, th).numpy(), rtol=0, atol=1e-12)
    only_diag = CompiledCircuit([("diag", diag, 1)], n).apply(psi, th)
    np.testing.assert_allclose(only_diag.numpy(), psi.numpy() * np.exp(0.7j * diag),
                               rtol=0, atol=1e-12)
    # the u4 fixed op (Givens-network programs) is not ported: the error
    # names the roadmap item that ports it
    with pytest.raises(NotImplementedError, match="module item 8"):
        lower_program([("fixed", "u4", (tuple([1.0] * 16), 0, 1))], n)


@pytest.mark.parametrize("threshold", [0, 99], ids=["adjoint", "autograd"])
def test_adapt_unrolled_gradients_match_split(tmp_path, threshold):
    kw = dict(n_epoch=1, threshold1=1e-3, threshold2=1e-6, x_dimension=2, y_dimension=2,
              n_electrons=4, n_spin_up=2, n_spin_down=2, tunneling=1, coulomb=4,
              ground_truth=False, plot=False, log_metrics=False, device="cpu")
    split = ADAPT(**kw, results_root=str(tmp_path / "s"))
    unrolled = ADAPT(**kw, results_root=str(tmp_path / "u"), circuit_mode="unrolled",
                     adjoint_threshold=threshold)
    assert (split.circuit_mode, unrolled.circuit_mode) == ("split", "unrolled")
    indices = tuple(range(6))
    th0 = np.random.default_rng(5).normal(0, 0.1, size=6)
    outs, grads = [], []
    for a in (split, unrolled):
        th = torch.tensor(th0)
        out = a._build_step(indices)(th, torch.optim.Adam([th], lr=1e-2))
        outs.append([float(v) for v in out[2:]])
        grads.append(th.grad.numpy().copy())
    np.testing.assert_allclose(grads[1], grads[0], rtol=0, atol=1e-10)
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=1e-10)
