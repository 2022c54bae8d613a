"""The port's float64 polish engine against the JAX package's.

``qsfh_torch.native.statevec.Rot64Program(device="cpu")`` (the plain
versions of the ``rot64_groups`` / ``happly64`` / ``adjoint64_groups``
kernels) against the JAX package's host C++ engine
(``qsfh_tpu.native.statevec.Rot64Program``) and its float64 stages
(``ADAPT._build_step(...).raw_stages``, as ``tests/test_statevec64.py``
builds them), on the same seeded numpy angles: 2x2 with the ansatz of
``tests/test_statevec64.py``, and 2x3 (12 qubits) with ten operators of
the extended pool, where groups of 8 terms and diagonal groups occur.  E,
the gradient, the state and H psi within 1e-12; the grouped arrays equal
to the JAX package's on the committed 3x3 checkpoint (1719 operators, no
state sweep); central differences within 1e-7, a symmetric Hessian-vector
product; no card -> ``device=None`` raises.
"""

import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qsfh_tpu.algos.adapt import ADAPT as JaxADAPT
from qsfh_tpu.algos.adapt_fused import initial_state_reim
from qsfh_tpu.native import statevec as jax_statevec
from qsfh_tpu.ops.pool import hubbard_interaction_pool_extended as jax_pool_extended
from qsfh_torch.algos.adapt import ADAPT
from qsfh_torch.native.statevec import Rot64Program
from qsfh_torch.ops.pool import hubbard_interaction_pool_extended

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-12
FD_ATOL = 1e-7
GROUP_ARRAYS = ("gx", "gpidx", "gflip", "goff", "zsub", "wsub")

# lattice -> (driver arguments, extended pool?, ansatz indices)
CASES = {
    "2x2": (dict(x_dimension=2, y_dimension=2, n_electrons=4, n_spin_up=2, n_spin_down=2,
                 tunneling=1, coulomb=6), False, [0, 3, 7, 11, 2, 5]),
    "2x3": (dict(x_dimension=2, y_dimension=3, n_electrons=6, n_spin_up=3, n_spin_down=3,
                 tunneling=1, coulomb=4, ground_truth=False), True,
            [0, 5, 10, 20, 40, 60, 80, 90, 100, 110]),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request, tmp_path_factory):
    kw, extended, indices = CASES[request.param]
    kw = dict(kw, n_epoch=0, threshold1=1e-2, threshold2=1e-2, plot=False, log_metrics=False,
              results_root=str(tmp_path_factory.mktemp("sv64")))
    nx, ny = kw["x_dimension"], kw["y_dimension"]
    jax_vqe = JaxADAPT(pool=jax_pool_extended(nx, ny) if extended else None, **kw)
    vqe = ADAPT(pool=hubbard_interaction_pool_extended(nx, ny) if extended else None,
                device="cpu", dtype=torch.complex128, **kw)
    psi0_r = initial_state_reim(jax_vqe)
    psi0 = np.asarray(psi0_r[0] + 1j * psi0_r[1])
    np.testing.assert_array_equal(vqe._initial_state().numpy(), psi0)
    prog = Rot64Program.from_adapt(vqe, indices)
    th = np.random.default_rng(7).normal(0.0, 0.4, len(indices))
    return dict(name=request.param, jax_vqe=jax_vqe, indices=indices, prog=prog,
                psi0_r=psi0_r, psi0=psi0, th=th)


def test_groups_hold_both_kinds(case):
    prog = case["prog"]
    assert prog.device.type == "cpu" and prog.G == prog.groups.n_groups
    assert (prog.gx == 0).any()  # the Givens network's RZ groups
    if case["name"] == "2x3":
        assert np.diff(prog.goff).max() == 8  # the cap
        assert ((prog.gx == 0) & (prog.gpidx >= 0)).sum() == 0


def test_value_grad_state_against_jax_stages(case):
    step = case["jax_vqe"]._build_step(case["indices"], optax.adam(1e-3))
    raw = step.raw_stages
    th = case["th"]
    psi_r = raw["fwd_from"](case["psi0_r"], jnp.asarray(th))
    e_jax = float(raw["energy"](psi_r))
    g_jax = np.asarray(raw["adjoint"](psi_r, raw["cotangent"](psi_r), jnp.asarray(th)))
    prog = case["prog"]
    e, g = prog.value_and_grad(th, case["psi0"])
    assert isinstance(e, float) and g.dtype == np.float64 and g.shape == th.shape
    assert abs(e - e_jax) < ATOL
    np.testing.assert_allclose(g, g_jax, rtol=0, atol=ATOL)
    psi = prog.apply(th, case["psi0"])
    assert psi.dtype == torch.complex128
    np.testing.assert_allclose(psi.numpy(), np.asarray(psi_r[0] + 1j * psi_r[1]), rtol=0,
                               atol=ATOL)


def test_against_jax_native_engine(case):
    if not jax_statevec.available():
        pytest.skip("the JAX package's native statevec64 engine is unavailable")
    jax_prog = jax_statevec.Rot64Program.from_adapt(case["jax_vqe"], case["indices"])
    prog = case["prog"]
    for name in GROUP_ARRAYS:
        ours, ref = getattr(prog, name), getattr(jax_prog, name)
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref), name
    th, psi0 = case["th"], case["psi0"]
    e_ref, g_ref = jax_prog.value_and_grad(th, psi0)
    e, g = prog.value_and_grad(torch.from_numpy(th), torch.from_numpy(psi0))  # tensors too
    assert abs(e - e_ref) < ATOL
    np.testing.assert_allclose(g, g_ref, rtol=0, atol=ATOL)
    psi_ref = jax_prog.apply(th, psi0)
    np.testing.assert_allclose(prog.apply(th, psi0).numpy(), psi_ref, rtol=0, atol=ATOL)
    h_ref = jax_prog.h_apply(psi_ref)
    h = prog.h_apply(psi_ref).numpy()
    assert np.linalg.norm(h - h_ref) <= ATOL * np.linalg.norm(h_ref)
    assert abs(prog.energy(th, psi0) - jax_prog.energy(th, psi0)) < ATOL


def test_energy_matches_value_and_grad_and_repeats(case):
    prog, psi0 = case["prog"], case["psi0"]
    th = np.linspace(-0.3, 0.5, len(case["indices"]))
    e, g = prog.value_and_grad(th, psi0)
    assert abs(prog.energy(th, psi0) - e) < ATOL
    e2, g2 = prog.value_and_grad(th, psi0)
    assert e2 == e and np.array_equal(g2, g)


def test_grad_matches_finite_difference(case):
    prog, psi0 = case["prog"], case["psi0"]
    th = np.random.default_rng(3).normal(0.0, 0.2, len(case["indices"]))
    _, g = prog.value_and_grad(th, psi0)
    eps = 1e-6
    for k in (0, len(th) // 2, len(th) - 1):
        tp, tm = th.copy(), th.copy()
        tp[k] += eps
        tm[k] -= eps
        fd = (prog.energy(tp, psi0) - prog.energy(tm, psi0)) / (2 * eps)
        assert abs(fd - g[k]) < FD_ATOL


def test_hvp_symmetry(case):
    prog, psi0 = case["prog"], case["psi0"]
    rng = np.random.default_rng(11)
    th = rng.normal(0.0, 0.2, len(case["indices"]))
    u, v = rng.normal(size=len(th)), rng.normal(size=len(th))
    hu, hv = prog.hvp(th, psi0, u), prog.hvp(th, psi0, v)
    assert abs(np.dot(v, hu) - np.dot(u, hv)) < 1e-6
    assert np.array_equal(prog.hvp(th, psi0, np.zeros_like(u)), np.zeros_like(u))


def test_group_terms_match_jax_on_3x3_checkpoint():
    if not jax_statevec.available():
        pytest.skip("the JAX package's native statevec64 engine is unavailable")
    kw = dict(n_epoch=0, threshold1=1e-3, threshold2=1e-3, x_dimension=3, y_dimension=3,
              n_electrons=9, n_spin_up=5, n_spin_down=4, tunneling=1, coulomb=6,
              degenerate_subspace=4, load_model=True, plot=False, log_metrics=False,
              results_root=os.path.join(ROOT, "benchmarks", "demo_3x3"))
    jax_prog = jax_statevec.Rot64Program.from_adapt(JaxADAPT(pool=jax_pool_extended(3, 3), **kw))
    vqe = ADAPT(pool=hubbard_interaction_pool_extended(3, 3), device="cpu",
                dtype=torch.complex128, **kw)
    prog = Rot64Program.from_adapt(vqe)
    for name in GROUP_ARRAYS:
        ours, ref = getattr(prog, name), getattr(jax_prog, name)
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref), name
    for name in ("hx", "hz", "hcre", "hcim"):
        np.testing.assert_array_equal(getattr(prog, name), getattr(jax_prog, name))
    # the structure the flagship polish runs on
    assert (prog.n, prog.n_params, prog.G, len(prog.zsub)) == (18, 1719, 1931, 14123)
    assert np.bincount(np.diff(prog.goff)).tolist() == [0, 65, 145, 0, 0, 0, 0, 0, 1721]
    assert (prog.gx == 0).sum() == 68 and (prog.gpidx < 0).sum() == 212
    assert len(prog.hx) == 100
    # every parameter's groups, ascending, in the kernel's CSR
    off = prog.groups.param_off.numpy()
    rows = prog.groups.param_groups.numpy()
    for j in (0, 850, 1718):
        np.testing.assert_array_equal(rows[off[j]:off[j + 1]], np.flatnonzero(prog.gpidx == j))


def test_device_none_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seg = dict(xb=np.array([1], np.uint32), zb=np.array([0], np.uint32),
               scale=np.array([0.5]), pidx=np.array([0], np.int32), phre=np.array([1.0]),
               phim=np.array([0.0]))
    h = (np.array([0], np.uint32), np.array([1], np.uint32), np.array([1.0]), np.array([0.0]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Rot64Program(1, seg, h, 1)
    prog = Rot64Program(1, seg, h, 1, device="cpu")
    e, g = prog.value_and_grad([0.3], np.array([1.0, 0.0]))
    # exp(-i 0.15 X)|0>: <Z> = cos(0.3), d<Z>/dtheta = -sin(0.3)
    assert abs(e - np.cos(0.3)) < ATOL and abs(g[0] + np.sin(0.3)) < ATOL
