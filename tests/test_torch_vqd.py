"""The port's VQD (``algos/vqd.py``) against the JAX driver (complex128).

Both drivers start every level from the same angles (``init_params``
given as values: the JAX draw from ``jax.random`` cannot be reproduced).

* H2 r = 0.8 over the HEA (reps 3, lr 0.1, beta 5), 2 levels of 8
  epochs: per-level histories and final energies within 1e-10, the level
  states within 1e-9;
* the same with a sector penalty (``penalty_ops``: the number operator
  pinned to 1) and with ``initial_occupied`` (the HF determinant);
* the 2x2 Hubbard lattice over ``HVA.circuit`` (reps 2, the JAX dict of
  angles), 2 levels of 6 epochs, as ``benchmarks/demo_vqd_2x2/run.py``
  deflates it; the port's ``HVA.circuit`` (one rot segment) equals the JAX
  gate circuit within 1e-12;
* a callable ``init_params`` receives the level's ``torch.Generator``
  (seeded ``seed + level``), and zero epochs report the initial energy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsfh_tpu.algos.hva import HVA as JaxHVA
from qsfh_tpu.algos.vqd import VQD as JaxVQD
from qsfh_tpu.molecules import H2 as JaxH2
from qsfh_tpu.ops.fermion import FermionOperator as JaxFermionOperator
from qsfh_torch.algos.hva import HVA
from qsfh_torch.algos.vqd import VQD
from qsfh_torch.molecules import H2
from qsfh_torch.ops.fermion import FermionOperator

KW = dict(n_levels=2, n_epoch=8, reps=3, lr=1e-1, beta=5.0, threshold=0.0, log_metrics=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small states (several pytest workers
    share the cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def h2():
    return JaxH2(r=0.8), H2(r=0.8)


def _number(cls):
    op = cls.zero()
    for q in range(4):
        op += cls(((q, 1), (q, 0)))
    return op


def _check(j, je, t, te):
    assert t.dtype == torch.complex128
    np.testing.assert_allclose(te, je, rtol=0, atol=1e-10)
    for hj, ht in zip(j.histories, t.histories):
        assert len(hj) == len(ht)
        np.testing.assert_allclose(ht, hj, rtol=0, atol=1e-10)
    for sj, st in zip(j.states, t.states):
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-9)


@pytest.mark.parametrize("variant", ["plain", "penalty", "occupied"])
def test_h2_hea_levels_match_jax(h2, tmp_path, variant):
    init = np.random.default_rng(5).uniform(-0.6, 0.6, (4, 4, 3))
    jkw, tkw = {}, {}
    if variant == "penalty":
        jkw = dict(n_levels=1, penalty_ops=[(_number(JaxFermionOperator), 1.0, 5.0)])
        tkw = dict(n_levels=1, penalty_ops=[(_number(FermionOperator), 1.0, 5.0)])
    elif variant == "occupied":
        jkw = tkw = dict(initial_occupied=(0, 1))
    j = JaxVQD(h2[0], results_root=str(tmp_path / "j"), init_params=jnp.asarray(init),
               **dict(KW, **jkw))
    t = VQD(h2[1], results_root=str(tmp_path / "t"), init_params=init, device="cpu",
            **dict(KW, **tkw))
    _check(j, j.run(), t, t.run())


def test_hva_circuit_deflation_2x2_matches_jax(tmp_path):
    hkw = dict(n_epoch=0, reps=2, lr=3e-2, x_dimension=2, y_dimension=2, n_electrons=4,
               n_spin_up=2, n_spin_down=2, tunneling=1, coulomb=6, plot=False,
               log_metrics=False, ground_truth=False)
    jh = JaxHVA(results_root=str(tmp_path / "jh"), **hkw)
    th = HVA(results_root=str(tmp_path / "th"), device="cpu", **hkw)
    rng = np.random.default_rng(9)
    init = {k: 0.05 * rng.standard_normal(np.asarray(v).shape) for k, v in jh.params.items()}
    ref = np.asarray(jh.circuit({k: jnp.asarray(v) for k, v in init.items()}))
    np.testing.assert_allclose(th.circuit(init).numpy(), ref, rtol=0, atol=1e-12)
    kw = dict(KW, n_epoch=6, beta=6.0, lr=3e-2)
    j = JaxVQD(jh.problem.fermion_hamiltonian, n_qubits=8, results_root=str(tmp_path / "j"),
               circuit=jh.circuit, init_params={k: jnp.asarray(v) for k, v in init.items()},
               **kw)
    t = VQD(th.problem.fermion_hamiltonian, n_qubits=8, results_root=str(tmp_path / "t"),
            circuit=th.circuit, init_params=init, device="cpu", **kw)
    _check(j, j.run(), t, t.run())


def test_callable_init_takes_the_level_generator_and_zero_epochs(h2, tmp_path):
    seen = []

    def init(gen):
        seen.append(torch.rand(1, generator=gen, dtype=torch.float64).item())
        return torch.zeros((4, 4, 3), dtype=torch.float64)

    t = VQD(h2[1], n_levels=2, n_epoch=0, reps=3, seed=4, results_root=str(tmp_path),
            log_metrics=False, device="cpu", init_params=init)
    energies = t.run()
    expected = [torch.rand(1, generator=torch.Generator().manual_seed(s),
                           dtype=torch.float64).item() for s in (4, 5)]
    assert seen == expected
    assert t.histories == [[], []] and len(energies) == 2
    # zero angles: the HEA on |0000> is |0000> up to phase, E = <0000|H|0000>
    j = JaxVQD(h2[0], n_levels=1, n_epoch=0, reps=3, results_root=str(tmp_path / "j"),
               log_metrics=False, init_params=jnp.zeros((4, 4, 3)))
    assert abs(energies[0] - j.run()[0]) <= 1e-12
