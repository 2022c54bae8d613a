"""The port's iQCC-ILC folds (torch, complex128) against the JAX package's
(host numpy), on the 2x2 Hubbard H at the mean-field product state and on
the same H after one seeded dense dressing: ``ilc_scores``,
``candidate_anticommuting_sets`` (the same sets for the same seed),
``fold_ilc_dense`` against the ZGEMM form U^dag H U and against JAX's,
and ``ilc_step_dense`` (H, E_pred, info), within 1e-10.
"""

import numpy as np
import pytest
import torch

from qsfh_torch.algos.iqcc import product_state
from qsfh_torch.ops import ilc as port
from qsfh_torch.ops.dense_dressing import dense_dis_generators, dress_dense, \
    paulisum_to_dense_fast
from qsfh_torch.ops.jw import jordan_wigner
from qsfh_torch.ops.lattice import fermi_hubbard
from qsfh_torch.utils.dense import paulisum_to_dense
from qsfh_tpu.ops import ilc as ref
from qsfh_tpu.ops.pauli import PauliSum as JaxPauliSum

TOL = 1e-10
N = 8


def _jax(P):
    return JaxPauliSum(P.x, P.z, P.c)


@pytest.fixture(scope="module", params=["bare", "dressed"])
def case(request):
    """(H, psi, gens, JAX gens): H undressed or dressed once by its first 4
    DIS generators at seeded angles; psi the 4-electron mean-field state
    with seeded phases; gens the DIS of H."""
    H = paulisum_to_dense_fast(jordan_wigner(fermi_hubbard(2, 2, 1.0, 4.0, periodic=True)), N)
    if request.param == "dressed":
        dis, _ = dense_dis_generators(H, N)
        H = dress_dense(H, [P for _, P in dis[:4]], [0.3, -0.5, 0.2, 0.45], N)
    rng = np.random.default_rng(2)
    theta = torch.tensor([np.pi] * 4 + [0.0] * 4) + torch.tensor(rng.normal(0, 0.2, N))
    psi = product_state(theta, torch.tensor(rng.normal(0, 0.3, N)), N, torch.complex128)
    gens = [P for _, P in dense_dis_generators(H, N)[0]]
    return H, psi, gens, [_jax(P) for P in gens]


def test_anticommute_and_column(case):
    H, psi, gens, jgens = case
    for P, Q in zip(gens, jgens):
        np.testing.assert_allclose(port.string_column(P, psi, N).numpy(),
                                   ref.string_column(Q, psi.numpy(), N), rtol=0, atol=0)
    masks = [(int(P.x[0]), int(P.z[0])) for P in gens]
    anti = port._anticommute_matrix(gens)
    for i, a in enumerate(masks):
        for j, b in enumerate(masks):
            assert anti[i, j] == port.pauli_anticommute(*a, *b) == ref.pauli_anticommute(*a, *b)


def test_scores_and_candidate_sets(case):
    H, psi, gens, jgens = case
    got = port.ilc_scores(H, psi, gens, N)
    want = ref.ilc_scores(H.numpy(), psi.numpy(), jgens, N)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    assert got[3] == pytest.approx(want[3], abs=TOL)
    scores = want[0]
    for cap, restarts, seed in ((8, 8, 0), (4, 16, 3), (16, 2, 1)):
        assert port.candidate_anticommuting_sets(gens, scores, cap, restarts, seed) == \
            ref.candidate_anticommuting_sets(jgens, scores, cap, restarts, seed)
    assert port.greedy_anticommuting_set(gens, scores, 8) == \
        ref.greedy_anticommuting_set(jgens, scores, 8)


def test_fold_against_zgemm(case):
    H, psi, gens, jgens = case
    sel = ref.greedy_anticommuting_set(jgens, ref.ilc_scores(H.numpy(), psi.numpy(), jgens, N)[0],
                                       6)
    sub = [gens[i] for i in sel]
    a = np.random.default_rng(4).normal(size=len(sub) + 1)
    a /= np.linalg.norm(a)
    folded = port.fold_ilc_dense(H, sub, a, N)
    # U = a0 I - i sum_k a_{k+1} P_k, unitary for a mutually anticommuting set
    U = a[0] * np.eye(1 << N) - 1j * sum(b * paulisum_to_dense(P, N) for b, P in zip(a[1:], sub))
    np.testing.assert_allclose(U.conj().T @ U, np.eye(1 << N), rtol=0, atol=1e-12)
    np.testing.assert_allclose(folded.numpy(), U.conj().T @ H.numpy() @ U, rtol=0, atol=TOL)
    np.testing.assert_allclose(folded.numpy(),
                               ref.fold_ilc_dense(H.numpy(), [jgens[i] for i in sel], a, N),
                               rtol=0, atol=TOL)


def test_ilc_step(case):
    H, psi, gens, jgens = case
    Hd, e, info = port.ilc_step_dense(H, psi, gens, N, cap=16)
    Hd_ref, e_ref, info_ref = ref.ilc_step_dense(H.numpy(), psi.numpy(), jgens, N, cap=16)
    assert e == pytest.approx(e_ref, abs=TOL)
    np.testing.assert_allclose(Hd.numpy(), Hd_ref, rtol=0, atol=TOL)
    assert info["labels"] == info_ref["labels"] and info["selected"] == info_ref["selected"]
    for key in ("E0", "E_pred", "gain", "best_single_gain", "a0"):
        assert info[key] == pytest.approx(info_ref[key], abs=TOL)
    # the predicted energy is the folded H's at psi, and the spectrum is kept
    assert float(torch.real(torch.vdot(psi, Hd @ psi))) == pytest.approx(e, abs=TOL)
    np.testing.assert_allclose(torch.linalg.eigvalsh(Hd).numpy(), torch.linalg.eigvalsh(H).numpy(),
                               rtol=0, atol=1e-9)
    assert info["gain"] > 0
