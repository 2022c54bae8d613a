"""The frozen bound arithmetic (pb/bounds.py) against hand counts."""

import numpy as np
import pytest

from pb import bounds

CFG_2X2 = dict(x_dimension=2, y_dimension=2, periodic=True)


def test_hamiltonian_counts_by_hand():
    # 2x2 periodic: one bond a direction and row or column, 4 bonds, 8
    # (bond, spin) hops of 2 strings and one mask each; 3 diagonal strings a
    # site (Z up, Z down, Z Z) and the identity
    assert bounds.hamiltonian_counts(CFG_2X2) == (9, 16 + 13, 13)
    # 3x3 periodic: 18 bonds, 36 hops
    assert bounds.hamiltonian_counts(dict(x_dimension=3, y_dimension=3)) == (37, 100, 28)


@pytest.mark.parametrize("nx,ny,up", [(2, 2, 2), (3, 3, 5), (2, 6, 6)])
def test_hamiltonian_counts_are_the_ports(nx, ny, up):
    from qsfh_torch.algos.base import HubbardProblem

    p = HubbardProblem(nx, ny, 1.0, 6.0, nx * ny, up, nx * ny - up)
    xs = p.observables["H"]._scan_terms()[0]
    assert bounds.hamiltonian_counts(dict(x_dimension=nx, y_dimension=ny)) == (
        len(np.unique(xs)), len(xs), int((xs == 0).sum()))


def test_train_least_by_hand():
    n, dim, k = 8, 256, 2
    g = bounds.n_givens(2, 2)
    assert 0 < g <= n * (n - 1) // 2
    T = 8 * 3 + 2 * g  # three generators
    fwd = max((2 * 8 * dim + 16 * T) / 3.35e12, 6 * T * dim / 67e12)
    adj = max((4 * 8 * dim + 16 * T + 12) / 3.35e12, 20 * T * dim / 67e12)
    e_flops = (6 * 9 + 2 * 29 - (3 + 13)) * dim
    h_flops = (4 * 9 + 29) * dim
    step_b = (2 + 4 + 1 + 2) * 8 * dim + 32 * T + 12 + 48 * 29
    step_f = (26 * T) * dim + e_flops + h_flops
    least = bounds.train_least(CFG_2X2, 3, k)
    assert least["terms"] == T
    assert least["fwd_s"] == pytest.approx(fwd, rel=1e-12)
    assert least["adj_s"] == pytest.approx(adj, rel=1e-12)
    assert least["step_s"] == pytest.approx(max(step_b / 3.35e12, step_f / 67e12), rel=1e-12)
    chunk_f = k * step_f + 6 * T * dim
    chunk_b = k * step_b + 2 * 8 * dim + 16 * T
    assert least["chunk_s"] == pytest.approx(max(chunk_b / 3.35e12, chunk_f / 67e12), rel=1e-12)


def test_polish_least_by_hand():
    dim = 256
    G = 3 + bounds.n_givens(2, 2)
    T = 24 + 2 * bounds.n_givens(2, 2)
    flops = (23 * G + 8 + 4 * 9 + 29) * dim
    nbytes = 16 * dim + 12 * (T + G) + 24 * 29 + 48
    assert bounds.polish_eval_least(CFG_2X2, 3) == pytest.approx(
        max(nbytes / 3.35e12, flops / 34e12), rel=1e-12)


def test_flagship_counts_bound_the_ports_lowering():
    """The counted terms and groups of the 1719-operator ansatz are no more
    than the port's own lowering applies (14123 terms in 1931 groups), so
    a share of the least time is never overstated by the count."""
    cfg = dict(x_dimension=3, y_dimension=3)
    assert bounds.rotation_terms(cfg, 1719) == 8 * 1719 + 2 * 144 <= 14123
    assert bounds.rotation_groups(cfg, 1719) == 1719 + 144 <= 1931
    assert bounds.rotation_terms(dict(x_dimension=2, y_dimension=6), 6) <= 718
