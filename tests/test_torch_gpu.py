"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test skips from inside its fixture where no CUDA
device exists.  Run on a machine with a card (the JAX conftest is not
needed there):

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerance: ||kernel - plain|| / ||plain|| <= 1e-5 on states and on the
per-term vectors, which is float32 rounding over differently ordered sums.
"""

import numpy as np
import pytest
import torch

from qsfh_torch.engine import kernels as K

pytestmark = pytest.mark.gpu

RTOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _terms(rng, n, T):
    """Random flat masks (x = 0 terms included) and unit string phases."""
    xs = rng.integers(0, 1 << n, size=T)
    xs[:: 4] = 0
    zs = rng.integers(0, 1 << n, size=T)
    k = rng.integers(0, 4, size=T)
    ph = (-1j) ** k
    return xs, zs, ph


def _state(rng, n):
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return v / np.linalg.norm(v)


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _t(a, dev, dtype):
    return torch.as_tensor(a).to(device=dev, dtype=dtype)


@pytest.mark.parametrize("n", [10, 18])
def test_pauli_rotation(dev, n):
    rng = np.random.default_rng(n)
    xs, zs, ph = _terms(rng, n, 64)
    ang = rng.uniform(-1, 1, size=64)
    psi = _t(_state(rng, n), dev, torch.complex64)
    args = (_t(xs, dev, torch.int64), _t(zs, dev, torch.int64), _t(ang, dev, torch.float32),
            _t(ph.real, dev, torch.float32), _t(ph.imag, dev, torch.float32))
    got = K.pauli_rotation(psi.clone(), *args)
    ref = K.pauli_rotation_plain(psi.clone(), *args)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= RTOL


@pytest.mark.parametrize("n", [10, 18])
def test_pauli_apply(dev, n):
    rng = np.random.default_rng(n + 1)
    xs, zs, _ = _terms(rng, n, 300)
    c = rng.standard_normal(300) + 1j * rng.standard_normal(300)
    psi = _t(_state(rng, n), dev, torch.complex64)
    args = (_t(xs, dev, torch.int64), _t(zs, dev, torch.int64),
            _t(c.real, dev, torch.float32), _t(c.imag, dev, torch.float32))
    got = K.pauli_apply(psi, *args)
    ref = K.pauli_apply_plain(psi, *args)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= RTOL


@pytest.mark.parametrize("n", [10, 18])
def test_pauli_inner(dev, n):
    rng = np.random.default_rng(n + 2)
    xs, zs, _ = _terms(rng, n, 200)
    psi = _t(_state(rng, n), dev, torch.complex64)
    w = _t(_state(rng, n), dev, torch.complex64)
    args = (_t(xs, dev, torch.int64), _t(zs, dev, torch.int64))
    for a in (psi, w):
        got = K.pauli_inner(a, psi, *args)
        ref = K.pauli_inner_plain(a, psi, *args)
        torch.cuda.synchronize()
        assert _rel(got, ref) <= RTOL


@pytest.mark.parametrize("n", [10, 18])
def test_adjoint_rotation(dev, n):
    rng = np.random.default_rng(n + 3)
    xs, zs, ph = _terms(rng, n, 64)
    ang = rng.uniform(-1, 1, size=64)
    psi = _t(_state(rng, n), dev, torch.complex64)
    lam = _t(_state(rng, n), dev, torch.complex64)
    args = (_t(xs, dev, torch.int64), _t(zs, dev, torch.int64), _t(ang, dev, torch.float32),
            _t(ph.real, dev, torch.float32), _t(ph.imag, dev, torch.float32))
    p1, l1 = psi.clone(), lam.clone()
    p2, l2 = psi.clone(), lam.clone()
    got = K.adjoint_rotation(p1, l1, *args)
    ref = K.adjoint_rotation_plain(p2, l2, *args)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= RTOL
    assert _rel(p1, p2) <= RTOL
    assert _rel(l1, l2) <= RTOL


def test_launch_counts_and_dtype_guard(dev):
    rng = np.random.default_rng(7)
    n = 10
    xs, zs, ph = _terms(rng, n, 5)
    psi = _t(_state(rng, n), dev, torch.complex64)
    args = (_t(xs, dev, torch.int64), _t(zs, dev, torch.int64), _t(np.ones(5), dev, torch.float32),
            _t(ph.real, dev, torch.float32), _t(ph.imag, dev, torch.float32))
    K.reset_launch_counts()
    K.pauli_rotation(psi, *args)
    K.pauli_inner(psi, psi, *args[:2])
    assert K.launch_counts()["pauli_rotation"] == 5
    assert K.launch_counts()["pauli_inner"] == 1
    with pytest.raises(TypeError):
        K.pauli_rotation(psi.to(torch.complex128), *args)


def _local_terms(rng, n, T, bits):
    """Random terms whose flip masks stay below bit ``bits`` (z masks reach
    every bit, x = 0 terms included)."""
    xs, zs, ph = _terms(rng, n, T)
    return xs & ((1 << bits) - 1), zs, ph


@pytest.mark.parametrize("n,bits", [(10, 6), (20, 14)])
def test_rotation_local_runs(dev, n, bits):
    rng = np.random.default_rng(n + 4)
    xs, zs, ph = _local_terms(rng, n, 48, bits)
    ang = rng.uniform(-1, 1, size=48)
    psi = _t(_state(rng, n), dev, torch.complex64)
    args = (_t(xs, dev, torch.int64), _t(zs, dev, torch.int64), _t(ang, dev, torch.float32),
            _t(ph.real, dev, torch.float32), _t(ph.imag, dev, torch.float32))
    got = K.rotation_local_runs(psi.clone(), *args, bits)
    ref = K.rotation_local_runs_plain(psi.clone(), *args, bits)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= RTOL


@pytest.mark.parametrize("n,bits", [(10, 6), (20, 13)])
def test_adjoint_local_runs(dev, n, bits):
    rng = np.random.default_rng(n + 5)
    xs, zs, ph = _local_terms(rng, n, 48, bits)
    ang = rng.uniform(-1, 1, size=48)
    psi = _t(_state(rng, n), dev, torch.complex64)
    lam = _t(_state(rng, n), dev, torch.complex64)
    args = (_t(xs, dev, torch.int64), _t(zs, dev, torch.int64), _t(ang, dev, torch.float32),
            _t(ph.real, dev, torch.float32), _t(ph.imag, dev, torch.float32))
    p1, l1, p2, l2 = psi.clone(), lam.clone(), psi.clone(), lam.clone()
    got = K.adjoint_local_runs(p1, l1, *args, bits)
    ref = K.adjoint_local_runs_plain(p2, l2, *args, bits)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= RTOL
    assert _rel(p1, p2) <= RTOL
    assert _rel(l1, l2) <= RTOL


@pytest.mark.parametrize("n", [10, 20])
def test_pauli_inner_grouped(dev, n, monkeypatch):
    from qsfh_torch.engine.streaming import GroupLayout

    rng = np.random.default_rng(n + 6)
    # a few flip masks, one of them with more terms than one group pass takes
    xs = rng.choice(rng.integers(0, 1 << n, size=12), size=700)
    xs[:300] = xs[0]
    zs = rng.integers(0, 1 << n, size=700)
    layout = GroupLayout(xs, zs)
    psi = _t(_state(rng, n), dev, torch.complex64)
    w = _t(_state(rng, n), dev, torch.complex64)
    args = (_t(xs, dev, torch.int64), _t(zs, dev, torch.int64))
    # small partials scratch: the groups go in several launches
    monkeypatch.setattr(K, "PARTIALS_CAP", 64 * K._load().qsfh_group_blocks(n))
    K.reset_launch_counts()
    for a in (psi, w):
        got = K.pauli_inner_grouped(a, psi, *args, layout)
        ref = K.pauli_inner_plain(a, psi, *args)
        torch.cuda.synchronize()
        assert _rel(got, ref) <= RTOL
    assert K.launch_counts()["pauli_inner_grouped"] > 2
