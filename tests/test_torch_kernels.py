"""The port's plain kernel versions against the JAX functions they stand for.

* complex64: the five Pallas chain kernels of the main path, called
  directly; on the CPU they run in interpret mode, as tests/test_pallas.py
  runs them.  n = 10-11, 24 random terms, x = 0 terms included.  Tolerance
  ||delta|| / ||ref|| <= 1e-5 on states and 1e-5 relative on scalars:
  float32 rounding.
* complex128: the XLA scan path (QSFH_PALLAS unset) within 1e-10.

Inputs are made with numpy from fixed seeds and handed to both frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsfh_tpu.engine import compiled as jc
from qsfh_tpu.engine.expectation import Observable as JaxObservable
from qsfh_tpu.engine.expectation import PackedPool as JaxPool
from qsfh_tpu.engine.pallas_kernels import (
    HAVE_PALLAS,
    adjoint_chain_pallas,
    apply_chain_pallas,
    expectation_chain_pallas,
    pauli_chain_pallas,
    screen_chain_pallas,
)
from qsfh_tpu.ops.pauli import PauliSum
from qsfh_torch.engine import kernels as K

T = 24
RTOL32 = 1e-5
TOL64 = 1e-10

pallas = pytest.mark.skipif(not HAVE_PALLAS, reason="pallas unavailable")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _state(rng, n, dtype=np.complex64):
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return (v / np.linalg.norm(v)).astype(dtype)


def _flat_terms(rng, n, count=T):
    """Random flat masks (every 4th an x = 0 term) and string phases."""
    xs = rng.integers(0, 1 << n, size=count).astype(np.uint32)
    xs[::4] = 0
    zs = rng.integers(0, 1 << n, size=count).astype(np.uint32)
    ph = np.array([(-1j) ** (bin(int(x) & int(z)).count("1") % 4) for x, z in zip(xs, zs)])
    return xs, zs, ph


def _t(a, dtype=None):
    t = torch.as_tensor(np.asarray(a))
    if t.dtype == torch.uint32:
        t = t.to(torch.int64)
    return t if dtype is None else t.to(dtype)


def _masks(xs, zs):
    return _t(xs.astype(np.int64)), _t(zs.astype(np.int64))


# -- complex64: Pallas chain kernels in interpret mode ---------------------------


@pallas
@pytest.mark.parametrize("n", [10, 11])
def test_rotation_vs_pauli_chain_pallas(n):
    rng = np.random.default_rng(100 + n)
    xs, zs, ph = _flat_terms(rng, n)
    ang = rng.uniform(-1.5, 1.5, size=T).astype(np.float32)
    psi = _state(rng, n)
    ref = pauli_chain_pallas(jnp.asarray(psi), n, jnp.asarray(xs), jnp.asarray(zs),
                             jnp.asarray(ang), jnp.asarray(ph.real, jnp.float32),
                             jnp.asarray(ph.imag, jnp.float32))
    got = K.pauli_rotation(_t(psi), *_masks(xs, zs), _t(ang),
                           _t(ph.real, torch.float32), _t(ph.imag, torch.float32))
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), ref) <= RTOL32


@pallas
@pytest.mark.parametrize("n", [10, 11])
def test_apply_vs_apply_chain_pallas(n):
    rng = np.random.default_rng(200 + n)
    xs, zs, _ = _flat_terms(rng, n)
    c = (rng.standard_normal(T) + 1j * rng.standard_normal(T)).astype(np.complex64)
    psi = _state(rng, n)
    ref = apply_chain_pallas(jnp.asarray(psi), n, jnp.asarray(xs), jnp.asarray(zs),
                             jnp.asarray(c.real), jnp.asarray(c.imag))
    got = K.pauli_apply(_t(psi), *_masks(xs, zs), _t(c.real), _t(c.imag))
    assert _rel(got.numpy(), ref) <= RTOL32


@pallas
@pytest.mark.parametrize("n", [10, 11])
def test_inner_vs_expectation_chain_pallas(n):
    rng = np.random.default_rng(300 + n)
    xs, zs, _ = _flat_terms(rng, n)
    c = (rng.standard_normal(T) + 1j * rng.standard_normal(T)).astype(np.complex64)
    psi = _state(rng, n)
    ref = float(expectation_chain_pallas(jnp.asarray(psi), n, jnp.asarray(xs), jnp.asarray(zs),
                                         jnp.asarray(c.real), jnp.asarray(c.imag)))
    v = K.pauli_inner(_t(psi), _t(psi), *_masks(xs, zs))
    got = float((_t(c) * v).real.sum())
    assert abs(got - ref) <= RTOL32 * max(1.0, abs(ref))


@pallas
@pytest.mark.parametrize("n", [10, 11])
def test_inner_vs_screen_chain_pallas(n):
    rng = np.random.default_rng(400 + n)
    xs, zs, _ = _flat_terms(rng, n)
    c = (rng.standard_normal(T) + 1j * rng.standard_normal(T)).astype(np.complex64)
    psi, w = _state(rng, n), _state(rng, n)
    ref = np.asarray(screen_chain_pallas(jnp.asarray(psi), jnp.asarray(w), n, jnp.asarray(xs),
                                         jnp.asarray(zs), jnp.asarray(c.real), jnp.asarray(c.imag)))
    v = K.pauli_inner(_t(w), _t(psi), *_masks(xs, zs))
    got = (2.0 * (_t(c) * v).imag).numpy()
    assert _rel(got, ref) <= RTOL32


@pallas
@pytest.mark.parametrize("n", [10, 11])
def test_adjoint_vs_adjoint_chain_pallas(n):
    rng = np.random.default_rng(500 + n)
    xs, zs, ph = _flat_terms(rng, n)
    ang = rng.uniform(-1.5, 1.5, size=T).astype(np.float32)
    scale = rng.uniform(-1, 1, size=T).astype(np.float32)
    psi, lam = _state(rng, n), _state(rng, n)
    rpsi, rlam, rcontrib = adjoint_chain_pallas(
        jnp.asarray(psi), jnp.asarray(lam), n, jnp.asarray(xs), jnp.asarray(zs),
        jnp.asarray(ang), jnp.asarray(scale), jnp.asarray(ph.real, jnp.float32),
        jnp.asarray(ph.imag, jnp.float32),
    )
    tpsi, tlam = _t(psi), _t(lam)
    v = K.adjoint_rotation(tpsi, tlam, *_masks(xs, zs), _t(ang),
                           _t(ph.real, torch.float32), _t(ph.imag, torch.float32))
    contrib = (_t(scale) * v.imag).numpy()
    assert _rel(tpsi.numpy(), rpsi) <= RTOL32
    assert _rel(tlam.numpy(), rlam) <= RTOL32
    assert _rel(contrib, rcontrib) <= RTOL32


# -- complex128: the XLA scan path --------------------------------------------------


def _qubit_terms(rng, n, count):
    """Random qubit-indexed (x, z) masks, every 4th diagonal."""
    xq = rng.integers(0, 1 << n, size=count)
    xq[::4] = 0
    zq = rng.integers(0, 1 << n, size=count)
    return [int(v) for v in xq], [int(v) for v in zq]


@pytest.mark.parametrize("n", [10, 12])
def test_rotation_vs_xla_scan(n):
    rng = np.random.default_rng(600 + n)
    xq, zq = _qubit_terms(rng, n, T)
    thetas = rng.uniform(-1, 1, size=T)
    # one parameter per term: no commuting-group fusion on the JAX side
    ops = [("rot", ((x, z, 1.0),), t) for t, (x, z) in enumerate(zip(xq, zq))]
    seg = jc.lower_program(ops, n)
    psi = _state(rng, n, np.complex128)
    ref = np.asarray(jc.run_segments(seg, jnp.asarray(psi), jnp.asarray(thetas), n))
    d = seg[0].data
    got = K.pauli_rotation(_t(psi), *_masks(d["xb"], d["zb"]), _t(thetas),
                           _t(d["phre"]), _t(d["phim"]))
    assert _rel(got.numpy(), ref) <= TOL64


def _random_paulisum(rng, n, count):
    xq, zq = _qubit_terms(rng, n, count)
    c = rng.standard_normal(count) + 1j * rng.standard_normal(count)
    return PauliSum(np.array(xq, np.uint64), np.array(zq, np.uint64), c)


@pytest.mark.parametrize("n", [10, 12])
def test_apply_and_inner_vs_xla_scan(n):
    rng = np.random.default_rng(700 + n)
    obs = JaxObservable(_random_paulisum(rng, n, T), n)
    xs, zs, cre, cim = obs._scan_terms()
    psi = _state(rng, n, np.complex128)
    ref_apply = np.asarray(obs.apply_scan(jnp.asarray(psi)))
    ref_exp = float(obs.expectation_scan(jnp.asarray(psi)))
    got_apply = K.pauli_apply(_t(psi), *_masks(xs, zs), _t(cre), _t(cim))
    v = K.pauli_inner(_t(psi), _t(psi), *_masks(xs, zs))
    got_exp = float((torch.complex(_t(cre), _t(cim)) * v).real.sum())
    assert _rel(got_apply.numpy(), ref_apply) <= TOL64
    assert abs(got_exp - ref_exp) <= TOL64 * max(1.0, abs(ref_exp))


@pytest.mark.parametrize("n", [10, 12])
def test_adjoint_vs_xla_scan(n):
    rng = np.random.default_rng(800 + n)
    xq, zq = _qubit_terms(rng, n, T)
    scale = rng.uniform(-1, 1, size=T)
    thetas = rng.uniform(-1, 1, size=T)
    ops = [("rot", ((x, z, float(s)),), t) for t, (x, z, s) in enumerate(zip(xq, zq, scale))]
    seg = jc.lower_program(ops, n)[0]
    psi, lam = _state(rng, n, np.complex128), _state(rng, n, np.complex128)
    rpsi, rlam, rgrads = jc.run_rot_adjoint(seg, jnp.asarray(psi), jnp.asarray(lam),
                                            jnp.asarray(thetas), n)
    d = seg.data
    rev = slice(None, None, -1)
    tpsi, tlam = _t(psi), _t(lam)
    v = K.adjoint_rotation(tpsi, tlam, *_masks(d["xb"][rev].copy(), d["zb"][rev].copy()),
                           _t((thetas * d["scale"])[rev].copy()),
                           _t(d["phre"][rev].copy()), _t(d["phim"][rev].copy()))
    grads = (_t(d["scale"][rev].copy()) * v.imag).flip(0).numpy()
    assert _rel(tpsi.numpy(), np.asarray(rpsi)) <= TOL64
    assert _rel(tlam.numpy(), np.asarray(rlam)) <= TOL64
    assert _rel(grads, np.asarray(rgrads)) <= TOL64


@pytest.mark.parametrize("n", [10, 12])
def test_screen_vs_xla_scan(n):
    rng = np.random.default_rng(900 + n)
    gens = [_random_paulisum(rng, n, 6) for _ in range(8)]
    pool = JaxPool(gens, n)
    xs, zs, cre, cim, ks = pool.scan_arrays()
    psi, w = _state(rng, n, np.complex128), _state(rng, n, np.complex128)
    ref = np.asarray(pool.screen_scan(jnp.asarray(psi), jnp.asarray(w)))
    v = K.pauli_inner(_t(w), _t(psi), *_masks(xs, zs))
    contrib = 2.0 * (torch.complex(_t(cre), _t(cim)) * v).imag
    got = torch.zeros(len(gens), dtype=torch.float64).index_add_(0, _t(ks.astype(np.int64)), contrib)
    assert _rel(got.numpy(), ref) <= TOL64


def test_cpu_wrappers_take_the_plain_versions():
    """On CPU tensors the wrappers compute the plain version and launch
    nothing."""
    rng = np.random.default_rng(1)
    n = 6
    xs, zs, ph = _flat_terms(rng, n, 5)
    psi = _t(_state(rng, n, np.complex128))
    args = (*_masks(xs, zs), _t(np.full(5, 0.3)), _t(ph.real), _t(ph.imag))
    K.reset_launch_counts()
    a = K.pauli_rotation(psi.clone(), *args)
    b = K.pauli_rotation_plain(psi.clone(), *args)
    assert torch.equal(a, b)
    assert all(v == 0 for v in K.launch_counts().values())
    assert jax.devices()[0].platform == "cpu"


def test_wrappers_reject_other_devices():
    """A wrapper computes the plain version only for CPU tensors; any other
    device that is not CUDA raises instead of falling back."""
    psi = torch.empty(1 << 10, dtype=torch.complex64, device="meta")
    masks = torch.zeros(3, dtype=torch.int64, device="meta")
    scal = torch.zeros(3, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        K.pauli_rotation(psi, masks, masks, scal, scal, scal)
    with pytest.raises(ValueError, match="CUDA"):
        K.pauli_apply(psi, masks, masks, scal, scal)
    with pytest.raises(ValueError, match="CUDA"):
        K.pauli_inner(psi, psi, masks, masks)
    with pytest.raises(ValueError, match="CUDA"):
        K.adjoint_rotation(psi, psi, masks, masks, scal, scal, scal)
