"""The port's numpy merge and single-string dressing against the JAX
package's C++ ones.

From 2048 terms the JAX package's ``PauliSum.simplify`` and ``dress_once``
(for one Hermitian string P) switch to ``qsfh_tpu.native.merge_terms`` /
``dress_emit`` (``qsfh_tpu/ops/pauli.py:155-161``,
``qsfh_tpu/ops/dressing.py:66-72``); the port keeps the numpy path at every
size.  On seeded random sums of 3000-5000 terms over 16 qubits, with
duplicate strings and exactly cancelling pairs, both give the same strings
in the same (x, z) order and coefficients within 1e-14 (relative, or of
the largest where a sum nearly cancels).  The JAX calls are held to the
native path: each test counts its calls.
"""

import numpy as np
import pytest

from qsfh_tpu import native
from qsfh_tpu.ops import dressing as jax_dressing
from qsfh_tpu.ops.pauli import PauliSum as JaxPauliSum
from qsfh_torch.ops.dressing import dress_once
from qsfh_torch.ops.pauli import PauliSum

N_QUBITS = 16
SIZES = (3000, 4000, 5000)
RTOL = 1e-14


@pytest.fixture
def counted(monkeypatch):
    """The native entry points, wrapped to count the JAX package's calls."""
    if not native.available():
        pytest.skip("the JAX package's native library is unavailable")
    calls = {"merge_terms": 0, "dress_emit": 0}
    for name in calls:
        fn = getattr(native, name)

        def wrapped(*args, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*args)

        monkeypatch.setattr(native, name, wrapped)
    return calls


def _random_sum(seed: int, size: int):
    """(x, z, c): size terms drawn from 2 size strings (~20% repeats), with 50
    exactly cancelling pairs."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << N_QUBITS, size=(2 * size, 2), dtype=np.uint64)
    pick = rng.integers(0, len(pool), size=size - 100)
    x, z = pool[pick, 0], pool[pick, 1]
    c = rng.standard_normal(len(x)) + 1j * rng.standard_normal(len(x))
    cx = rng.integers(0, 1 << N_QUBITS, size=50, dtype=np.uint64)
    cz = rng.integers(0, 1 << N_QUBITS, size=50, dtype=np.uint64)
    cc = rng.standard_normal(50) + 1j * rng.standard_normal(50)
    return (np.concatenate([x, cx, cx]), np.concatenate([z, cz, cz]),
            np.concatenate([c, cc, -cc]))


def _assert_same(ours: PauliSum, ref: JaxPauliSum):
    np.testing.assert_array_equal(ours.x, ref.x)
    np.testing.assert_array_equal(ours.z, ref.z)
    np.testing.assert_allclose(ours.c, ref.c, rtol=RTOL, atol=RTOL * np.abs(ref.c).max())


@pytest.mark.parametrize("size", SIZES)
def test_simplify_matches_native_merge(counted, size):
    x, z, c = _random_sum(size, size)
    ref = JaxPauliSum(x.copy(), z.copy(), c.copy()).simplify()
    assert counted["merge_terms"] == 1
    ours = PauliSum(x.copy(), z.copy(), c.copy()).simplify()
    assert len(ours) < size - 100  # duplicates merged, the cancelling pairs dropped
    _assert_same(ours, ref)


@pytest.mark.parametrize("size", SIZES)
def test_dress_once_matches_native_dress_emit(counted, size):
    x, z, c = _random_sum(size + 1, size)
    H, jH = PauliSum(x, z, c).simplify(), JaxPauliSum(x, z, c).simplify()
    rng = np.random.default_rng(size + 2)
    px, pz = (int(v) for v in rng.integers(1, 1 << N_QUBITS, size=2))
    pc = 1.0 if bin(px & pz).count("1") % 2 == 0 else 1j  # Hermitian: pc^2 (-1)^{|px&pz|} = 1
    tau = 0.37
    counted["merge_terms"] = 0
    ref = jax_dressing.dress_once(jH, JaxPauliSum([px], [pz], [pc]), tau)
    assert counted["dress_emit"] == 1 and counted["merge_terms"] == 1
    ours = dress_once(H, PauliSum([px], [pz], [pc]), tau)
    _assert_same(ours, ref)
