"""The port's gate-level export (``qsfh_torch/ops/export.py``) against the
JAX module: every function's output equal, the QASM text included, on
Hubbard pool generators, a molecular Hamiltonian and hand-made strings;
``to_sparse_pauli_op`` raises ``ImportError`` without qiskit, as the JAX
one does.
"""

import importlib.util

import numpy as np
import pytest

from qsfh_tpu.ops import export as J
from qsfh_tpu.ops.jw import jordan_wigner as jax_jw
from qsfh_tpu.ops.pauli import PauliSum as JaxPauliSum
from qsfh_tpu.ops.pool import hubbard_interaction_pool_simplified as jax_pool
from qsfh_torch.ops import export as T
from qsfh_torch.ops.jw import jordan_wigner
from qsfh_torch.ops.pauli import PauliSum
from qsfh_torch.ops.pool import hubbard_interaction_pool_simplified as pool


def _pairs():
    """(JAX PauliSum, port PauliSum) of the same operators."""
    out = [(jax_jw(a), jordan_wigner(b)) for a, b in zip(jax_pool(2, 2)[:12], pool(2, 2)[:12])]
    terms = [("X0 Y3 Z5", 0.5), ("Z1", -1.25), ("", 0.75), ("Y2 Y4", 2j)]
    out.append((JaxPauliSum.from_terms(terms), PauliSum.from_terms(terms)))
    return out


def test_sparse_list_and_process_strings_equal():
    for jop, top in _pairs():
        assert T.to_sparse_list(top) == J.to_sparse_list(jop)
        assert T.process_pauli_strings(top) == J.process_pauli_strings(jop)


def test_generator_gates_and_qasm_equal():
    for k, (jop, top) in enumerate(_pairs()[:-1]):
        theta = 0.1 + 0.37 * k
        got = T.generator_rotation_gates(theta, top)
        assert got == J.generator_rotation_gates(theta, jop)
        assert T.to_qasm2(got, 8) == J.to_qasm2(got, 8)


@pytest.mark.parametrize("letters,wires", [(["Z"], [0]), (["X", "Y"], [0, 3]),
                                           (["Y", "X", "X"], [1, 0, 2])])
def test_pauli_rotation_gates_equal(letters, wires):
    got = T.pauli_rotation_gates(np.float64(0.731), (letters, wires))
    assert got == J.pauli_rotation_gates(np.float64(0.731), (letters, wires))
    assert T.to_qasm2(got, 4) == J.to_qasm2(got, 4)


def test_argument_checks():
    for bad in ((["X"], []), (["X", "Y"], [0]), (["Q"], [0])):
        with pytest.raises(ValueError):
            T.pauli_rotation_gates(0.1, bad)
    with pytest.raises(ValueError, match="unknown gate"):
        T.to_qasm2([("h", (0,), 0.0)], 1)


@pytest.mark.skipif(importlib.util.find_spec("qiskit") is not None, reason="qiskit installed")
def test_to_sparse_pauli_op_needs_qiskit():
    _, top = _pairs()[0]
    with pytest.raises(ImportError, match="qiskit"):
        T.to_sparse_pauli_op(top, 8)
