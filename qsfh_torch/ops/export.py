"""Gate-level circuit export / interop helpers.

Counterpart of ``qsfh_tpu/ops/export.py`` (host only): a sparse-list
operator export, the rotation-angle preprocessing, and the explicit
basis-change + CNOT-ladder + RZ decomposition of exp(-i theta P/2) that
the engine's rotation kernels replace, emitted as a portable gate plan,
plus an OpenQASM 2.0 writer.  ``to_sparse_pauli_op`` builds a qiskit
``SparsePauliOp`` where qiskit is importable and raises ``ImportError``
otherwise.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .pauli import PauliSum

Gate = Tuple[str, Tuple[int, ...], float]  # (name, wires, param; 0.0 if none)


def to_sparse_list(op: PauliSum) -> List[Tuple[str, List[int], complex]]:
    """PauliSum -> [(pauli_letters, qubit_indices, coeff)] sparse triplets
    (``SparsePauliOp.from_sparse_list`` input), with coefficients in the
    Hermitian Y-string convention."""
    out = []
    for s, c in op.to_terms():
        letters = ""
        idx: List[int] = []
        for token in s.split():
            letters += token[0]
            idx.append(int(token[1:]))
        out.append((letters, idx, complex(c)))
    return out


def to_sparse_pauli_op(op: PauliSum, num_qubits: int):
    """Build a qiskit ``SparsePauliOp`` (requires qiskit at call time)."""
    try:
        from qiskit.quantum_info import SparsePauliOp  # type: ignore
    except ImportError as e:
        raise ImportError(
            "qiskit is not installed; use to_sparse_list() for the "
            "framework-neutral sparse-triplet export"
        ) from e
    return SparsePauliOp.from_sparse_list(to_sparse_list(op), num_qubits=num_qubits)


def process_pauli_strings(
    op: PauliSum,
) -> Tuple[List[Tuple[List[str], List[int]]], List[float]]:
    """Split an anti-Hermitian generator into (strings, angle scales): each
    term's rotation angle scale is ``(coeff * 2j).real``.  The identity, a
    global phase no rotation can express, is skipped."""
    strings: List[Tuple[List[str], List[int]]] = []
    coeffs: List[float] = []
    for letters, idx, c in to_sparse_list(op):
        if not idx:
            continue
        strings.append((list(letters), idx))
        coeffs.append(float((c * 2j).real))
    return strings, coeffs


def pauli_rotation_gates(
    theta: float, pauli_string: Tuple[Sequence[str], Sequence[int]]
) -> List[Gate]:
    """Gate plan for exp(-i theta P / 2): RY(-pi/2) / RX(pi/2) basis
    changes, a CNOT parity ladder down to the last wire, RZ(theta), then
    the uncompute."""
    paulis, wires = list(pauli_string[0]), list(pauli_string[1])
    if len(paulis) != len(wires) or not wires:
        raise ValueError("pauli_string must be (letters, wires) of equal length >= 1")
    ops: List[Gate] = []
    for p, q in zip(paulis, wires):
        if p == "X":
            ops.append(("ry", (q,), -np.pi / 2))
        elif p == "Y":
            ops.append(("rx", (q,), np.pi / 2))
        elif p != "Z":
            raise ValueError(f"bad Pauli letter: {p}")
    for q, q_next in zip(wires[:-1], wires[1:]):
        ops.append(("cx", (q, q_next), 0.0))
    ops.append(("rz", (wires[-1],), float(theta)))
    for q, q_next in zip(reversed(wires[:-1]), reversed(wires[1:])):
        ops.append(("cx", (q, q_next), 0.0))
    for p, q in zip(paulis, wires):
        if p == "X":
            ops.append(("ry", (q,), np.pi / 2))
        elif p == "Y":
            ops.append(("rx", (q,), -np.pi / 2))
    return ops


def generator_rotation_gates(theta: float, generator: PauliSum) -> List[Gate]:
    """Gate plan for first-order-Trotter exp(-i theta * G), G Hermitian: one
    :func:`pauli_rotation_gates` block per non-identity term with angle
    ``2 * theta * Re(coeff)``, from the same ``rotation_terms()`` list the
    engine's rotations consume."""
    ops: List[Gate] = []
    for x, z, scale in generator.rotation_terms():
        letters, wires = _mask_string(x, z)
        ops.extend(pauli_rotation_gates(2.0 * theta * scale, (letters, wires)))
    return ops


def _mask_string(x: int, z: int) -> Tuple[List[str], List[int]]:
    """Packed (x, z) masks -> (pauli letters, qubit indices), Y-string form."""
    letters: List[str] = []
    wires: List[int] = []
    q = 0
    m = x | z
    while m >> q:
        bx, bz = (x >> q) & 1, (z >> q) & 1
        if bx and bz:
            letters.append("Y")
        elif bx:
            letters.append("X")
        elif bz:
            letters.append("Z")
        if bx or bz:
            wires.append(q)
        q += 1
    return letters, wires


def to_qasm2(ops: Sequence[Gate], n_qubits: int) -> str:
    """Serialize a gate plan to OpenQASM 2.0 (ry/rx/rz/cx only)."""
    lines = [
        "OPENQASM 2.0;",
        'include "qelib1.inc";',
        f"qreg q[{n_qubits}];",
    ]
    for name, wires, param in ops:
        if name == "cx":
            lines.append(f"cx q[{wires[0]}],q[{wires[1]}];")
        elif name in ("rx", "ry", "rz"):
            lines.append(f"{name}({float(param)!r}) q[{wires[0]}];")
        else:
            raise ValueError(f"unknown gate: {name}")
    return "\n".join(lines) + "\n"
