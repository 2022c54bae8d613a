"""Givens decomposition of a square unitary into an adjacent-pair rotation plan.

Replaces OpenFermion's ``givens_decomposition_square`` (consumed at
``reference/models/hva.py:186-187``): the plan format is the same --
``(decomposition, diagonal)`` where ``decomposition`` is a list of layers of
``(i, j, theta, phi)`` rotations on adjacent wires and ``diagonal`` holds the
leftover unit-modulus phases -- so the reference's state-preparation circuit
structure (X on occupied modes, per-wire RZ(angle(diagonal)), then
``reversed(decomposition)`` of ``SingleExcitation(2 theta) + RZ(phi)``)
carries over unchanged.

Derivation (independent of OpenFermion's implementation):

A particle-number-conserving circuit W induces a single-particle mode map
``W a^dag_p W^dag = sum_q M_qp a^dag_q``.  The gates used here act on
*adjacent* wires, so no Jordan-Wigner strings appear and the maps compose as
plain matrices:

  * SingleExcitation(2 theta) on (i, i+1):  block [[c, s], [-s, c]],
    c = cos(theta), s = sin(theta)
  * RZ(phi) on wire j: diag(..., e^{i phi} at j, ...) up to global phase

To prepare the Slater determinant ``prod_{k in S} b^dag_k |0>`` with
``b^dag_k = sum_m Q[k, m] a^dag_m`` starting from X gates on wires S, the
circuit's total mode map must equal ``Q^T``.  Writing the applied gate
sequence as ``V_L ... V_1 . D`` (D = the RZ(diagonal) layer), we need

    V_1^dag ... V_L^dag Q^T = D  (diagonal),

i.e. eliminate Q^T to a diagonal with adjacent-row complex Givens rotations
of the specific inverse-gate form

    V^dag(theta, phi) = [[cos t, -e^{-i phi} sin t], [sin t, e^{-i phi} cos t]].

The eliminations are recorded in order; the circuit applies them REVERSED --
exactly the ``list(reversed(decomposition))`` convention of the reference.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np

Rotation = Tuple[int, int, float, float]
Plan = List[List[Union[Rotation, str]]]


def _elimination_params(a: complex, b: complex) -> Tuple[float, float]:
    """(theta, phi) such that sin(t)*a + e^{-i phi} cos(t)*b == 0."""
    if abs(a) < 1e-14:
        # annihilate b by a pure swap: cos t = 0
        return np.pi / 2, 0.0
    phi = float(np.pi + np.angle(b) - np.angle(a))
    theta = float(np.arctan2(abs(b), abs(a)))
    return theta, phi


def _apply_inverse_rotation(T: np.ndarray, i: int, j: int, theta: float, phi: float):
    """Left-multiply rows (i, j) of T by V^dag(theta, phi) in place."""
    c, s = np.cos(theta), np.sin(theta)
    e = np.exp(-1j * phi)
    Ri = c * T[i] - s * e * T[j]
    Rj = s * T[i] + c * e * T[j]
    T[i], T[j] = Ri, Rj


def rotation_mode_matrix(n: int, i: int, j: int, theta: float, phi: float) -> np.ndarray:
    """Mode map V of 'SingleExcitation(2 theta) on (i,j) then RZ(phi) on j'."""
    V = np.eye(n, dtype=complex)
    c, s = np.cos(theta), np.sin(theta)
    V[i, i] = c
    V[i, j] = s
    V[j, i] = -np.exp(1j * phi) * s
    V[j, j] = np.exp(1j * phi) * c
    return V


def givens_decomposition_square(Q: np.ndarray, tol: float = 1e-12):
    """Decompose unitary Q into (decomposition, diagonal).

    Contract: with V_op the mode map of each rotation and D = diag(diagonal),

        Q^T = V_{op_L} @ ... @ V_{op_1} @ D

    where op_1 ... op_L is the *reversed* flattened decomposition (i.e. the
    order in which the reference circuit applies them).
    """
    Q = np.asarray(Q, dtype=complex)
    N = Q.shape[0]
    if Q.shape != (N, N):
        raise ValueError("expected a square matrix")
    if not np.allclose(Q @ Q.conj().T, np.eye(N), atol=1e-8):
        raise ValueError("expected a unitary matrix")

    T = Q.T.copy()
    ops: List[Rotation] = []
    # Column-by-column elimination of subdiagonal entries, bottom-up, using
    # adjacent-row rotations only.
    for col in range(N - 1):
        for row in range(N - 1, col, -1):
            b = T[row, col]
            if abs(b) <= tol:
                continue
            i, j = row - 1, row
            theta, phi = _elimination_params(T[i, col], b)
            _apply_inverse_rotation(T, i, j, theta, phi)
            T[row, col] = 0.0
            ops.append((i, j, theta, phi))

    diagonal = np.diag(T).copy()
    # sanity: T must now be diagonal (unitary upper-triangular)
    off = T - np.diag(diagonal)
    if np.max(np.abs(off)) > 1e-8:
        raise AssertionError("Givens elimination failed to diagonalize")

    # Greedy layering: ops on disjoint wire pairs commute (as mode maps), so
    # pack them into parallel layers while preserving per-wire order.
    last_layer = {}
    layers: List[List[Rotation]] = []
    for op in ops:
        i, j = op[0], op[1]
        layer_idx = max(last_layer.get(i, -1), last_layer.get(j, -1)) + 1
        while len(layers) <= layer_idx:
            layers.append([])
        layers[layer_idx].append(op)
        last_layer[i] = layer_idx
        last_layer[j] = layer_idx
    return layers, diagonal


def plan_mode_matrix(decomposition: Plan, diagonal: np.ndarray) -> np.ndarray:
    """Reconstruct the total mode map of the emitted circuit (for testing)."""
    N = len(diagonal)
    M = np.diag(diagonal).astype(complex)
    for parallel_ops in reversed(decomposition):
        for op in parallel_ops:
            if op == "pht":
                raise ValueError("pht not produced by the square decomposition")
            i, j, theta, phi = op
            M = rotation_mode_matrix(N, i, j, theta, phi) @ M
    return M
