"""Gate-level statevector operations in plain PyTorch.

Counterpart of ``qsfh_tpu/engine/gates.py``: the unrolled cross-check
lowering (autograd through gates, and the gate-level adjoint of
:mod:`qsfh_torch.grad.adjoint`) and the Slater-prep helpers of
:mod:`qsfh_torch.engine.circuits` are built on these.  Each rotation is
one fused update

    exp(-i t P)|psi> = cos(t)|psi> - i sin(t) P|psi>

with ``P|psi>[b] = (-i)^popcount(x&z) (-1)^popcount(b&z) psi[b^x]`` for
the Hermitian string P = i^popcount(x&z) X^x Z^z: the flip is an index
gather, the sign an XOR-folded parity (:func:`state.parity_signs`).  Masks
are qubit-indexed (bit q = qubit q, flat-index bit n-1-q).  Angles may be
Python floats or real tensors; every function is differentiable by
autograd in complex64 and complex128.  The JAX module's TPU workarounds
(lane permutation matmuls, the complex-free constant ABI) have no
counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from .state import bitpos, index_bits, parity_signs, qmask_to_bmask, real_dtype


def _angle(theta, psi: torch.Tensor) -> torch.Tensor:
    """theta as a real tensor of psi's real dtype on psi's device (a tensor
    keeps its autograd graph)."""
    rdt = real_dtype(psi.dtype)
    if torch.is_tensor(theta):
        return theta.to(device=psi.device, dtype=rdt)
    return torch.tensor(float(theta), dtype=rdt, device=psi.device)


def _matrix(U, psi: torch.Tensor) -> torch.Tensor:
    """A gate matrix (numpy, nested lists or a tensor) in psi's dtype and device."""
    if torch.is_tensor(U):
        return U.to(device=psi.device, dtype=psi.dtype)
    return torch.as_tensor(np.asarray(U, dtype=np.complex128)).to(device=psi.device,
                                                                  dtype=psi.dtype)


def xor_flip(psi: torch.Tensor, n: int, bmask: int) -> torch.Tensor:
    """t[b] = psi[b ^ bmask] (a flat-index mask)."""
    if bmask == 0:
        return psi
    return psi[index_bits(n, psi.device) ^ bmask]


# -- packed Pauli application ----------------------------------------------------


def apply_pauli_string(psi: torch.Tensor, n: int, x: int, z: int) -> torch.Tensor:
    """Apply the Hermitian Pauli string P = i^{|x&z|} X^x Z^z (unit coefficient)."""
    xb = qmask_to_bmask(x, n)
    zb = qmask_to_bmask(z, n)
    t = xor_flip(psi, n, xb)
    if zb:
        t = t * parity_signs(index_bits(n, psi.device), zb, real_dtype(psi.dtype))
    # i^{|x&z|} from the string times (-1)^{|x&z|} from commuting Z^z past
    # the flip: (-i)^{|x&z|}
    phase = (-1j) ** (bin(x & z).count("1") % 4)
    if phase != 1:
        t = t * phase
    return t


def pauli_rotation(psi: torch.Tensor, n: int, x: int, z: int, theta) -> torch.Tensor:
    """exp(-i theta P) |psi> for the Hermitian string P = i^{|x&z|} X^x Z^z.

    For diagonal strings (x == 0) this is one elementwise pass.
    """
    theta = _angle(theta, psi)
    if x == 0:
        zb = qmask_to_bmask(z, n)
        if zb:
            s = parity_signs(index_bits(n, psi.device), zb, theta.dtype)
        else:
            s = torch.ones((), dtype=theta.dtype, device=psi.device)
        # exp(-i theta s) with s = +-1: cos(theta) - i s sin(theta)
        return psi * (torch.cos(theta) - 1j * s * torch.sin(theta))
    ppsi = apply_pauli_string(psi, n, x, z)
    return torch.cos(theta) * psi - 1j * torch.sin(theta) * ppsi


def diagonal_rotation(psi: torch.Tensor, diag: torch.Tensor, theta) -> torch.Tensor:
    """exp(-i theta D)|psi> for a real diagonal vector D (one pass for a
    whole commuting diagonal generator, the HVA Coulomb layer)."""
    theta = _angle(theta, psi)
    d = diag.to(device=psi.device, dtype=theta.dtype)
    return psi * torch.exp(-1j * (theta * d))


def generator_rotation(psi: torch.Tensor, n: int, rot_terms, theta) -> torch.Tensor:
    """First-order-Trotter exp(-i theta G): one rotation per Pauli term.

    rot_terms: (x, z, scale) triples from ``PauliSum.rotation_terms()``;
    the terms of the HVA and ADAPT generators commute, so this is exact.
    """
    theta = _angle(theta, psi)
    for (x, z, scale) in rot_terms:
        psi = pauli_rotation(psi, n, x, z, theta * scale)
    return psi


# -- dense few-qubit gates --------------------------------------------------------


def apply_one_qubit(psi: torch.Tensor, n: int, U2, q: int) -> torch.Tensor:
    p = bitpos(q, n)
    A, C = 1 << (n - 1 - p), 1 << p
    out = torch.einsum("xi,aic->axc", _matrix(U2, psi), psi.reshape(A, 2, C))
    return out.reshape(psi.shape)


def apply_two_qubit(psi: torch.Tensor, n: int, U4, qa: int, qb: int) -> torch.Tensor:
    """Apply a 4x4 unitary; U4 is indexed row-major by the basis |qa qb>."""
    if qa == qb:
        raise ValueError("two-qubit gate needs distinct qubits")
    U = _matrix(U4, psi).reshape(2, 2, 2, 2)
    if qa > qb:
        # swap which tensor factor each axis refers to
        U = U.permute(1, 0, 3, 2)
        qa, qb = qb, qa
    pa, pb = bitpos(qa, n), bitpos(qb, n)  # pa > pb
    A = 1 << (n - 1 - pa)
    B = 1 << (pa - pb - 1)
    C = 1 << pb
    out = torch.einsum("xyij,aibjc->axbyc", U, psi.reshape(A, 2, B, 2, C))
    return out.reshape(psi.shape)


def pauli_x(psi: torch.Tensor, n: int, q: int) -> torch.Tensor:
    return xor_flip(psi, n, 1 << bitpos(q, n))


def rz(psi: torch.Tensor, n: int, phi, q: int) -> torch.Tensor:
    """PennyLane RZ convention: diag(e^{-i phi/2}, e^{+i phi/2})."""
    phi = _angle(phi, psi)
    s = parity_signs(index_bits(n, psi.device), 1 << bitpos(q, n), phi.dtype)
    return psi * torch.exp(-1j * (phi / 2) * s)


def ry_matrix(theta, dtype=np.complex128):
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[c, -s], [s, c]], dtype=dtype)


def rx_matrix(theta, dtype=np.complex128):
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[c, -1j * s], [-1j * s, c]], dtype=dtype)


def ry(psi, n, theta, q):
    """exp(-i theta Y_q / 2)."""
    return pauli_rotation(psi, n, 1 << q, 1 << q, _angle(theta, psi) / 2)


def rx(psi, n, theta, q):
    """exp(-i theta X_q / 2)."""
    return pauli_rotation(psi, n, 1 << q, 0, _angle(theta, psi) / 2)


def cnot(psi: torch.Tensor, n: int, control: int, target: int) -> torch.Tensor:
    U = np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]], dtype=np.complex128
    )
    return apply_two_qubit(psi, n, U, control, target)


def givens_plan_matrix(theta: float, phi: float) -> np.ndarray:
    """Constant 4x4 for one Givens-plan op: RZ(phi) on wire j AFTER
    SingleExcitation(2*theta) on wires (i, j)."""
    c, s = np.cos(theta), np.sin(theta)
    se = np.array(
        [[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]],
        dtype=np.complex128,
    )
    rzj = np.diag(np.exp(np.array([-1j, 1j, -1j, 1j]) * (phi / 2)))
    return rzj @ se


def static_rz_layer_phases(angles, n: int) -> np.ndarray:
    """Host phase vector of a whole layer of static RZ gates:
    phase[b] = prod_i exp(-i angles[i]/2 * s_i(b)), s_i = +-1 by bit i."""
    total = np.zeros(1 << n, dtype=np.float64)
    idx = np.arange(1 << n, dtype=np.uint64)
    for q in range(n):
        if angles[q] == 0.0:
            continue
        bit = (idx >> np.uint64(n - 1 - q)) & np.uint64(1)
        total += angles[q] / 2 * (1.0 - 2.0 * bit.astype(np.float64))
    return np.exp(-1j * total)


def single_excitation(psi: torch.Tensor, n: int, phi, qa: int, qb: int) -> torch.Tensor:
    """PennyLane SingleExcitation(phi) on wires [qa, qb]: the matrix
    [[1,0,0,0],[0,c,-s,0],[0,s,c,0],[0,0,0,1]], c = cos(phi/2), s = sin(phi/2)."""
    phi = _angle(phi, psi)
    c = torch.cos(phi / 2).to(psi.dtype)
    s = torch.sin(phi / 2).to(psi.dtype)
    one = torch.ones((), dtype=psi.dtype, device=psi.device)
    zero = torch.zeros((), dtype=psi.dtype, device=psi.device)
    U = torch.stack([
        torch.stack([one, zero, zero, zero]),
        torch.stack([zero, c, -s, zero]),
        torch.stack([zero, s, c, zero]),
        torch.stack([zero, zero, zero, one]),
    ])
    return apply_two_qubit(psi, n, U, qa, qb)
