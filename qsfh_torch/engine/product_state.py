"""Phased product states with closed-form Pauli expectations.

Counterpart of ``qsfh_tpu/engine/product_state.py``: a yardstick for the
kernels at 26-30 qubits, where no plain reference fits on the card.  A
product state

    |psi> = prod_q  cos(theta_q/2)|0> + e^{i alpha_q} sin(theta_q/2)|1>

has a per-qubit closed form for every packed Pauli term, so <psi|H|psi>
of a whole Hubbard Hamiltonian (and of U^dag H U, dressed symbolically)
is computable on the host in float64 at any qubit count, while the 2^n
state itself is built on the card.

Engine convention (``engine/expectation.py``): a packed term (x, z, c)
acts as c_adj D_z X_x with c_adj = c (-1)^{|z & x|}, (X_x psi)(k) =
psi(k ^ x), (D_z psi)(k) = (-1)^{parity(z & k)} psi(k), qubit q on
flat-index bit n-1-q.  <w| D_z X_x |psi> of two product states factorizes
per qubit (:func:`product_pair_term_values`).

The JAX module builds the state as f32 (rows, 128) planes, a TPU I/O
layout; here :func:`product_state` writes the complex tensor directly,
and :func:`rotation_ops` gives the engine's segment ops where the JAX
module gives the stream kernels' arrays.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.dressing import dress_once
from ..ops.pauli import PauliSum

# elements of the state formed at a time by product_state (float64 scratch)
_CHUNK = 1 << 24


def _log_factors(thetas, alphas):
    """Per-qubit (ln|a|, ln|b|, arg a, arg b) of a = cos(theta/2), b =
    e^{i alpha} sin(theta/2): signs fold into the phase as 0-or-pi, and a
    pinned qubit (theta = 0 or pi) has a log-weight of -inf."""
    th = np.asarray(thetas, np.float64)
    al = np.asarray(alphas, np.float64)
    with np.errstate(divide="ignore"):
        ln_a = np.log(np.abs(np.cos(th / 2.0)))
        ln_b = np.log(np.abs(np.sin(th / 2.0)))
    ph_a = np.where(np.cos(th / 2.0) < 0, np.pi, 0.0)
    ph_b = al + np.where(np.sin(th / 2.0) < 0, np.pi, 0.0)
    return ln_a, ln_b, ph_a, ph_b


def _kron_sums(qubits, ln_a, ln_b, ph_a, ph_b, device):
    """(log-magnitude, phase) float64 vectors over the flat indices of
    ``qubits`` (the first the most significant bit), by Kronecker doubling:
    sums, so no product of small amplitudes is ever formed."""
    ln = torch.zeros(1, dtype=torch.float64, device=device)
    ph = torch.zeros(1, dtype=torch.float64, device=device)
    for q in qubits:
        ln = (ln[:, None] + torch.tensor([ln_a[q], ln_b[q]], dtype=torch.float64,
                                         device=device)).reshape(-1)
        ph = (ph[:, None] + torch.tensor([ph_a[q], ph_b[q]], dtype=torch.float64,
                                         device=device)).reshape(-1)
    return ln, ph


def product_state(n: int, thetas, alphas, device, dtype=torch.complex64) -> torch.Tensor:
    """The 2^n product state built on ``device``, no host copy.

    The flat index splits into the high qubits (0 .. H-1) and the low ones
    (H .. n-1); each half's log-magnitudes and phases are float64 vectors
    of 2^H and 2^L entries, and the state is exp(ln_hi + ln_lo) e^{i (ph_hi
    + ph_lo)}, formed a chunk of rows at a time.  Log-magnitudes are summed
    rather than amplitudes multiplied (as the JAX module does), so
    30-qubit amplitudes (~2^-15 each) never pass near the float32 denormal
    floor, and no 2^n index vector is built.
    """
    th = np.asarray(thetas, np.float64)
    al = np.asarray(alphas, np.float64)
    if th.shape != (n,) or al.shape != (n,):
        raise ValueError("thetas/alphas must have shape (n,)")
    factors = _log_factors(th, al)
    high = n // 2
    ln_hi, ph_hi = _kron_sums(range(high), *factors, device)
    ln_lo, ph_lo = _kron_sums(range(high, n), *factors, device)
    out = torch.empty(1 << n, dtype=dtype, device=device)
    view = out.view(ln_hi.shape[0], ln_lo.shape[0])
    rows = max(1, _CHUNK // ln_lo.shape[0])
    for r0 in range(0, view.shape[0], rows):
        r1 = min(r0 + rows, view.shape[0])
        mag = torch.exp(ln_hi[r0:r1, None] + ln_lo[None, :])
        view[r0:r1] = torch.polar(mag, ph_hi[r0:r1, None] + ph_lo[None, :]).to(dtype)
    return out


def product_state_host(n: int, thetas, alphas) -> np.ndarray:
    """Dense complex128 product state on the host (test-scale n only)."""
    th = np.asarray(thetas, np.float64)
    al = np.asarray(alphas, np.float64)
    psi = np.ones(1, np.complex128)
    for q in range(n):  # qubit 0 is the most significant flat-index bit
        v = np.array(
            [math.cos(th[q] / 2.0),
             math.sin(th[q] / 2.0) * complex(math.cos(al[q]), math.sin(al[q]))],
            np.complex128,
        )
        psi = np.kron(psi, v)
    return psi


def hermitian_string(x: int, z: int) -> PauliSum:
    """The Hermitian Pauli string P = i^{|x&z|} X^x Z^z as a PauliSum: the
    string an engine rotation term (x, z) rotates by, so exp(-i theta P) =
    cos(theta) - i sin(theta) P."""
    w = bin(x & z).count("1") % 4
    return PauliSum([x], [z], [1j**w])


def rotation_ops(n: int, rotations):
    """``(ops, thetas)`` for U = exp(-i th_T P_T) ... exp(-i th_0 P_0) from
    (x, z, theta) triples (qubit-indexed masks, P_t =
    :func:`hermitian_string`): one ``("rot", ((x, z, 1.0),), t)`` op per
    triple, so ``engine.compiled.lower_program`` makes ONE rot segment
    whose parameter t is the angle (float64 ``thetas``).  The segment's
    string phase (-i)^{|x&z|} times D_z X_x is P_t, as the JAX
    ``stream_rotation_inputs`` phases are; gradients of the segment's
    adjoint sweep are dE/dtheta_t."""
    ops, thetas = [], []
    for t, (x, z, theta) in enumerate(rotations):
        x, z = int(x), int(z)
        if (x | z) >> n:
            raise ValueError(f"rotation {t}: masks beyond {n} qubits")
        ops.append(("rot", ((x, z, 1.0),), t))
        thetas.append(float(theta))
    return ops, np.asarray(thetas, np.float64)


def rotated_hamiltonian(op: PauliSum, rotations) -> PauliSum:
    """U^dag H U for U = exp(-i th_T P_T) ... exp(-i th_0 P_0), computed
    symbolically (``ops.dressing.dress_once``), P_t =
    :func:`hermitian_string` (x_t, z_t): <psi|U^dag H U|psi> is the energy
    of the rotated state, so the product-state closed form of the dressed
    operator checks the rotation kernels at any qubit count."""
    out = op
    for x, z, theta in reversed(list(rotations)):
        out = dress_once(out, hermitian_string(int(x), int(z)), 2.0 * float(theta))
    return out


def _qubit_amps(thetas, alphas):
    th = np.asarray(thetas, np.float64)
    al = np.asarray(alphas, np.float64)
    a = np.cos(th / 2.0).astype(np.complex128)
    b = np.sin(th / 2.0) * np.exp(1j * al)
    return a, b


def product_pair_term_values(op: PauliSum, n: int, w_angles, psi_angles) -> np.ndarray:
    """Per-term complex values c_adj,t <w| D_z X_x |psi> (host float64) of
    two product states, the product over qubits of

        M_q = conj(aw) a + (-1)^{z_q} conj(bw) b        if x_q = 0
        M_q = conj(aw) b + (-1)^{z_q} conj(bw) a        if x_q = 1

    (identity qubits give <w_q|psi_q>, not 1).  The engine reads them as
    E = Re sum_t V_t for w = psi, and screen_t = 2 Im V_t with w the
    cotangent state.  Vectorized over terms and qubits."""
    aw, bw = _qubit_amps(*w_angles)
    a, b = _qubit_amps(*psi_angles)
    caw, cbw = np.conj(aw), np.conj(bw)
    # table[x_q, z_q, q]
    table = np.stack([np.stack([caw * a + cbw * b, caw * a - cbw * b]),
                      np.stack([caw * b + cbw * a, caw * b - cbw * a])])
    x = np.asarray(op.x, np.uint64)
    z = np.asarray(op.z, np.uint64)
    shifts = np.arange(n, dtype=np.uint64)
    xb = ((x[:, None] >> shifts) & np.uint64(1)).astype(np.intp)
    zb = ((z[:, None] >> shifts) & np.uint64(1)).astype(np.intp)
    sign = 1.0 - 2.0 * (np.bitwise_count(x & z).astype(np.int64) % 2)
    factors = table[xb, zb, np.arange(n)[None, :]]
    return np.asarray(op.c, np.complex128) * sign * np.prod(factors, axis=1)


def product_expectation(op: PauliSum, n: int, thetas, alphas) -> float:
    """Closed-form Re <psi| op |psi> for a packed PauliSum, host float64."""
    ang = (thetas, alphas)
    return float(product_pair_term_values(op, n, ang, ang).sum().real)
