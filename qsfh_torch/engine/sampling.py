"""Shot-based measurement: bitstring sampling and grouped Pauli estimation.

Counterpart of ``qsfh_tpu/engine/sampling.py``:

* ``qwc_groups``: greedy qubit-wise-commuting grouping of a ``PauliSum``
  (each group is measurable in one shared per-qubit basis setting);
* ``sample_bitstrings`` / ``sample_counts``: sampling from ``|psi|^2`` by
  the inverse CDF over uniforms, on the state's device;
* ``estimate_expectation`` (and ``estimate_expectation_scan``, the same
  protocol with the basis change selected per group from data): rotate
  into each group's measurement basis, sample, and average signed
  eigenvalues, with the shot-noise standard error propagated per group.

Randomness: the JAX module takes a ``jax.random`` key, which the port
cannot reproduce.  Here the uniforms come from a ``torch.Generator`` on
the state's device (``generator``; torch's default generator when none)
or are passed in (``uniforms``), so a test can feed the JAX draws and
compare counts and estimates exactly.  Samples are int64 flat indices
(the JAX module returns uint32).  The basis change and the parity signs
are plain torch ops; no kernel is involved.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.pauli import PauliSum, _popcount
from .gates import apply_one_qubit, xor_flip
from .state import index_bits, parity, parity_signs, qmask_to_bmask, real_dtype

_SQRT2 = np.sqrt(2.0)
# R X R^dag = Z  (Hadamard)
_ROT_X = np.array([[1.0, 1.0], [1.0, -1.0]], dtype=np.complex128) / _SQRT2
# R Y R^dag = Z  (Hadamard after S^dag)
_ROT_Y = np.array([[1.0, -1.0j], [1.0, 1.0j]], dtype=np.complex128) / _SQRT2


def string_support(op: PauliSum):
    """Per-term (X-basis, Y-basis, Z-basis) qubit masks of the *string* form.

    The packed monomial is ``c * X^x Z^z``; per qubit, ``x&~z`` measures X,
    ``x&z`` measures Y, ``~x&z`` measures Z.
    """
    x, z = op.x, op.z
    return x & ~z, x & z, ~x & z


def qwc_groups(op: PauliSum) -> List[np.ndarray]:
    """Greedily partition terms into qubit-wise-commuting groups.

    Each group carries a joint basis signature ``(xb, yb, zb)`` (qubits
    measured in X / Y / Z); a term joins the first group whose signature it
    does not conflict with, terms offered largest-support-first.  Returns
    index arrays into ``op``'s term order.
    """
    xm, ym, zm = string_support(op)
    support = xm | ym | zm
    order = np.argsort(-_popcount(support), kind="stable")
    sigs: List[List[np.uint64]] = []  # [xb, yb, zb] per group
    members: List[List[int]] = []
    for idx in order:
        i = int(idx)
        tx, ty, tz = xm[i], ym[i], zm[i]
        placed = False
        for sig, mem in zip(sigs, members):
            conflict = (
                (tx & (sig[1] | sig[2]))
                | (ty & (sig[0] | sig[2]))
                | (tz & (sig[0] | sig[1]))
            )
            if not conflict:
                sig[0] |= tx
                sig[1] |= ty
                sig[2] |= tz
                mem.append(i)
                placed = True
                break
        if not placed:
            sigs.append([tx, ty, tz])
            members.append([i])
    return [np.array(m, dtype=np.int64) for m in members]


def rotate_to_group_basis(psi: torch.Tensor, n: int, x_basis_mask: int,
                          y_basis_mask: int) -> torch.Tensor:
    """Apply the per-qubit basis change so the group is diagonal in Z:
    qubits in ``x_basis_mask`` get H, in ``y_basis_mask`` H S^dag
    (qubit-indexed masks)."""
    for q in range(n):
        bit = 1 << q
        if x_basis_mask & bit:
            psi = apply_one_qubit(psi, n, _ROT_X, q)
        elif y_basis_mask & bit:
            psi = apply_one_qubit(psi, n, _ROT_Y, q)
    return psi


def sample_bitstrings(psi: torch.Tensor, n: int, shots: int,
                      generator: Optional[torch.Generator] = None,
                      uniforms=None) -> torch.Tensor:
    """Sample ``shots`` flat basis indices from ``|psi|^2`` (int64, on psi's
    device).

    Inverse CDF: one cumulative sum over the 2^n probability vector and
    ``shots`` uniform draws u in [0, 1) (``uniforms``, or drawn from
    ``generator``), scaled by the total; each index is the count of CDF
    entries strictly below its draw, so zero-probability states are never
    selected.
    """
    if n > 30:
        raise ValueError("bitstring sampling limited to 30 qubits per shard")
    p = psi.real ** 2 + psi.imag ** 2
    cdf = torch.cumsum(p.reshape(-1), 0)
    if uniforms is None:
        u = torch.rand(shots, generator=generator, dtype=cdf.dtype, device=cdf.device)
    else:
        u = uniforms if torch.is_tensor(uniforms) else torch.from_numpy(np.array(uniforms))
        u = u.to(device=cdf.device, dtype=cdf.dtype)
        if u.shape != (shots,):
            raise ValueError(f"expected ({shots},) uniforms, got {tuple(u.shape)}")
    idx = torch.searchsorted(cdf, u * cdf[-1])
    return torch.clamp(idx, max=(1 << n) - 1)


def sample_counts(psi: torch.Tensor, n: int, shots: int,
                  generator: Optional[torch.Generator] = None,
                  uniforms=None) -> Dict[str, int]:
    """Histogram of sampled bitstrings, keyed ``'q0 q1 ... q{n-1}'`` order
    (qubit 0 is the most significant flat bit, so the key reads qubits
    0..n-1 left to right)."""
    samples = sample_bitstrings(psi, n, shots, generator, uniforms).cpu().numpy()
    idx, cnt = np.unique(samples, return_counts=True)
    return {format(int(i), f"0{n}b"): int(c) for i, c in zip(idx, cnt)}


@dataclass
class MeasurementResult:
    """Shot-estimated expectation with its standard error.

    ``n_groups`` counts the MEASURED groups (groups of identity terms only
    are folded into the exact constant and dropped), so it equals
    ``len(group_means)`` / ``len(group_stderrs)``.
    """

    mean: float
    stderr: float
    shots_per_group: int
    n_groups: int
    group_means: np.ndarray
    group_stderrs: np.ndarray


def _shot_statistics(samples: torch.Tensor, bmasks, coeffs, shots: int, rdt):
    """(mean, variance of the mean) of the group energy per shot: the
    signed eigenvalues ``(-1)^popcount(sample & mask)`` of the group's
    terms weighted by their real string coefficients."""
    masks = torch.as_tensor(np.asarray(bmasks, dtype=np.int64), device=samples.device)
    signs = 1.0 - 2.0 * parity(samples[:, None] & masks[None, :]).to(rdt)
    per_shot = signs @ torch.as_tensor(np.asarray(coeffs), device=samples.device).to(rdt)
    mean = per_shot.mean()
    var = per_shot.var(correction=1) / shots if shots > 1 else torch.zeros_like(mean)
    return mean, var


def _split_identity(op: PauliSum, groups, n: int):
    """Host-side packing shared by both estimators: the exact identity
    contribution and, per group, live-term flat bitmasks + real string
    coefficients + the group's X/Y basis masks."""
    xm, ym, zm = string_support(op)
    support = xm | ym | zm
    if not op.is_hermitian(tol=1e-9):
        raise ValueError("shot estimation requires a Hermitian PauliSum")
    c_str = op.string_coeffs().real
    const = float(c_str[support == 0].sum())
    packed = []
    for idx in groups:
        live = idx[support[idx] != 0]
        if live.size == 0:
            continue
        bmasks = np.array(
            [qmask_to_bmask(int(m), n) for m in support[live]], dtype=np.uint32
        )
        packed.append(
            (
                bmasks,
                c_str[live],
                int(np.bitwise_or.reduce(xm[live])),
                int(np.bitwise_or.reduce(ym[live])),
            )
        )
    return const, packed


def pack_groups(op: PauliSum, n: int, groups: Sequence[np.ndarray]):
    """Rectangular host packing of QWC groups.

    Returns ``(const, masks, coeffs, x_bits, y_bits)``: the exact identity
    contribution, ``(G, T_max)`` flat bitmasks / real string coefficients
    (zero-padded: padded terms contribute sign*0), and ``(G, n)`` 0/1
    per-qubit X/Y basis selectors.
    """
    const, packed = _split_identity(op, groups, n)
    g = len(packed)
    t_max = max((len(b) for b, *_ in packed), default=0)
    masks = np.zeros((g, t_max), dtype=np.uint32)
    coeffs = np.zeros((g, t_max), dtype=np.float64)
    x_bits = np.zeros((g, n), dtype=np.float64)
    y_bits = np.zeros((g, n), dtype=np.float64)
    for i, (b, c, xb, yb) in enumerate(packed):
        masks[i, : len(b)] = b
        coeffs[i, : len(b)] = c
        x_bits[i] = [(xb >> q) & 1 for q in range(n)]
        y_bits[i] = [(yb >> q) & 1 for q in range(n)]
    return const, masks, coeffs, x_bits, y_bits


def _rotate_data_driven(psi: torch.Tensor, n: int, x_bits, y_bits) -> torch.Tensor:
    """The basis change selected per qubit from 0/1 selectors ``x_bits``,
    ``y_bits`` ((n,), qubit-indexed): qubit q's 2x2 is the convex selection
    ``I (1 - x - y) + H x + H S^dag y``, applied as an XOR-flip butterfly
    ``psi' = diag(b) psi + off(b) psi[b ^ bit]``.  Qubits selecting I are
    skipped (their butterfly is the identity)."""
    rdt = real_dtype(psi.dtype)
    idx = index_bits(n, psi.device)
    for q in range(n):
        x, y = float(x_bits[q]), float(y_bits[q])
        if x == 0.0 and y == 0.0:
            continue
        (u00, u01), (u10, u11) = (np.eye(2) * (1.0 - x - y) + _ROT_X * x + _ROT_Y * y).tolist()
        bmask = 1 << (n - 1 - q)
        t = xor_flip(psi, n, bmask)
        s = parity_signs(idx, bmask, rdt)  # +1 where the bit is 0
        diag = 0.5 * ((u00 + u11) + s * (u00 - u11))
        off = 0.5 * ((u01 + u10) + s * (u01 - u10))
        psi = diag * psi + off * t
    return psi


def _group_uniforms(uniforms, g: int, shots: int):
    if uniforms is None:
        return [None] * g
    u = np.asarray(uniforms) if not torch.is_tensor(uniforms) else uniforms
    if tuple(u.shape) != (g, shots):
        raise ValueError(f"expected ({g}, {shots}) uniforms, got {tuple(u.shape)}")
    return list(u)


def _result(const, means, variances, shots: int) -> MeasurementResult:
    """The estimate from per-group device scalars, read once."""
    if not means:
        return MeasurementResult(const, 0.0, shots, 0, np.zeros(0), np.zeros(0))
    stats = torch.stack([torch.stack(means), torch.stack(variances)]).double().cpu().numpy()
    g_means, g_vars = stats[0], stats[1]
    return MeasurementResult(
        mean=const + float(g_means.sum()),
        stderr=float(np.sqrt(g_vars.sum())),
        shots_per_group=shots,
        n_groups=len(means),
        group_means=g_means,
        group_stderrs=np.sqrt(g_vars),
    )


def estimate_expectation_scan(
    psi: torch.Tensor,
    n: int,
    op: PauliSum,
    shots: int,
    generator: Optional[torch.Generator] = None,
    groups: Optional[Sequence[np.ndarray]] = None,
    uniforms=None,
) -> MeasurementResult:
    """The grouped estimator over the rectangular packing (:func:`pack_groups`):
    per group the data-selected basis change, ``shots`` fresh samples and
    the signed average over the padded term row.  Same protocol as
    :func:`estimate_expectation`; ``uniforms``: (G, shots), G the measured
    groups."""
    if groups is None:
        groups = qwc_groups(op)
    const, masks, coeffs, x_bits, y_bits = pack_groups(op, n, groups)
    rdt = real_dtype(psi.dtype)
    draws = _group_uniforms(uniforms, masks.shape[0], shots)
    means, variances = [], []
    for i in range(masks.shape[0]):
        rot = _rotate_data_driven(psi, n, x_bits[i], y_bits[i])
        samples = sample_bitstrings(rot, n, shots, generator, draws[i])
        mean, var = _shot_statistics(samples, masks[i], coeffs[i], shots, rdt)
        means.append(mean)
        variances.append(var)
    return _result(const, means, variances, shots)


def estimate_expectation(
    psi: torch.Tensor,
    n: int,
    op: PauliSum,
    shots: int,
    generator: Optional[torch.Generator] = None,
    groups: Optional[Sequence[np.ndarray]] = None,
    uniforms=None,
) -> MeasurementResult:
    """Shot-based estimate of ``<psi|op|psi>`` via QWC grouped measurement.

    Each group gets ``shots`` fresh samples in its own basis setting; the
    identity component is added exactly with zero variance.  ``op`` must be
    Hermitian (real string coefficients).  ``uniforms``: (G, shots), G the
    measured groups.
    """
    if groups is None:
        groups = qwc_groups(op)
    const, packed = _split_identity(op, groups, n)
    rdt = real_dtype(psi.dtype)
    draws = _group_uniforms(uniforms, len(packed), shots)
    means, variances = [], []
    for (bmasks, cs, x_basis, y_basis), u in zip(packed, draws):
        rot = rotate_to_group_basis(psi, n, x_basis, y_basis)
        samples = sample_bitstrings(rot, n, shots, generator, u)
        mean, var = _shot_statistics(samples, bmasks, cs, shots, rdt)
        means.append(mean)
        variances.append(var)
    return _result(const, means, variances, shots)
