"""Circuits lowered to homogeneous Pauli-rotation segments.

Counterpart of ``qsfh_tpu/engine/compiled.py`` for ``rot`` segments: a
gate program of ("rot", rot_terms, param_idx) ops becomes one segment of
per-term arrays (flip mask, phase mask, scale, parameter index, string
phase), run by the ``pauli_rotation`` kernel forward and backward and by
``adjoint_rotation`` for gradients.  Static-angle terms carry parameter
index -1, which selects an appended constant 1.0.

The TPU workarounds of the JAX module are not carried over: per-term
angles are the plain gather ``thetas_ext[pidx]`` (no one-hot matmul),
gradients accumulate with ``index_add_``, and terms are not regrouped.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .kernels import KERNELS
from .state import qmask_to_bmask, real_dtype


def givens_network_static_ops(n_qubits: int, diagonal, decomposition):
    """The Slater/FT Givens network as STATIC Pauli rotations.

    Every plan op decomposes exactly into commuting Pauli rotations:
      RZ(phi) on q            = exp(-i phi/2 Z_q)
      SingleExcitation(2t)    = exp(-i t/2 Y_i X_j) exp(+i t/2 X_i Y_j)
      PauliX ('pht')          = i * exp(-i pi/2 X_q)
    so the whole circuit becomes ONE homogeneous rot segment (static angles
    ride as scale with param index -1 -> an appended constant 1.0).

    Returns (ops, global_phase): energies and fidelities are phase-free,
    but apply() multiplies the phase back for exact state parity.
    """
    ops: List[tuple] = []
    n_pht = 0
    for i in range(n_qubits):
        ang = float(np.angle(diagonal[i]))
        if ang != 0.0:
            ops.append(("rot", ((0, 1 << i, ang / 2.0),), -1))
    for parallel_ops in reversed(decomposition):
        for op in parallel_ops:
            if op == "pht":
                q = n_qubits - 1
                ops.append(("rot", ((1 << q, 0, np.pi / 2.0),), -1))
                n_pht += 1
            else:
                i, j, theta, phi = op
                both = (1 << i) | (1 << j)
                ops.append(
                    (
                        "rot",
                        (
                            (both, 1 << i, float(theta) / 2.0),  # Y_i X_j
                            (both, 1 << j, -float(theta) / 2.0),  # X_i Y_j
                        ),
                        -1,
                    )
                )
                if float(phi) != 0.0:
                    ops.append(("rot", ((0, 1 << j, float(phi) / 2.0),), -1))
    return ops, (1j) ** (n_pht % 4)


# -- program lowering -----------------------------------------------------------


class Segment:
    """One homogeneous run of rotation terms.

    ``data`` holds the host arrays in the JAX package's layout (uint32
    masks, float64 scalars, int32 parameter indices); ``tensors`` caches
    them per (device, real dtype) with int64 masks.
    """

    __slots__ = ("kind", "data", "_cache")

    def __init__(self, kind: str, data):
        self.kind = kind
        self.data = data
        self._cache = {}

    def __len__(self):
        return len(self.data["xb"])

    def tensors(self, device, rdt, n_params: int):
        key = (str(device), rdt, n_params)
        if key not in self._cache:
            d = self.data
            pidx = np.where(d["pidx"] < 0, n_params, d["pidx"]).astype(np.int64)
            self._cache[key] = {
                "xb": torch.as_tensor(d["xb"].astype(np.int64), device=device),
                "zb": torch.as_tensor(d["zb"].astype(np.int64), device=device),
                "scale": torch.as_tensor(d["scale"], device=device).to(rdt),
                "pidx": torch.as_tensor(pidx, device=device),
                "phre": torch.as_tensor(d["phre"], device=device).to(rdt),
                "phim": torch.as_tensor(d["phim"], device=device).to(rdt),
            }
        return self._cache[key]


def lower_program(ops: Sequence[tuple], n: int) -> List[Segment]:
    """Group a gate program into homogeneous segments (``rot`` ops only)."""
    xs, zs, scales, pidx, phre, phim = [], [], [], [], [], []
    for op in ops:
        if op[0] != "rot":
            raise NotImplementedError(
                f"op kind {op[0]!r} is not ported yet (only 'rot' segments are)"
            )
        _, rot_terms, k = op
        for (x, z, scale) in rot_terms:
            xs.append(qmask_to_bmask(x, n))
            zs.append(qmask_to_bmask(z, n))
            scales.append(scale)
            pidx.append(k)
            ph = (-1j) ** (bin(x & z).count("1") % 4)
            phre.append(ph.real)
            phim.append(ph.imag)
    if not xs:
        return []
    return [
        Segment(
            "rot",
            dict(
                xb=np.asarray(xs, np.uint32),
                zb=np.asarray(zs, np.uint32),
                scale=np.asarray(scales, np.float64),
                pidx=np.asarray(pidx, np.int32),
                phre=np.asarray(phre, np.float64),
                phim=np.asarray(phim, np.float64),
            ),
        )
    ]


# -- execution -------------------------------------------------------------------------


def _extended(thetas: torch.Tensor) -> torch.Tensor:
    """thetas with the constant 1.0 that parameter index -1 selects."""
    return torch.cat([thetas, torch.ones(1, dtype=thetas.dtype, device=thetas.device)])


def run_segments(segments, psi, thetas, n, direction: int = 1, impl=None):
    """Execute the program (direction=-1: exact inverse, reversed order).

    Returns a new state; ``psi`` is left untouched.
    """
    impl = impl or KERNELS
    rdt = real_dtype(psi.dtype)
    thetas_ext = _extended(thetas.to(rdt))
    out = psi.clone()
    seq = segments if direction == 1 else list(reversed(segments))
    for seg in seq:
        d = seg.tensors(psi.device, rdt, thetas.shape[0])
        angles = thetas_ext[d["pidx"]] * d["scale"] * direction
        arrs = (d["xb"], d["zb"], angles, d["phre"], d["phim"])
        if direction == -1:
            arrs = tuple(a.flip(0) for a in arrs)
        impl.rotation(out, *arrs)
    return out


def run_rot_adjoint(segment: Segment, psi_final, lam, thetas, n, impl=None):
    """Adjoint sweep over ONE rot segment: returns (psi0, lam0, grads).

    Reverse sweep: at each term (reversed), grad[pidx] += scale * Im
    <lam | P psi> evaluated at the state AFTER the gate, then both psi and
    lam are inverse-rotated.  Memory is two live statevectors.
    """
    impl = impl or KERNELS
    rdt = real_dtype(psi_final.dtype)
    n_params = thetas.shape[0]
    d = segment.tensors(psi_final.device, rdt, n_params)
    angles = _extended(thetas.to(rdt))[d["pidx"]] * d["scale"]
    psi, lam = psi_final.clone(), lam.clone()
    v = impl.adjoint(
        psi, lam,
        d["xb"].flip(0), d["zb"].flip(0), angles.flip(0),
        d["phre"].flip(0), d["phim"].flip(0),
    )
    contribs = d["scale"].flip(0) * v.imag.to(rdt)
    grads = torch.zeros(n_params + 1, dtype=rdt, device=psi.device)
    grads.index_add_(0, d["pidx"].flip(0), contribs)
    return psi, lam, grads[:n_params]


class CompiledCircuit:
    """ops -> rot segments, applied forward or inverted."""

    def __init__(self, ops: Sequence[tuple], n_qubits: int, global_phase: complex = 1.0):
        self.n = n_qubits
        self.segments = lower_program(ops, n_qubits)
        self.global_phase = complex(global_phase)

    @staticmethod
    def _phased(psi, phase):
        if phase == 1.0:
            return psi
        return psi * phase

    def apply(self, psi, thetas, impl=None):
        out = run_segments(self.segments, psi, thetas, self.n, impl=impl)
        return self._phased(out, self.global_phase)

    def apply_inverse(self, psi, thetas, impl=None):
        out = run_segments(self.segments, psi, thetas, self.n, direction=-1, impl=impl)
        return self._phased(out, np.conj(self.global_phase))
