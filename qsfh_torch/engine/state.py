"""Statevector creation and index utilities.

The statevector is a flat ``(2**n,)`` complex tensor.  Qubit ``q`` occupies
bit ``(n - 1 - q)`` of the flat index (qubit 0 = most significant), the same
convention as ``qsfh_tpu.engine.state``.

Counterpart of ``qsfh_tpu/engine/state.py`` without its TPU workarounds
(``runtime_one``, ``const_complex``, the (2, 2^n) real boundary arrays):
tensors here are plain complex torch tensors on one device.
"""

from __future__ import annotations

import numpy as np
import torch


def bitpos(q: int, n: int) -> int:
    """Flat-index bit position of qubit q."""
    return n - 1 - q


def qmask_to_bmask(qmask: int, n: int) -> int:
    """Convert a qubit-indexed mask (bit q = qubit q) to a flat-index bitmask."""
    out = 0
    for q in range(n):
        if (qmask >> q) & 1:
            out |= 1 << (n - 1 - q)
    return out


_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (or defaulted to) and no
    CUDA device exists; there is no silent move to the CPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def real_dtype(cdtype: torch.dtype) -> torch.dtype:
    """Real dtype paired with a complex dtype."""
    try:
        return _REAL[cdtype]
    except KeyError:
        raise ValueError(f"expected a complex dtype, got {cdtype}") from None


class IndexFold:
    """``out[i] = sum of values[j] over idx[j] == i`` for ``i < size``, the
    same bits on every call.  On the card ``index_add_`` adds with atomics,
    so its order, and the last bits of a sum, change from call to call (and
    an optimizer that divides by |g|, as Adam does, turns that into
    trajectories that part).  Here each value goes to a slot of its own in
    a ``(size, width)`` buffer, ``width`` the largest count of one index, in
    ascending j, and the rows are summed; values with ``idx >= size`` are
    dropped (each to a trailing slot of its own)."""

    def __init__(self, idx, size: int, device="cpu"):
        idx = np.asarray(idx, dtype=np.int64).reshape(-1)
        if idx.size and idx.min() < 0:
            raise ValueError("IndexFold: negative index")
        keep = idx < size
        counts = np.bincount(idx[keep], minlength=size) if size else np.zeros(0, np.int64)
        self.size = int(size)
        self.width = max(int(counts.max()) if counts.size else 0, 1)
        order = np.argsort(idx, kind="stable")
        ordered = idx[order]
        rank = np.empty_like(idx)
        rank[order] = np.arange(idx.size) - np.searchsorted(ordered, ordered, side="left")
        dropped = np.cumsum(~keep) - 1
        slot = np.where(keep, idx * self.width + rank, self.size * self.width + dropped)
        self.n_slots = self.size * self.width + int((~keep).sum())
        self.slot = torch.as_tensor(slot, device=device)

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        buf = values.new_zeros(self.n_slots)
        buf[self.slot] = values
        return buf[: self.size * self.width].view(self.size, self.width).sum(1)


def zero_state(n_qubits: int, dtype=torch.complex128, device="cpu"):
    """|00...0> as a flat statevector."""
    psi = torch.zeros(1 << n_qubits, dtype=dtype, device=device)
    psi[0] = 1.0
    return psi


def basis_state(n_qubits: int, occupied_qubits, dtype=torch.complex128, device="cpu"):
    """Computational basis state with the given qubits set to |1>."""
    index = 0
    for q in occupied_qubits:
        index |= 1 << bitpos(q, n_qubits)
    psi = torch.zeros(1 << n_qubits, dtype=dtype, device=device)
    psi[index] = 1.0
    return psi


def as_state(vec, device, dtype) -> torch.Tensor:
    """A statevector given as a tensor or an array as a tensor of ``dtype``
    on ``device`` (a tensor already there is returned as it is; an array is
    copied, as it may be read-only)."""
    if not torch.is_tensor(vec):
        vec = torch.from_numpy(np.array(vec))
    return vec.to(device=device, dtype=dtype)


def index_bits(n_qubits: int, device="cpu") -> torch.Tensor:
    """int64 arange over the flat index space."""
    return torch.arange(1 << n_qubits, dtype=torch.int64, device=device)


def parity(v: torch.Tensor) -> torch.Tensor:
    """popcount(v) & 1 for non-negative int64 values below 2^32.

    torch has no popcount: XOR-fold the 32 low bits down to bit 0.
    """
    for shift in (16, 8, 4, 2, 1):
        v = v ^ (v >> shift)
    return v & 1


def parity_signs(idx: torch.Tensor, bmask, dtype) -> torch.Tensor:
    """(-1)^{popcount(b & bmask)} over the flat indices ``idx``."""
    return 1.0 - 2.0 * parity(idx & bmask).to(dtype)


def fidelity(psi: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """|<psi|phi>|^2."""
    return torch.abs(torch.vdot(psi, phi)) ** 2


def ground_fidelity(psi: torch.Tensor, states) -> torch.Tensor:
    """Fidelity to the exact ground truth ``states`` (a list): the projection
    onto the span of a degenerate manifold, |<phi|psi>|^2 for one state, 0
    (a 0-d tensor) for none."""
    if len(states) > 1:
        return subspace_fidelity(psi, states)
    if states:
        return fidelity(psi, states[0])
    return torch.zeros((), dtype=real_dtype(psi.dtype), device=psi.device)


def subspace_fidelity(psi: torch.Tensor, basis_states) -> torch.Tensor:
    """Projection fidelity onto the span of orthonormal states
    (the degenerate 3x3 ground manifold)."""
    total = torch.zeros((), dtype=real_dtype(psi.dtype), device=psi.device)
    for phi in basis_states:
        total = total + torch.abs(torch.vdot(phi, psi)) ** 2
    return total
