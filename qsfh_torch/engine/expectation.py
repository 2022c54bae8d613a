"""Pauli-sum expectation values, operator application, and pool screening.

Counterpart of the flat-term ("scan") paths of
``qsfh_tpu/engine/expectation.py``: ``Observable._scan_terms`` /
``expectation_scan`` / ``apply_scan`` and ``PackedPool.scan_arrays`` /
``screen_scan``.  Coefficients carry the (-1)^popcount(z & x) reorder sign,
so every term acts as X^x Z^z applied left to right:
(c X^x Z^z psi)[b] = c (-1)^popcount(z & x) (-1)^popcount(b & z) psi[b ^ x].

ADAPT pool screening uses dE/de_k = 2 Im <w | G_k psi> with
w = U^dag H U psi, evaluated term by term with the ``pauli_inner`` kernel
and summed per generator with ``index_add_``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..ops.pauli import PauliSum
from .kernels import KERNELS
from .state import qmask_to_bmask, real_dtype


def _device_terms(cache: dict, arrays, psi: torch.Tensor):
    """(xb, zb, c) tensors of flat term arrays for psi's device and dtype,
    cached in ``cache``."""
    key = (str(psi.device), psi.dtype)
    if key not in cache:
        xs, zs, cre, cim = arrays[:4]
        rdt = real_dtype(psi.dtype)
        cache[key] = (
            torch.as_tensor(xs.astype(np.int64), device=psi.device),
            torch.as_tensor(zs.astype(np.int64), device=psi.device),
            torch.complex(
                torch.as_tensor(cre, device=psi.device).to(rdt),
                torch.as_tensor(cim, device=psi.device).to(rdt),
            ),
        )
    return cache[key]


class Observable:
    """A Pauli sum prepared for repeated evaluation on statevectors."""

    def __init__(self, op: PauliSum, n_qubits: int):
        self.op = op
        self.n = n_qubits
        self._tensor_cache = {}

    def _scan_terms(self):
        """Flat per-term arrays (xb, zb, c_re, c_im) with the reorder sign."""
        if not hasattr(self, "_scan_cache"):
            n = self.n
            xs, zs, cre, cim = [], [], [], []
            for x, z, c in zip(self.op.x, self.op.z, self.op.c):
                x, z = int(x), int(z)
                c_adj = complex(c) * ((-1.0) ** bin(z & x).count("1"))
                xs.append(qmask_to_bmask(x, n))
                zs.append(qmask_to_bmask(z, n))
                cre.append(c_adj.real)
                cim.append(c_adj.imag)
            self._scan_cache = (
                np.asarray(xs, np.uint32),
                np.asarray(zs, np.uint32),
                np.asarray(cre, np.float64),
                np.asarray(cim, np.float64),
            )
        return self._scan_cache

    def _tensors(self, psi):
        return _device_terms(self._tensor_cache, self._scan_terms(), psi)

    def expectation_scan(self, psi: torch.Tensor, impl=None) -> torch.Tensor:
        """Re <psi|op|psi> (a 0-d real tensor on psi's device)."""
        impl = impl or KERNELS
        xs, zs, c = self._tensors(psi)
        v = impl.inner(psi, psi, xs, zs).to(psi.dtype)
        return (c * v).real.sum()

    def apply_scan(self, psi: torch.Tensor, impl=None) -> torch.Tensor:
        """op|psi> (a new state)."""
        impl = impl or KERNELS
        xs, zs, c = self._tensors(psi)
        return impl.apply(psi, xs, zs, c.real, c.imag)

    def __len__(self):
        return len(self.op)


# -- ADAPT pool screening -----------------------------------------------------


class PackedPool:
    """A pool of Hermitian generators lowered for batched screening.

    For each generator G_k = sum_t c_t P_t, grad_k = 2 Im <w|G_k psi>.  All
    (k, t) pairs are flattened in flip-mask group order (the JAX package's
    order, so per-term arrays are identical).
    """

    def __init__(self, generators: Sequence[PauliSum], n_qubits: int):
        self.n = n_qubits
        self.generators = list(generators)
        self.size = len(self.generators)
        flat: Dict[int, Tuple[list, list, list]] = defaultdict(lambda: ([], [], []))
        for k, g in enumerate(self.generators):
            for x, z, c in zip(g.x, g.z, g.c):
                f = flat[int(x)]
                f[0].append(int(z))
                f[1].append(complex(c))
                f[2].append(k)
        self._groups = {
            x: (
                np.array(zs, dtype=np.uint64),
                np.array(cs, dtype=np.complex128),
                np.array(ks, dtype=np.int32),
            )
            for x, (zs, cs, ks) in flat.items()
        }
        self._tensor_cache = {}

    def scan_arrays(self):
        """Flat per-term arrays (xb, zb, c_re, c_im, gen_index), built once."""
        if not hasattr(self, "_scan_arrays"):
            n = self.n
            xs, zs, cre, cim, ks = [], [], [], [], []
            for x, (zarr, carr, karr) in self._groups.items():
                xb = qmask_to_bmask(x, n)
                for z, c, k in zip(zarr, carr, karr):
                    zb = qmask_to_bmask(int(z), n)
                    c_adj = complex(c) * ((-1.0) ** bin(int(z) & x).count("1"))
                    xs.append(xb)
                    zs.append(zb)
                    cre.append(c_adj.real)
                    cim.append(c_adj.imag)
                    ks.append(k)
            self._scan_arrays = (
                np.asarray(xs, np.uint32),
                np.asarray(zs, np.uint32),
                np.asarray(cre, np.float64),
                np.asarray(cim, np.float64),
                np.asarray(ks, np.int32),
            )
        return self._scan_arrays

    def _tensors(self, psi):
        """(xb, zb, c, gen_index) tensors on psi's device."""
        arrays = self.scan_arrays()
        xs, zs, c = _device_terms(self._tensor_cache, arrays, psi)
        kkey = (str(psi.device), "ks")
        if kkey not in self._tensor_cache:
            self._tensor_cache[kkey] = torch.as_tensor(arrays[4].astype(np.int64), device=psi.device)
        return xs, zs, c, self._tensor_cache[kkey]

    def screen_scan(self, psi: torch.Tensor, w: torch.Tensor, impl=None) -> torch.Tensor:
        """grad_k = 2 Im <w | G_k psi> for every generator ((size,) real)."""
        impl = impl or KERNELS
        xs, zs, c, ks = self._tensors(psi)
        v = impl.inner(w, psi, xs, zs).to(psi.dtype)
        contribs = 2.0 * (c * v).imag
        grads = torch.zeros(self.size, dtype=real_dtype(psi.dtype), device=psi.device)
        return grads.index_add_(0, ks, contribs)
