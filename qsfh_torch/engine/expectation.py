"""Pauli-sum expectation values, operator application, and pool screening.

Counterpart of the flat-term ("scan") paths of
``qsfh_tpu/engine/expectation.py``: ``Observable._scan_terms`` /
``expectation_scan`` / ``apply_scan`` and ``PackedPool.scan_arrays`` /
``screen_scan``.  Coefficients carry the (-1)^popcount(z & x) reorder sign,
so every term acts as X^x Z^z applied left to right:
(c X^x Z^z psi)[b] = c (-1)^popcount(z & x) (-1)^popcount(b & z) psi[b ^ x].

ADAPT pool screening uses dE/de_k = 2 Im <w | G_k psi> with
w = U^dag H U psi, evaluated term by term and summed per generator by
``state.IndexFold`` (the same bits on every call).

From ``kernels.INNER_TILE_MIN_BITS`` (9) qubits on, at every size,
expectation values take ``expectation_grouped`` and screening
``screen_grouped`` over ``inner_groups()``: the terms in items covered by
tiles of chosen bits (``streaming.GroupTiles``, built once, cached beside
the term tensors), the x = 0 terms as one Walsh-Hadamard diagonal, the
coefficients folded into the kernel's partial-sum pass, where the JAX
package's chain kernels pass the state once per term and its stream
kernels once per flip mask (``qsfh_tpu/engine/expectation.py:233-274,
450-476``); they return E and the per-term contributions themselves, as
``expectation_chain_pallas`` and ``screen_chain_pallas`` do.  Below 9
qubits the per-term ``pauli_inner``, folded in torch.
``apply_scan`` takes ``pauli_apply_grouped`` over ``groups()``, the same
tiles with the x = 0 items of a tile as its diagonal, from 9 qubits on,
where the JAX package's chain and stream kernels (``apply_chain_pallas``,
``apply_stream_*``) apply H: one state pass per tile, each item of terms
one table entry per amplitude; below it the per-term ``pauli_apply``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..ops.pauli import PauliSum
from . import streaming
from .kernels import INNER_TILE_MIN_BITS, KERNELS
from .state import IndexFold, index_bits, parity_signs, qmask_to_bmask, real_dtype


def _apply(impl, owner, psi, xs, zs, c):
    """sum_t c_t P_t psi over ``owner``'s flat terms: over the tiles of
    ``owner.groups()`` from the smallest tile the kernel takes, per term
    below it."""
    if owner.n < INNER_TILE_MIN_BITS:
        return impl.apply(psi, xs, zs, c.real, c.imag)
    return impl.apply_grouped(psi, xs, zs, c.real, c.imag, owner.groups())


def _groups(cache: dict, arrays, n: int, inner: bool = False) -> streaming.GroupTiles:
    """The layout of the application (with its per-tile diagonals) or, with
    ``inner``, of the inner products (the x = 0 terms as one diagonal),
    built once into ``cache``."""
    key = "inner_groups" if inner else "groups"
    if key not in cache:
        cache[key] = streaming.GroupTiles(
            arrays[0], arrays[1], n, streaming.INNER_TILE_BITS, streaming.INNER_TILE_LOW_BITS,
            streaming.MAX_TILE_ITEMS, diagonal=not inner, inner_diagonal=inner)
    return cache[key]


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


def group_by_x(op: PauliSum) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """x mask -> (z masks, packed coefficients), qubit-indexed, in order
    of first appearance."""
    groups: Dict[int, Tuple[list, list]] = defaultdict(lambda: ([], []))
    for x, z, c in zip(op.x, op.z, op.c):
        g = groups[int(x)]
        g[0].append(int(z))
        g[1].append(complex(c))
    return {x: (np.array(zs, dtype=np.uint64), np.array(cs, dtype=np.complex128))
            for x, (zs, cs) in groups.items()}


def _group_weight(n: int, zs, cs, dtype, device) -> torch.Tensor:
    """w[b] = sum_j cs[j] (-1)^popcount(b & zb_j), zs qubit-indexed."""
    idx = index_bits(n, device)
    w = torch.zeros(1 << n, dtype=dtype, device=device)
    for z, c in zip(zs, cs):
        zb = qmask_to_bmask(int(z), n)
        if zb:
            w = w + complex(c) * parity_signs(idx, zb, real_dtype(dtype)).to(dtype)
        else:
            w = w + complex(c)
    return w


def _reordered(x: int, zs, cs) -> np.ndarray:
    """cs with the (-1)^popcount(z & x) sign of moving Z^z past X^x."""
    return cs * np.array([(-1.0) ** bin(int(z) & x).count("1") for z in zs])


def diagonal_weight_vector(op: PauliSum, n: int, dtype=torch.float64,
                           device="cpu") -> torch.Tensor:
    """D[b] with (op_diag psi)[b] = D[b] psi[b] for the x = 0 part of a
    Hermitian op (real), accumulated in complex128."""
    groups = group_by_x(op)
    if 0 not in groups:
        return torch.zeros(1 << n, dtype=dtype, device=device)
    w = _group_weight(n, *groups[0], torch.complex128, device)
    return w.real.to(dtype)


def apply_paulisum(psi: torch.Tensor, n: int, op: PauliSum, groups=None) -> torch.Tensor:
    """op|psi>, one flip per distinct x mask."""
    groups = group_by_x(op) if groups is None else groups
    out = torch.zeros_like(psi)
    for x, (zs, cs) in groups.items():
        # (c X^x Z^z psi)[b] = c (-1)^{|z&x|} (-1)^{z.b} psi[b^x]
        w = _group_weight(n, zs, _reordered(x, zs, cs), psi.dtype, psi.device)
        out = out + w * (psi if x == 0 else psi[index_bits(n, psi.device) ^ qmask_to_bmask(x, n)])
    return out


def expectation(psi: torch.Tensor, n: int, op: PauliSum, groups=None) -> torch.Tensor:
    """Re <psi|op|psi> (op Hermitian)."""
    groups = group_by_x(op) if groups is None else groups
    total = torch.zeros((), dtype=real_dtype(psi.dtype), device=psi.device)
    conj = psi.conj()
    for x, (zs, cs) in groups.items():
        w = _group_weight(n, zs, _reordered(x, zs, cs), psi.dtype, psi.device)
        flipped = psi if x == 0 else psi[index_bits(n, psi.device) ^ qmask_to_bmask(x, n)]
        total = total + (w * conj * flipped).sum().real
    return total


class _ExpectationValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, psi, obs):
        ctx.obs = obs
        ctx.save_for_backward(psi)
        return obs.expectation(psi)

    @staticmethod
    def backward(ctx, cbar):
        (psi,) = ctx.saved_tensors
        # torch's gradient of a real loss by a complex state is 2 dL/dpsi*
        return 2.0 * cbar * ctx.obs.apply(psi), None


def expectation_value(obs: "Observable", psi: torch.Tensor) -> torch.Tensor:
    """Re <psi|H|psi> whose backward is the analytic cotangent 2 c_bar H psi:
    autograd keeps psi alone, not one intermediate per flip mask."""
    return _ExpectationValue.apply(psi, obs)


class _KernelExpectation(torch.autograd.Function):
    """E = Re <psi|H|psi> on the kernel route: forward ``expectation_scan``,
    backward the cotangent 2 c_bar H psi from ``apply_scan``."""

    @staticmethod
    def forward(ctx, psi, obs, impl):
        ctx.obs, ctx.impl = obs, impl
        ctx.save_for_backward(psi)
        return obs.expectation_scan(psi, impl=impl)

    @staticmethod
    def backward(ctx, cbar):
        (psi,) = ctx.saved_tensors
        return 2.0 * cbar * ctx.obs.apply_scan(psi, impl=ctx.impl), None, None


class Observable:
    """A Pauli sum prepared for repeated evaluation on statevectors."""

    def __init__(self, op: PauliSum, n_qubits: int):
        self.op = op
        self.n = n_qubits
        self._tensor_cache = {}

    @property
    def x_groups(self):
        """The op's terms by flip mask (:func:`group_by_x`), built once."""
        if "x_groups" not in self._tensor_cache:
            self._tensor_cache["x_groups"] = group_by_x(self.op)
        return self._tensor_cache["x_groups"]

    def expectation(self, psi: torch.Tensor) -> torch.Tensor:
        """Re <psi|op|psi>, the plain unrolled form (differentiable)."""
        return expectation(psi, self.n, self.op, self.x_groups)

    def apply(self, psi: torch.Tensor) -> torch.Tensor:
        """op|psi>, the plain unrolled form (differentiable)."""
        return apply_paulisum(psi, self.n, self.op, self.x_groups)

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

    def groups(self) -> streaming.GroupTiles:
        """The scan terms in items covered by tiles, as the application
        takes them (built once)."""
        return _groups(self._tensor_cache, self._scan_terms(), self.n)

    def inner_groups(self) -> streaming.GroupTiles:
        """The scan terms as the inner products take them (built once)."""
        return _groups(self._tensor_cache, self._scan_terms(), self.n, inner=True)

    def expectation_scan(self, psi: torch.Tensor, impl=None) -> torch.Tensor:
        """Re <psi|op|psi> (a 0-d real tensor on psi's device)."""
        impl = impl or KERNELS
        xs, zs, c = self._tensors(psi)
        if self.n < INNER_TILE_MIN_BITS:
            return (c * impl.inner(psi, psi, xs, zs).to(psi.dtype)).real.sum()
        return impl.expectation_grouped(psi, xs, zs, c.real, c.imag, self.inner_groups())

    def apply_scan(self, psi: torch.Tensor, impl=None) -> torch.Tensor:
        """op|psi> (a new state)."""
        impl = impl or KERNELS
        return _apply(impl, self, psi, *self._tensors(psi))

    def expectation_auto(self, psi: torch.Tensor, impl=None) -> torch.Tensor:
        """Re <psi|op|psi>, differentiable, on the kernel route at every
        size (the JAX package's choice between its unrolled and scan forms
        by group count is an XLA compile-time one): :meth:`expectation_scan`
        forward, 2 c_bar :meth:`apply_scan` backward."""
        return _KernelExpectation.apply(psi, self, impl or KERNELS)

    def apply_auto(self, psi: torch.Tensor, impl=None) -> torch.Tensor:
        """op|psi> on the kernel route (:meth:`apply_scan`)."""
        return self.apply_scan(psi, impl)

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
        """(xb, zb, c) tensors on psi's device and the fold by generator."""
        arrays = self.scan_arrays()
        xs, zs, c = _device_terms(self._tensor_cache, arrays, psi)
        kkey = (str(psi.device), "ks")
        if kkey not in self._tensor_cache:
            self._tensor_cache[kkey] = IndexFold(arrays[4], self.size, psi.device)
        return xs, zs, c, self._tensor_cache[kkey]

    def inner_groups(self) -> streaming.GroupTiles:
        """The scan arrays' terms as the inner products take them (built
        once)."""
        return _groups(self._tensor_cache, self.scan_arrays(), self.n, inner=True)

    def screen(self, psi: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """grad_k = 2 Im <w | G_k psi> for every generator: the JAX package's
        unrolled screen, the same function as :meth:`screen_scan` and the
        same route (the ``screen_grouped`` kernel on the card)."""
        return self.screen_scan(psi, w)

    def screen_scan(self, psi: torch.Tensor, w: torch.Tensor, impl=None) -> torch.Tensor:
        """grad_k = 2 Im <w | G_k psi> for every generator ((size,) real)."""
        impl = impl or KERNELS
        xs, zs, c, fold = self._tensors(psi)
        if self.n < INNER_TILE_MIN_BITS:
            contribs = 2.0 * (c * impl.inner(w, psi, xs, zs).to(psi.dtype)).imag
        else:
            contribs = impl.screen_grouped(w, psi, xs, zs, c.real, c.imag, self.inner_groups())
        return fold(contribs)
